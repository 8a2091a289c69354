// Dense FL codec kernels for Hopper (sm_90a).
//
// These replace the TPU's dense-on-device Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/fl_dense_pallas.py:
//
//   fl_encode_dense_pallas (:732)          -> flrl_frame_widths
//                                             + flrl_frame_offsets
//                                             + flrl_pack (general mode)
//   fl_decode_dense_pallas (:1074)         -> flrl_frame_offsets + flrl_unpack
//   fl_encode_dense_uniform_pallas (:1312) -> flrl_frame_widths (fb_expect
//                                             flag) + flrl_pack (uniform mode)
//   fl_decode_dense_uniform_pallas (:1488) -> flrl_unpack (uniform mode)
//
// The function is ported, not the TPU mechanism.  The Pallas kernels route
// words through monotone lane networks because a TPU core has no cheap
// per-lane byte addressing.  Here a full frame of L bytes at width b packs to
// exactly L·b/8 bytes, so frames never share an output byte: no atomics on
// the payload, no routing.  Frame placement is an exclusive scan of the
// per-frame payload sizes; in uniform mode it is the closed form f·L·fb/8
// and the scan is skipped (the point of the TPU's single-width kernels).
//
// Every launch is bound by bytes: encode reads n bytes and writes about
// n·b̄/8 (b̄ the mean width), decode the reverse, the offsets scan reads F
// widths and writes 8·(F+1) bytes of offsets.  What each design does about
// it:
//
// - flrl_frame_widths: a lane per 16 input bytes, four 16-byte loads in
//   flight a lane on a grid the card holds at once; the lanes of a frame
//   combine their OR by xor shuffles, and a warp stores its widths as
//   16-byte vectors.
// - flrl_frame_offsets: one launch, a single-pass scan with decoupled
//   look-back (scan.cuh), so each offset is written once (a two-level scan
//   writes, reads back and writes again the 8-byte offsets); 16-byte loads
//   of widths, and stores staged through shared memory so that a warp
//   stores contiguous 16-byte vectors.
// - flrl_pack: a lane per 16 input bytes (one 16-byte load, neighbouring
//   lanes on neighbouring addresses), packed in registers; the warp's
//   payload is one contiguous span, staged in shared memory and stored as
//   16-byte vectors.
// - flrl_unpack: the pack read backwards: the warp's span of payload is
//   loaded into shared memory by 16-byte loads, and a lane unpacks 16
//   output bytes in registers and stores them as one 16-byte vector.
#include <cuda_runtime.h>

#include "fl_dense.cuh"
#include "lane_io.cuh"
#include "scan.cuh"

namespace flrl {
namespace {

// --------------------------------------------------------------------------
// Frame widths.  Replaces the width half of fl_dense_pallas._encode_kernel
// and _uniform_enc_kernel (the f32-exponent / MXU width tricks there exist
// because the TPU's VPU lacks a cheap clz).  Reads n bytes, writes n/L: a
// pure read stream.  bitlen(OR of bytes) == bitlen(max byte).
//
// Where L divides a warp span of 32·U bytes (L = 8, 16, 32, ..., 512), a
// warp takes kWidthsSpans consecutive spans a step and issues all their
// loads before it reduces any: 2 KiB a step at U = 16.  A lane ORs each
// span's U bytes into one byte of a word (byte j: span j), the L/U lanes of
// a frame combine their words with log2(L/U) xor shuffles, and the first
// lane of each frame writes its widths into the warp's stage.  A step's
// widths are contiguous (16 at L = 128), so the warp stores them as 16-byte
// vectors, or one word where a step has fewer than 16.  Any other L (24,
// 40, 1024, ...) takes a warp a frame with U-byte loads and one
// __reduce_or_sync.  A thread remembers a width that differs from
// fb_expect, and each block sends at most one atomicOr to the flag.
// Positions are 32-bit (the launcher takes at most 2^31 bytes).  The
// launcher computes the loop bounds into the launch parameters, which the
// kernel reads without holding them in registers beside the four loads.
// --------------------------------------------------------------------------

struct WidthsArgs {
  const uint8_t* data;
  uint32_t n, L;   // n ≤ 2^31, L ≤ 2^31
  uint32_t frames;
  uint32_t steps;  // warp steps (span path)
  int k;           // log2(L / U) (span path)
  int fb_expect;
  uint8_t* bits;
  int* flag;
};

// Every thread of the block passes here once; the block sets the flag with
// at most one atomic.
__device__ __forceinline__ void raise_flag(bool bad, int* flag) {
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// L divides the span.
template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
widths_spans_kernel(const WidthsArgs a) {
  static_assert(kWidthsSpans == 4, "a lane's span ORs fill one word");
  constexpr uint32_t kSpan = kWarp * U;
  constexpr uint32_t kStep = kWidthsSpans * kSpan;
  __shared__ __align__(16) uint8_t stage[kDenseWarps][kWidthsSpans * kWarp];
  const int lane = threadIdx.x % kWarp;
  uint8_t* st = stage[threadIdx.x / kWarp];
  const int k = a.k;
  const uint32_t per_span = kWarp >> k;  // frames a span
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  bool bad = false;
  for (uint32_t s = static_cast<uint32_t>(global_warp()); s < a.steps;
       s += stride) {
    const uint32_t p = s * kStep + lane * U;
    uint4 q[kWidthsSpans];
    if (s * kStep + kStep <= a.n) {
#pragma unroll
      for (int j = 0; j < kWidthsSpans; ++j)
        q[j] = load_vec<U>(a.data + p + j * kSpan);
    } else {
#pragma unroll
      for (int j = 0; j < kWidthsSpans; ++j) {
        uint64_t v0, v1;
        load_group<U>(a.data, a.n, p + j * kSpan, v0, v1);
        q[j] = make_uint4(static_cast<uint32_t>(v0),
                          static_cast<uint32_t>(v0 >> 32),
                          static_cast<uint32_t>(v1),
                          static_cast<uint32_t>(v1 >> 32));
      }
    }
    unsigned m = 0;  // byte j: the OR of the lane's bytes of span j
#pragma unroll
    for (int j = 0; j < kWidthsSpans; ++j)
      m |= or_bytes(q[j].x | q[j].y | q[j].z | q[j].w) << (8 * j);
    for (int i = 0; i < k; ++i) m |= __shfl_xor_sync(kFullMask, m, 1 << i);
    const uint32_t f0 = s * (kWidthsSpans * per_span);
    if ((lane & ((1 << k) - 1)) == 0) {  // the first of its frame's lanes
#pragma unroll
      for (int j = 0; j < kWidthsSpans; ++j) {
        const uint32_t g = j * per_span + (lane >> k);
        if (f0 + g < a.frames) {
          const int b = width_of((m >> (8 * j)) & 0xffu);
          st[g] = static_cast<uint8_t>(b);
          bad |= a.fb_expect != 0 && b != a.fb_expect;
        }
      }
    }
    __syncwarp();
    const uint32_t whole = kWidthsSpans * per_span;
    const uint32_t left = a.frames - f0;
    store_widths(a.bits + f0, st, left < whole ? left : whole, whole, lane);
    __syncwarp();
  }
  raise_flag(bad, a.flag);
}

// Any L: a warp a frame.
template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
widths_frames_kernel(const WidthsArgs a) {
  const int lane = threadIdx.x % kWarp;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  bool bad = false;
  for (uint32_t f = static_cast<uint32_t>(global_warp()); f < a.frames;
       f += stride) {
    const uint32_t p0 = f * a.L;
    const uint32_t end = a.n - p0 < a.L ? a.n : p0 + a.L;
    uint64_t acc = 0;
    for (uint32_t p = p0 + lane * U; p < end; p += kWarp * U) {
      uint64_t v0, v1;
      load_group<U>(a.data, end, p, v0, v1);
      acc |= v0 | v1;
    }
    const unsigned m = __reduce_or_sync(
        kFullMask, or_bytes(static_cast<uint32_t>(acc | (acc >> 32))));
    if (lane == 0) {
      const int b = width_of(m);
      a.bits[f] = static_cast<uint8_t>(b);
      bad |= a.fb_expect != 0 && b != a.fb_expect;
    }
  }
  raise_flag(bad, a.flag);
}

// --------------------------------------------------------------------------
// Exclusive scan of per-frame payload bytes.  Replaces the in-kernel
// placement of fl_dense_pallas._encode_kernel (the sequential-grid cursor
// and its per-tile word offsets `woffs`) and the host offset scan that feeds
// _decode_kernel.  The TPU grid runs in order and carries a cursor; Hopper
// blocks run in no order, so a block takes its tile of kOffsetsTile frames
// by ticket, scans it, and finds the tile's carry by decoupled look-back
// over its predecessors' status words (scan.cuh).  Reads F width bytes,
// writes 8·(F+1) offset bytes, each once.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kOffsetsThreads)
frame_offsets_kernel(const uint8_t* __restrict__ bits, int64_t n, int64_t L,
                     int64_t frames, int64_t* __restrict__ offs,
                     uint64_t* __restrict__ status,
                     unsigned* __restrict__ ticket) {
  // Half a warp's offsets at a time; rows padded to 18 so that 16-byte
  // accesses of a quarter warp fall in distinct banks.
  constexpr int kHalf = kWarp / 2;
  constexpr int kRow = kOffsetsItems + 2;
  __shared__ __align__(16)
      int64_t stage[kOffsetsThreads / kWarp][kHalf * kRow];
  __shared__ int64_t tile_prefix;
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t t = take_tile(ticket);
  const int64_t f0 = t * kOffsetsTile + int64_t(threadIdx.x) * kOffsetsItems;

  uint32_t wb[kOffsetsItems / 4];  // the thread's 16 widths, 4 a word
  if (f0 + kOffsetsItems <= frames &&
      (reinterpret_cast<uintptr_t>(bits + f0) & 15) == 0) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(bits + f0));
    wb[0] = q.x;
    wb[1] = q.y;
    wb[2] = q.z;
    wb[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kOffsetsItems / 4; ++i) wb[i] = 0;
    for (int i = 0; i < kOffsetsItems && f0 + i < frames; ++i)
      wb[i / 4] |= uint32_t(bits[f0 + i]) << (8 * (i % 4));
  }
  int64_t x[kOffsetsItems];
  int64_t sum = 0;
#pragma unroll
  for (int i = 0; i < kOffsetsItems; ++i) {
    const int64_t f = f0 + i;
    const int b = (wb[i / 4] >> (8 * (i % 4))) & 0xff;
    x[i] = f < frames - 1 ? b * (L / 8)
                          : (f == frames - 1 ? frame_bytes(b, n - f * L) : 0);
    sum += x[i];
  }
  int64_t total;
  int64_t pre = block_exclusive_scan<kOffsetsThreads>(sum, &total);
  if (w == 0) {
    int64_t carry = 0;
    if (t == 0) {
      if (lane == 0) publish_status(status, kStatusPrefix, total);
    } else {
      if (lane == 0) publish_status(status + t, kStatusAggregate, total);
      carry = look_back(status, t, lane);
      if (lane == 0) publish_status(status + t, kStatusPrefix, carry + total);
    }
    if (lane == 0) {
      tile_prefix = carry;
      if (t == (frames - 1) / kOffsetsTile) offs[frames] = carry + total;
    }
  }
  __syncthreads();
  pre += tile_prefix;
  int64_t o[kOffsetsItems];
#pragma unroll
  for (int i = 0; i < kOffsetsItems; ++i) {
    o[i] = pre;
    pre += x[i];
  }
  // Lanes h·16..h·16+15 stage their 256 offsets; the whole warp stores them
  // as 128 16-byte vectors, four a lane.
  int64_t* sw = stage[w];
  const int64_t wf0 = t * kOffsetsTile + int64_t(w) * kWarp * kOffsetsItems;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lane / kHalf == h) {
      int64_t* row = sw + (lane % kHalf) * kRow;
#pragma unroll
      for (int i = 0; i < kOffsetsItems; i += 2)
        *reinterpret_cast<longlong2*>(row + i) =
            make_longlong2(o[i], o[i + 1]);
    }
    __syncwarp();
    const int64_t hf0 = wf0 + int64_t(h) * kHalf * kOffsetsItems;
#pragma unroll
    for (int k = 0; k < kHalf * kOffsetsItems / 2 / kWarp; ++k) {
      const int e = 2 * (k * kWarp + lane);
      const int64_t f = hf0 + e;
      const longlong2 v = *reinterpret_cast<const longlong2*>(
          sw + (e / kOffsetsItems) * kRow + e % kOffsetsItems);
      if (f + 1 < frames)
        *reinterpret_cast<longlong2*>(offs + f) = v;
      else if (f < frames)
        offs[f] = v.x;
    }
    __syncwarp();
  }
}

// --------------------------------------------------------------------------
// Pack.  Replaces the spread + group-pack + routing emit of
// fl_dense_pallas._encode_kernel (general mode) and _uniform_enc_kernel /
// _uniform_enc_kernel_mr (uniform mode).  Reads n bytes, writes the payload.
//
// Eight values at width b are exactly b bytes, so the U input bytes of a
// lane (U = 16, or 8 where L % 16 != 0, so that a lane's bytes never
// straddle two frames) pack to U·b/8 bytes at byte (pos/8)·b of its
// frame's payload.  A warp takes a span of 32·U input bytes (four frames
// at L = 128): the lanes' outputs follow each other, so the span's payload
// is one contiguous run.  Each lane writes its bytes into a shared-memory
// copy of the run, shifted to the run's 16-byte phase in device memory,
// and the warp stores the run as 16-byte vectors behind a bytewise head
// and before a bytewise tail (at L = 128 a run starts and ends on a
// 16-byte boundary unless it holds the stream's last frame).  Values past
// the stream's end load as zero and the tail frame's output is clipped to
// frame_bytes(b, count).  In uniform mode every value is masked to fb
// bits, so a frame of another width writes junk but stays inside its slot;
// the caller reads the widths flag and discards the payload.  Positions are
// 32-bit (the launcher takes at most 2^31 bytes), and p / L is a
// multiply-high.
// --------------------------------------------------------------------------

// Eight bytes, each masked to b bits, packed LSB-first into 8·b bits.
__device__ __forceinline__ uint64_t pack8(uint64_t v, int b) {
  v &= ((uint64_t(1) << b) - 1) * 0x0101010101010101ull;
  v = (v & 0x00ff00ff00ff00ffull) | ((v & 0xff00ff00ff00ff00ull) >> (8 - b));
  v = (v & 0x0000ffff0000ffffull) |
      ((v & 0xffff0000ffff0000ull) >> (16 - 2 * b));
  return (v & 0xffffffffull) | ((v >> 32) << (4 * b));
}

// Inverse of pack8: 8·b bits LSB-first (nothing above them) into eight
// bytes of b bits, in three steps that halve the groups: 4·b-bit halves to
// 32-bit words, 2·b-bit quarters to 16-bit lanes, b-bit values to bytes.
__device__ __forceinline__ uint64_t unpack8(uint64_t w, int b) {
  const uint64_t m4 = (uint64_t(1) << (4 * b)) - 1;
  uint64_t v = (w & m4) | ((w >> (4 * b)) & m4) << 32;
  const uint64_t m2 = ((uint64_t(1) << (2 * b)) - 1) * 0x0000000100000001ull;
  v = (v & m2) | ((v >> (2 * b)) & m2) << 16;
  const uint64_t m1 = ((uint64_t(1) << b) - 1) * 0x0001000100010001ull;
  return (v & m1) | ((v >> b) & m1) << 8;
}

// Bytes [0, nb) of the little-endian 16 bytes (lo, hi) to dst, in the
// widest stores that dst's alignment allows.
__device__ __forceinline__ void store_bytes(uint8_t* dst, uint64_t lo,
                                            uint64_t hi, int nb) {
  for (int k = 0; k < nb;) {
    const uint64_t x = k == 0  ? lo
                       : k < 8 ? (lo >> (8 * k)) | (hi << (64 - 8 * k))
                               : hi >> (8 * (k - 8));
    const unsigned a = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(dst + k));
    const int left = nb - k;
    if ((a & 7) == 0 && left >= 8) {
      *reinterpret_cast<uint64_t*>(dst + k) = x;
      k += 8;
    } else if ((a & 3) == 0 && left >= 4) {
      *reinterpret_cast<uint32_t*>(dst + k) = static_cast<uint32_t>(x);
      k += 4;
    } else if ((a & 1) == 0 && left >= 2) {
      *reinterpret_cast<uint16_t*>(dst + k) = static_cast<uint16_t>(x);
      k += 2;
    } else {
      dst[k] = static_cast<uint8_t>(x);
      k += 1;
    }
  }
}

// Where each frame's payload lies, for the pack and the unpack.
struct Layout {
  uint32_t n, L;   // n ≤ 2^31, L ≤ 2^31
  uint64_t recip;  // reciprocal(L): p / L == div_by(p, recip), p < 2^32
  const uint8_t* bits;
  const int64_t* offs;  // null in uniform mode
  int fb;
};

// The width b and payload bytes [start, end) of the U values from stream
// byte p < n on: byte (pos/8)·b of the frame's payload, clipped to the
// frame's frame_bytes(b, count).
template <int U>
__device__ __forceinline__ void lane_payload(const Layout& g, uint32_t p,
                                             int& b, uint32_t& start,
                                             uint32_t& end) {
  const uint32_t L = g.L;
  const uint32_t f = div_by(p, g.recip);
  b = g.offs != nullptr ? min(int(g.bits[f]), 8) : g.fb;
  const uint32_t base = g.offs != nullptr ? static_cast<uint32_t>(g.offs[f])
                                          : f * (L / 8 * g.fb);
  const uint32_t rest = g.n - f * L;
  const uint32_t nbytes =
      static_cast<uint32_t>(frame_bytes(b, rest < L ? rest : L));
  const uint32_t q = (p - f * L) / 8 * b;
  start = base + q;
  end = base + (q + U / 8 * b < nbytes ? q + U / 8 * b : nbytes);
}

struct PackArgs {
  const uint8_t* data;
  Layout g;
  uint8_t* values;
};

// One warp span: the lanes' packed bytes through the warp's stage to the
// payload (see above).  A lane writes into the stage only inside the
// span's kSpan bytes, so offsets that are not the scan of the widths
// cannot write past the stage.
template <int U>
__device__ __forceinline__ void pack_span(const PackArgs& a, uint32_t p,
                                          uint64_t v0, uint64_t v1,
                                          uint8_t* st) {
  constexpr uint32_t kSpan = kWarp * U;
  const int lane = threadIdx.x % kWarp;
  const bool active = p < a.g.n;
  int b = 0;
  uint32_t start = 0, end = 0;  // this lane's payload bytes [start, end)
  if (active) lane_payload<U>(a.g, p, b, start, end);
  const uint64_t w0 = pack8(v0, b);
  const uint64_t w1 = U == 16 ? pack8(v1, b) : 0;
  // the lane's bytes in order: w0's b bytes, then w1's
  const uint64_t lo = b == 8 ? w0 : w0 | w1 << (8 * b);
  const uint64_t hi = b == 8 ? w1 : (b == 0 ? 0 : w1 >> (64 - 8 * b));
  const int nb = static_cast<int>(end - start);

  const int last = 31 - __clz(__ballot_sync(kFullMask, active));
  const uint32_t span_lo = __shfl_sync(kFullMask, start, 0);
  const uint32_t span_hi = __shfl_sync(kFullMask, end, last);
  const int phase = static_cast<int>(
      (reinterpret_cast<uintptr_t>(a.values) + span_lo) & 15);
  if (start - span_lo + nb <= kSpan)
    store_bytes(st + phase + (start - span_lo), lo, hi, nb);
  __syncwarp();
  const int run = static_cast<int>(min(span_hi - span_lo, kSpan));
  const int head = min(run, (16 - phase) & 15);
  const int body = (run - head) / 16;
  const int tail = run - head - 16 * body;
  uint8_t* dst = a.values + span_lo;
  if (lane < head) dst[lane] = st[phase + lane];
  if (lane < body)
    reinterpret_cast<uint4*>(dst + head)[lane] =
        reinterpret_cast<const uint4*>(st + phase + head)[lane];
  if (lane < tail)
    dst[head + 16 * body + lane] = st[phase + head + 16 * body + lane];
  __syncwarp();
}

// Two spans a step, both loaded before either is packed, so that a lane
// keeps two 16-byte loads in flight.
template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
pack_kernel(const PackArgs a) {
  constexpr uint32_t kSpan = kWarp * U;
  __shared__ __align__(16) uint8_t stage[kDenseWarps][kPackStage];
  const int lane = threadIdx.x % kWarp;
  uint8_t* st = stage[threadIdx.x / kWarp];
  const uint32_t spans = (a.g.n + kSpan - 1) / kSpan;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t sp = static_cast<uint32_t>(global_warp()); sp < spans;
       sp += 2 * stride) {
    const bool second = sp + stride < spans;
    const uint32_t p0 = sp * kSpan + lane * U;
    const uint32_t p1 = (sp + stride) * kSpan + lane * U;
    uint64_t x0, x1, y0, y1;
    load_group<U>(a.data, a.g.n, p0, x0, x1);
    if (second) load_group<U>(a.data, a.g.n, p1, y0, y1);
    pack_span<U>(a, p0, x0, x1, st);
    if (second) pack_span<U>(a, p1, y0, y1, st);
  }
}

// --------------------------------------------------------------------------
// Unpack.  Replaces fl_dense_pallas._decode_kernel (window DMA + expansion
// routing + group unpack) and _uniform_dec_kernel / _uniform_dec_kernel_mr.
// Reads the payload, writes n bytes.
//
// The pack's span layout, read backwards: a lane owns the U output bytes
// from p = span·32·U + lane·U on, whose payload is [start, end) by
// lane_payload, so the warp span's payload is the one contiguous run from
// lane 0's start to the last lane's end, at most 32·U bytes.  The warp
// copies that run into its stage, shifted to the run's 16-byte phase in
// device memory: aligned 16 bytes a lane by cp.async, which holds no
// register while the copy is in flight, behind a bytewise head and before
// a bytewise tail; no load reaches values_size.  Each lane then reads its
// U·b/8 ≤ 16 bytes from the stage as five aligned words and a funnel shift
// (bytes past the copied run read as zero), spreads each b bytes to eight
// with unpack8, and stores one 16-byte vector (8 bytes where U = 8),
// bytewise only past n.  A step takes two spans, each with its own stage,
// and issues both spans' copies before it unpacks either.
// --------------------------------------------------------------------------

// 16 bytes from device memory into shared memory, both 16-byte aligned,
// with no register in between; complete after wait_copies().
__device__ __forceinline__ void copy16_async(uint8_t* smem,
                                             const uint8_t* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct UnpackArgs {
  const uint8_t* values;
  uint32_t values_size;  // at most 2^32 - 1: no read reaches it
  Layout g;
  uint8_t* out;
};

// A lane's part of one unpack span: its width and payload bytes [start,
// end), and the warp's run [lo, lo + run).
struct UnpackSpan {
  int b;
  uint32_t start, end, lo, run;
};

// The run's 16-byte phase in device memory and its head (bytes before the
// first 16-byte boundary), body (16-byte vectors) and tail (bytes after).
struct RunParts {
  int phase, head, body, tail;
  __device__ __forceinline__ RunParts(const uint8_t* values, uint32_t lo,
                                      uint32_t run) {
    phase = static_cast<int>((reinterpret_cast<uintptr_t>(values) + lo) & 15);
    head = min(static_cast<int>(run), (16 - phase) & 15);
    body = (static_cast<int>(run) - head) / 16;
    tail = static_cast<int>(run) - head - 16 * body;
  }
};

template <int U>
__device__ __forceinline__ void unpack_locate(const UnpackArgs& a,
                                              uint32_t p, UnpackSpan& s) {
  constexpr uint32_t kSpan = kWarp * U;
  const bool active = p < a.g.n;
  s.b = 0;
  s.start = s.end = 0;
  if (active) lane_payload<U>(a.g, p, s.b, s.start, s.end);
  const int last = 31 - __clz(__ballot_sync(kFullMask, active));
  s.lo = __shfl_sync(kFullMask, s.start, 0);
  uint32_t hi = __shfl_sync(kFullMask, s.end, last);
  hi = hi < a.values_size ? hi : a.values_size;
  s.run = hi > s.lo ? min(hi - s.lo, kSpan) : 0;
}

// The run into the stage: its body by cp.async, its head and tail bytes
// through a register (there are none where the run starts and ends on a
// 16-byte boundary: at L = 128 a whole frame's payload is 16·b bytes).
__device__ __forceinline__ void unpack_load(const UnpackArgs& a,
                                            const UnpackSpan& s,
                                            uint8_t* st) {
  const int lane = threadIdx.x % kWarp;
  const RunParts r(a.values, s.lo, s.run);
  const uint8_t* src = a.values + s.lo;
  if (lane < r.body)
    copy16_async(st + r.phase + r.head + 16 * lane, src + r.head + 16 * lane);
  if (lane < r.head) st[r.phase + lane] = __ldg(src + lane);
  const int t = r.head + 16 * r.body + lane;
  if (lane < r.tail) st[r.phase + t] = __ldg(src + t);
}

template <int U>
__device__ __forceinline__ void unpack_store(const UnpackArgs& a,
                                             uint32_t p, const UnpackSpan& s,
                                             const uint8_t* st) {
  if (p >= a.g.n) return;
  // the lane's bytes that the run holds
  const uint32_t off = s.start - s.lo;
  const uint32_t want = s.end - s.start;
  const uint32_t have =
      off < s.run ? (want < s.run - off ? want : s.run - off) : 0;
  uint64_t lo = 0, hi = 0;
  if (have != 0) {
    const uint32_t o = RunParts(a.values, s.lo, s.run).phase + off;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(st + (o & ~3u));
    const unsigned sh = 8 * (o & 3);
    lo = __funnelshift_r(w[0], w[1], sh) |
         uint64_t(__funnelshift_r(w[1], w[2], sh)) << 32;
    if (U == 16)
      hi = __funnelshift_r(w[2], w[3], sh) |
           uint64_t(__funnelshift_r(w[3], w[4], sh)) << 32;
    if (have < 8) {
      lo &= (uint64_t(1) << (8 * have)) - 1;
      hi = 0;
    } else if (have < 16) {
      hi &= (uint64_t(1) << (8 * (have - 8))) - 1;
    }
  }
  const int b = s.b;
  const uint64_t mb = b == 8 ? ~uint64_t(0) : (uint64_t(1) << (8 * b)) - 1;
  const uint64_t o0 = unpack8(lo & mb, b);
  // the second eight values: the lane's bytes b..2b-1
  const uint64_t w1 =
      b == 8 ? hi : (b == 0 ? 0 : (lo >> (8 * b) | hi << (64 - 8 * b)) & mb);
  const uint64_t o1 = U == 16 ? unpack8(w1, b) : 0;
  uint8_t* dst = a.out + p;
  if (p + U <= a.g.n) {
    if (U == 16)
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          static_cast<uint32_t>(o0), static_cast<uint32_t>(o0 >> 32),
          static_cast<uint32_t>(o1), static_cast<uint32_t>(o1 >> 32));
    else
      *reinterpret_cast<uint64_t*>(dst) = o0;
  } else {
    for (uint32_t j = 0; j < a.g.n - p; ++j)
      dst[j] = static_cast<uint8_t>(j < 8 ? o0 >> (8 * j)
                                          : o1 >> (8 * (j - 8)));
  }
}

template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
unpack_kernel(const UnpackArgs a) {
  constexpr uint32_t kSpan = kWarp * U;
  __shared__ __align__(16) uint8_t stage[kDenseWarps][2][kUnpackStage];
  const int lane = threadIdx.x % kWarp;
  uint8_t* st0 = stage[threadIdx.x / kWarp][0];
  uint8_t* st1 = stage[threadIdx.x / kWarp][1];
  const uint32_t spans = (a.g.n + kSpan - 1) / kSpan;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t sp = static_cast<uint32_t>(global_warp()); sp < spans;
       sp += 2 * stride) {
    const bool second = sp + stride < spans;
    const uint32_t p0 = sp * kSpan + lane * U;
    const uint32_t p1 = (sp + stride) * kSpan + lane * U;
    UnpackSpan x, y;
    unpack_locate<U>(a, p0, x);
    if (second) unpack_locate<U>(a, p1, y);
    unpack_load(a, x, st0);
    if (second) unpack_load(a, y, st1);
    wait_copies();
    __syncwarp();
    unpack_store<U>(a, p0, x, st0);
    if (second) unpack_store<U>(a, p1, y, st1);
    __syncwarp();
  }
}

bool bad_geometry(int64_t n, int64_t L) {
  return n < 0 || L <= 0 || L % 8 != 0;
}

// A frame at least as long as the stream is the whole stream: any L ≥ n
// gives the same single frame, so take one that fits 32 bits.
int64_t launch_length(int64_t n, int64_t L) {
  return L < n ? L : (n + 15) / 16 * 16;
}

Layout make_layout(int64_t n, int64_t L, const void* bits, const void* offs,
                   int fb) {
  return Layout{static_cast<uint32_t>(n), static_cast<uint32_t>(L),
                reciprocal(static_cast<uint64_t>(L)),
                static_cast<const uint8_t*>(bits),
                static_cast<const int64_t*>(offs), fb};
}

template <int U>
cudaError_t launch_widths(WidthsArgs a, int device, cudaStream_t stream) {
  constexpr int64_t kStep = kWidthsSpans * kWarp * U;
  const bool spans = kWarp * U % a.L == 0;
  a.steps = static_cast<uint32_t>((a.n + kStep - 1) / kStep);
  a.k = spans ? __builtin_ctz(a.L / U) : 0;
  const int64_t warps = spans ? a.steps : a.frames;
  unsigned blocks = 0;
  const cudaError_t err = resident_grid(
      (warps + kDenseWarps - 1) / kDenseWarps, device, blocks);
  if (err != cudaSuccess) return err;
  if (spans)
    widths_spans_kernel<U><<<blocks, kDenseThreads, 0, stream>>>(a);
  else
    widths_frames_kernel<U><<<blocks, kDenseThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// One span per warp a step (two for the unpack), so a warp for each 32·U
// bytes at most.
template <int U, typename Args>
cudaError_t launch_spans(void (*kernel)(Args), const Args& a, uint32_t n,
                         int device, cudaStream_t stream) {
  const int64_t spans = (int64_t(n) + kWarp * U - 1) / (kWarp * U);
  unsigned blocks = 0;
  const cudaError_t err = resident_grid(
      (spans + kDenseWarps - 1) / kDenseWarps, device, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kDenseThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool bad_mode(const void* bits, const void* offs, int fb) {
  return offs == nullptr ? (fb < 1 || fb > 8) : (fb != 0 || bits == nullptr);
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_frame_widths(const void* data, int64_t n,
                               int64_t frame_length, int fb_expect,
                               void* bits, void* flag, int device,
                               void* stream) {
  if (bad_geometry(n, frame_length) || n > kDenseMaxBytes ||
      fb_expect < 0 || fb_expect > 8 || misaligned(data) || misaligned(bits))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t L = launch_length(n, frame_length);
  const WidthsArgs a{static_cast<const uint8_t*>(data),
                     static_cast<uint32_t>(n),
                     static_cast<uint32_t>(L),
                     static_cast<uint32_t>((n + L - 1) / L),
                     0,
                     0,
                     fb_expect,
                     static_cast<uint8_t*>(bits),
                     static_cast<int*>(flag)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L % 16 == 0 ? launch_widths<16>(a, device, s)
                     : launch_widths<8>(a, device, s);
}

FLRL_API int flrl_frame_offsets(const void* bits, int64_t n,
                                int64_t frame_length, void* offs,
                                void* scratch, int device, void* stream) {
  if (bad_geometry(n, frame_length) || misaligned(offs))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* o = static_cast<int64_t*>(offs);
  if (frames == 0) return cudaMemsetAsync(o, 0, sizeof(int64_t), s);
  const int64_t tiles = (frames + kOffsetsTile - 1) / kOffsetsTile;
  uint64_t* status = static_cast<uint64_t*>(scratch);
  // the status words and the ticket start at zero on this stream
  err = cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return err;
  frame_offsets_kernel<<<static_cast<unsigned>(tiles), kOffsetsThreads, 0,
                         s>>>(static_cast<const uint8_t*>(bits), n,
                              frame_length, frames, o, status,
                              reinterpret_cast<unsigned*>(status + tiles));
  return cudaGetLastError();
}

FLRL_API int flrl_pack(const void* data, int64_t n, int64_t frame_length,
                       const void* bits, const void* offs, int fb,
                       void* values, int device, void* stream) {
  if (bad_geometry(n, frame_length) || n > kDenseMaxBytes ||
      misaligned(data) || bad_mode(bits, offs, fb))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t L = launch_length(n, frame_length);
  const PackArgs a{static_cast<const uint8_t*>(data),
                   make_layout(n, L, bits, offs, fb),
                   static_cast<uint8_t*>(values)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L % 16 == 0
             ? launch_spans<16>(pack_kernel<16>, a, a.g.n, device, s)
             : launch_spans<8>(pack_kernel<8>, a, a.g.n, device, s);
}

FLRL_API int flrl_unpack(const void* values, int64_t values_size, int64_t n,
                         int64_t frame_length, const void* bits,
                         const void* offs, int fb, void* out, int device,
                         void* stream) {
  if (bad_geometry(n, frame_length) || n > kDenseMaxBytes ||
      values_size < 0 || misaligned(out) || bad_mode(bits, offs, fb))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t L = launch_length(n, frame_length);
  const UnpackArgs a{
      static_cast<const uint8_t*>(values),
      static_cast<uint32_t>(values_size < UINT32_MAX ? values_size
                                                     : UINT32_MAX),
      make_layout(n, L, bits, offs, fb), static_cast<uint8_t*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L % 16 == 0
             ? launch_spans<16>(unpack_kernel<16>, a, a.g.n, device, s)
             : launch_spans<8>(unpack_kernel<8>, a, a.g.n, device, s);
}

FLRL_API const char* flrl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
