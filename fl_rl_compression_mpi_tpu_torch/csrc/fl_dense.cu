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
// - flrl_frame_offsets: one launch, a single-pass scan with decoupled
//   look-back (scan.cuh), so each offset is written once (a two-level scan
//   writes, reads back and writes again the 8-byte offsets); 16-byte loads
//   of widths, and stores staged through shared memory so that a warp
//   stores contiguous 16-byte vectors.
// - flrl_pack: a lane per 16 input bytes (one 16-byte load, neighbouring
//   lanes on neighbouring addresses), packed in registers; the warp's
//   payload is one contiguous span, staged in shared memory and stored as
//   16-byte vectors.
// - flrl_frame_widths, flrl_unpack: one warp a frame, 8-byte loads; unpack
//   stores a 32-bit word a lane.
#include <cuda_runtime.h>

#include "fl_dense.cuh"
#include "scan.cuh"

namespace flrl {
namespace {

__device__ __forceinline__ int64_t global_warp() {
  return (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
}

__device__ __forceinline__ int64_t warp_stride() {
  return int64_t(gridDim.x) * blockDim.x / kWarp;
}

// --------------------------------------------------------------------------
// Frame widths.  Replaces the width half of fl_dense_pallas._encode_kernel
// and _uniform_enc_kernel (the f32-exponent / MXU width tricks there exist
// because the TPU's VPU lacks a cheap clz).  Reads n bytes, writes n/L: a
// pure read stream, so each lane ORs 8-byte words and the warp reduces with
// one __reduce_or_sync.  bitlen(OR of bytes) == bitlen(max byte).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kFrameThreads)
frame_widths_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t L,
                    int64_t frames, int fb_expect, uint8_t* __restrict__ bits,
                    int* __restrict__ flag) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t f = global_warp(); f < frames; f += warp_stride()) {
    const int64_t count = frame_count(f, n, L);
    const uint8_t* src = data + f * L;
    uint64_t acc = 0;
    const int64_t words = count / 8;
    const uint64_t* src8 = reinterpret_cast<const uint64_t*>(src);
    for (int64_t i = lane; i < words; i += kWarp) acc |= __ldg(src8 + i);
    for (int64_t i = words * 8 + lane; i < count; i += kWarp) acc |= src[i];
    unsigned m = static_cast<unsigned>(acc | (acc >> 32));
    m |= m >> 16;
    m |= m >> 8;
    m = __reduce_or_sync(kFullMask, m & 0xffu);
    const int b = max(1, 32 - __clz(static_cast<int>(m)));
    if (lane == 0) {
      bits[f] = static_cast<uint8_t>(b);
      // Read before the atomic: a mixed stream would otherwise send one
      // atomic per frame to the same address.
      if (fb_expect != 0 && b != fb_expect &&
          *reinterpret_cast<volatile int*>(flag) == 0)
        atomicOr(flag, 1);
    }
  }
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

struct PackArgs {
  const uint8_t* data;
  uint32_t n, L;   // n ≤ 2^31, L ≤ 2^31
  uint64_t recip;  // UINT64_MAX / L + 1: p / L == umulhi(p, recip), p < 2^32
  const uint8_t* bits;
  const int64_t* offs;  // null in uniform mode
  int fb;
  uint8_t* values;
};

// A lane's U input bytes from byte p on (v0: the first 8, v1: the next 8);
// zeros past the stream's end.
template <int U>
__device__ __forceinline__ void load_group(const PackArgs& a, uint32_t p,
                                           uint64_t& v0, uint64_t& v1) {
  v0 = v1 = 0;
  const uint32_t n = a.n;
  if (p + U <= n) {
    if (U == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.data + p));
      v0 = q.x | uint64_t(q.y) << 32;
      v1 = q.z | uint64_t(q.w) << 32;
    } else {
      v0 = __ldg(reinterpret_cast<const uint64_t*>(a.data + p));
    }
  } else {
    for (int j = 0; j < U && p + j < n; ++j) {
      if (j < 8)
        v0 |= uint64_t(a.data[p + j]) << (8 * j);
      else
        v1 |= uint64_t(a.data[p + j]) << (8 * (j - 8));
    }
  }
}

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
  const uint32_t n = a.n, L = a.L;
  const bool active = p < n;
  int b = 0;
  uint32_t start = 0, end = 0;  // this lane's payload bytes [start, end)
  if (active) {
    const uint32_t f =
        static_cast<uint32_t>(__umul64hi(uint64_t(p), a.recip));
    b = a.offs != nullptr ? min(int(a.bits[f]), 8) : a.fb;
    const uint32_t base = a.offs != nullptr
                              ? static_cast<uint32_t>(a.offs[f])
                              : f * (L / 8 * a.fb);
    const uint32_t rest = n - f * L;
    const uint32_t nbytes =
        static_cast<uint32_t>(frame_bytes(b, rest < L ? rest : L));
    const uint32_t q = (p - f * L) / 8 * b;
    start = base + q;
    end = base + (q + U / 8 * b < nbytes ? q + U / 8 * b : nbytes);
  }
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
__global__ void __launch_bounds__(kPackThreads, kPackBlocksPerSm)
pack_kernel(const PackArgs a) {
  constexpr uint32_t kSpan = kWarp * U;
  __shared__ __align__(16) uint8_t stage[kPackWarps][kPackStage];
  const int lane = threadIdx.x % kWarp;
  uint8_t* st = stage[threadIdx.x / kWarp];
  const uint32_t spans = (a.n + kSpan - 1) / kSpan;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t sp = static_cast<uint32_t>(global_warp()); sp < spans;
       sp += 2 * stride) {
    const bool second = sp + stride < spans;
    const uint32_t p0 = sp * kSpan + lane * U;
    const uint32_t p1 = (sp + stride) * kSpan + lane * U;
    uint64_t x0, x1, y0, y1;
    load_group<U>(a, p0, x0, x1);
    if (second) load_group<U>(a, p1, y0, y1);
    pack_span<U>(a, p0, x0, x1, st);
    if (second) pack_span<U>(a, p1, y0, y1, st);
  }
}

// --------------------------------------------------------------------------
// Unpack.  Replaces fl_dense_pallas._decode_kernel (window DMA + expansion
// routing + group unpack) and _uniform_dec_kernel / _uniform_dec_kernel_mr.
// Reads the payload, writes n bytes.  Lane i decodes values 4i..4i+3 of each
// 128-value step: value k sits at bit k·b of the frame payload, so the four
// values lie in a 5-byte little-endian window starting at byte 4i·b/8.
// Reads stop at values_size; the four bytes are stored as one 32-bit word.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kFrameThreads)
unpack_kernel(const uint8_t* __restrict__ values, int64_t values_size,
              int64_t n, int64_t L, int64_t frames,
              const uint8_t* __restrict__ bits,
              const int64_t* __restrict__ offs, int fb,
              uint8_t* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t f = global_warp(); f < frames; f += warp_stride()) {
    const int64_t count = frame_count(f, n, L);
    const int b = offs != nullptr ? bits[f] : fb;
    const int64_t base = offs != nullptr ? offs[f] : f * (L * fb / 8);
    const uint64_t mask = (1u << b) - 1u;
    uint8_t* dst = out + f * L;
    for (int64_t i = 4 * lane; i < count; i += 4 * kWarp) {
      const int64_t bit = i * b;
      const int64_t p = base + bit / 8;
      const int sh = static_cast<int>(bit % 8);
      uint64_t w = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (p + j < values_size)
          w |= uint64_t(__ldg(values + p + j)) << (8 * j);
      uint32_t o = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o |= static_cast<uint32_t>((w >> (sh + k * b)) & mask) << (8 * k);
      if (i + 4 <= count) {
        *reinterpret_cast<uint32_t*>(dst + i) = o;
      } else {
        for (int k = 0; i + k < count; ++k)
          dst[i + k] = static_cast<uint8_t>(o >> (8 * k));
      }
    }
  }
}

int64_t frame_blocks(int64_t frames) {
  const int64_t blocks = (frames + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks < kMaxFrameBlocks ? blocks : kMaxFrameBlocks;
}

bool bad_geometry(int64_t n, int64_t L) {
  return n < 0 || L <= 0 || L % 8 != 0;
}

// The grid holds the blocks that the card runs at once (__launch_bounds__
// keeps kPackBlocksPerSm resident), fewer for a short stream.
template <int U>
cudaError_t launch_pack(const PackArgs& a, int device, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t spans = (int64_t(a.n) + kWarp * U - 1) / (kWarp * U);
  const int64_t blocks = (spans + kPackWarps - 1) / kPackWarps;
  const int64_t resident = int64_t(sms) * kPackBlocksPerSm;
  pack_kernel<U><<<static_cast<unsigned>(blocks < resident ? blocks
                                                           : resident),
                   kPackThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_frame_widths(const void* data, int64_t n,
                               int64_t frame_length, int fb_expect,
                               void* bits, void* flag, int device,
                               void* stream) {
  if (bad_geometry(n, frame_length) || fb_expect < 0 || fb_expect > 8)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  if (frames == 0) return cudaSuccess;
  frame_widths_kernel<<<static_cast<unsigned>(frame_blocks(frames)),
                        kFrameThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, frame_length, frames, fb_expect,
      static_cast<uint8_t*>(bits), static_cast<int*>(flag));
  return cudaGetLastError();
}

FLRL_API int flrl_frame_offsets(const void* bits, int64_t n,
                                int64_t frame_length, void* offs,
                                void* scratch, int device, void* stream) {
  if (bad_geometry(n, frame_length) ||
      reinterpret_cast<uintptr_t>(offs) % 16 != 0)
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
  const bool uniform = offs == nullptr;
  if (bad_geometry(n, frame_length) || n > kPackMaxBytes ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      (uniform ? (fb < 1 || fb > 8) : (fb != 0 || bits == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  // A frame at least as long as the stream is the whole stream: any L ≥ n
  // packs the same bytes, so take one that fits 32 bits.
  const int64_t L = frame_length < n ? frame_length : (n + 15) / 16 * 16;
  const PackArgs a{static_cast<const uint8_t*>(data),
                   static_cast<uint32_t>(n), static_cast<uint32_t>(L),
                   UINT64_MAX / static_cast<uint64_t>(L) + 1,
                   static_cast<const uint8_t*>(bits),
                   static_cast<const int64_t*>(offs), fb,
                   static_cast<uint8_t*>(values)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L % 16 == 0 ? launch_pack<16>(a, device, s)
                     : launch_pack<8>(a, device, s);
}

FLRL_API int flrl_unpack(const void* values, int64_t values_size, int64_t n,
                         int64_t frame_length, const void* bits,
                         const void* offs, int fb, void* out, int device,
                         void* stream) {
  const bool uniform = offs == nullptr;
  if (bad_geometry(n, frame_length) || values_size < 0 ||
      (uniform ? (fb < 1 || fb > 8) : (fb != 0 || bits == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  if (frames == 0) return cudaSuccess;
  unpack_kernel<<<static_cast<unsigned>(frame_blocks(frames)), kFrameThreads,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), values_size, n, frame_length,
      frames, static_cast<const uint8_t*>(bits),
      static_cast<const int64_t*>(offs), fb, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

FLRL_API const char* flrl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
