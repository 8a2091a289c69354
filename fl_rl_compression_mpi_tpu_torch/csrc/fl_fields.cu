// FL field-form kernels for Hopper (sm_90a).
//
// These replace the TPU's field-form Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/fl_pallas.py:
//
//   fl_encode_fields_pallas         -> flrl_fields_encode (base mode)
//   fl_encode_fields_packed_pallas  -> flrl_fields_encode (pack-2 mode)
//   fl_decode_fields_pallas         -> flrl_fields_decode (base mode)
//   fl_decode_fields_packed_pallas  -> flrl_fields_decode (pack-2 mode)
//
// The function is ported, not the TPU mechanism.  The Pallas kernels take a
// word's width from the f32 exponent, a frame's width as a segment max on the
// MXU and broadcast it back to the lanes with a second matmul, because the
// TPU's vector unit has no cheap clz and no cross-lane reduction over
// segments.  Here a frame's width is an OR of its bytes reduced across the
// lanes that hold its words (shuffles), and max(1, 32 - clz) of the result.
//
// Every launch is a pure stream, bound by bytes: encode reads 4 bytes a word
// and writes 4 (base) or 2 (pack-2) bytes a word plus one width byte a
// frame; decode the reverse.
//
// Both take the layout of the dense widths kernel (fl_dense.cu): a lane per
// U stream bytes (U = 16, or 8 where L % 16 == 8) with one vector load, on
// a grid of the blocks the card holds at once, loop bounds computed by the
// launcher.  A lane spreads (or unspreads) its words in registers and
// stores them as one vector.
//
// Encode:
// - Base mode, L dividing a warp span of 32·U bytes (L = 8, 16, ..., 512):
//   a warp takes kFieldsStep = 1 KiB a step (two spans at U = 16, four at
//   U = 8), all loaded before any is reduced.  A lane ORs each span's bytes
//   into one byte of a word (byte j: span j), the L/U lanes of a frame
//   combine the word with log2(L/U) xor shuffles, and each lane spreads its
//   words at its frame's width and stores them where they were read.  A
//   step's widths go through the warp's stage and out as 16-byte vectors
//   (store_widths).
// - Pack-2 mode (128 % (L/4) == 0): a warp step is one packed row of 128
//   u32, whose words take rows r and r + tile_r/2 of the input (the low and
//   the high 16 bits).  A lane loads the same 16-byte column group of both
//   rows and stores the 16 packed bytes as one vector, so a warp writes
//   whole 512-byte rows and no sector half.  Both rows' ORs ride in one word
//   through the shuffles; where a lane holds two frames of a row (L = 8)
//   each has its own byte.  The input row of a packed row is one
//   multiply-high a step.
// - Any other L (24, 40, 136, 1024, ...): a warp a frame with U-byte loads,
//   one __reduce_or_sync, then a second pass that spreads and stores.
//
// Decode: the widths are an input, so no lane waits on another.
// - Base mode, every L: U divides L, so a lane's U bytes lie in one frame.
//   A warp takes kFieldsStep = 1 KiB a step, a lane two 16-byte groups (or
//   four 8-byte ones), each group's fields and its frame's width byte
//   loaded before any is used (the L/U lanes of a frame load the same byte,
//   one transaction).  The frame p / L is a shift where L is a power of
//   two, else one multiply-high.
// - Pack-2 mode: a warp step is kDecodeRows packed rows.  A lane loads one
//   16-byte column group of a packed row, whose low halves are four fields
//   of output row r and whose high halves are those of row r + tile_r/2,
//   loads the widths of its group in both rows (two a row at L = 8), and
//   stores 16 bytes to each row: every packed sector is read once, whole.
//   Stores are masked at nw: rows past it get none, and at L = 8 a lane
//   whose group nw cuts in half stores 8 bytes.
#include <cuda_runtime.h>

#include "fl_fields.cuh"
#include "lane_io.cuh"

namespace flrl {
namespace {

// e0 | e1<<b | e2<<2b | e3<<3b: exact in 32 bits (3b + 8 ≤ 32); b = 8 is
// the identity.
__device__ __forceinline__ uint32_t spread(uint32_t x, int b) {
  return (x & 0xffu) | (((x >> 8) & 0xffu) << b) |
         (((x >> 16) & 0xffu) << (2 * b)) | ((x >> 24) << (3 * b));
}

__device__ __forceinline__ uint32_t unspread(uint32_t f, int b) {
  const uint32_t m = (1u << b) - 1u;
  return (f & m) | (((f >> b) & m) << 8) | (((f >> (2 * b)) & m) << 16) |
         (((f >> (3 * b)) & m) << 24);
}

// The OR of a lane's U bytes.
__device__ __forceinline__ unsigned or_group(const uint4& q) {
  return or_bytes(q.x | q.y | q.z | q.w);
}

// A lane's U bytes, spread at width b, to dst.
template <int U>
__device__ __forceinline__ void store_fields(uint8_t* dst, const uint4& q,
                                             int b) {
  store_vec<U>(dst, make_uint4(spread(q.x, b), spread(q.y, b),
                               spread(q.z, b), spread(q.w, b)));
}

struct EncodeArgs {
  const uint8_t* words;  // the stream, 16-byte aligned
  uint32_t n;            // its bytes: 4·nw ≤ 2^31, whole frames
  uint32_t L;            // frame length in bytes
  uint32_t frames;
  uint32_t steps;        // warp steps (span and pack-2 paths)
  int k;                 // log2 of a frame's lanes (span and pack-2 paths)
  uint32_t half;         // pack-2: tile_r / 2
  uint64_t recip;        // pack-2: reciprocal(half)
  uint8_t* bits;
  uint8_t* out;
};

// --------------------------------------------------------------------------
// Base mode, L divides the span.  Replaces _encode_kernel
// (fl_pallas.py:121).
// --------------------------------------------------------------------------
template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
encode_spans_kernel(const EncodeArgs a) {
  constexpr int kSpans = kFieldsStep / (kWarp * U);
  static_assert(kSpans <= 4, "a lane's span ORs fit one word");
  constexpr uint32_t kSpan = kWarp * U;
  constexpr uint32_t kStep = kFieldsStep;
  __shared__ __align__(16) uint8_t stage[kDenseWarps][kFieldsStage];
  const int lane = threadIdx.x % kWarp;
  uint8_t* st = stage[threadIdx.x / kWarp];
  const int k = a.k;
  const uint32_t per_span = kWarp >> k;  // frames a span
  const uint32_t whole = kSpans * per_span;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t s = static_cast<uint32_t>(global_warp()); s < a.steps;
       s += stride) {
    // n is a multiple of L, so a frame's lanes are all in or all past it
    const uint32_t p = s * kStep + lane * U;
    uint4 q[kSpans];
#pragma unroll
    for (int j = 0; j < kSpans; ++j)
      q[j] = p + j * kSpan < a.n ? load_vec<U>(a.words + p + j * kSpan)
                                 : make_uint4(0, 0, 0, 0);
    unsigned m = 0;  // byte j: the OR of the lane's bytes of span j
#pragma unroll
    for (int j = 0; j < kSpans; ++j) m |= or_group(q[j]) << (8 * j);
    for (int i = 0; i < k; ++i) m |= __shfl_xor_sync(kFullMask, m, 1 << i);
#pragma unroll
    for (int j = 0; j < kSpans; ++j)
      if (p + j * kSpan < a.n)
        store_fields<U>(a.out + p + j * kSpan, q[j],
                        width_of((m >> (8 * j)) & 0xffu));
    const uint32_t f0 = s * whole;
    if ((lane & ((1 << k) - 1)) == 0) {  // the first of its frame's lanes
#pragma unroll
      for (int j = 0; j < kSpans; ++j) {
        const uint32_t g = j * per_span + (lane >> k);
        if (f0 + g < a.frames)
          st[g] = static_cast<uint8_t>(width_of((m >> (8 * j)) & 0xffu));
      }
    }
    __syncwarp();
    const uint32_t left = a.frames - f0;
    store_widths(a.bits + f0, st, left < whole ? left : whole, whole, lane);
    __syncwarp();
  }
}

// --------------------------------------------------------------------------
// Pack-2 mode.  Replaces _encode_packed_kernel (fl_pallas.py:309).  G: the
// frames a lane holds in a row (2 at L = 8, else 1; a frame then spans
// 2^k lanes).  m's byte h·G + i: the OR of frame i of row half h.
// --------------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
encode_pack2_kernel(const EncodeArgs a) {
  constexpr uint32_t kRow = kPackLanes * 4;  // bytes of a row
  __shared__ __align__(16) uint8_t stage[kDenseWarps][kFieldsStage];
  const int lane = threadIdx.x % kWarp;
  uint8_t* st = stage[threadIdx.x / kWarp];
  const int k = a.k;
  const uint32_t per_row = kRow / a.L;  // frames a row
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t P = static_cast<uint32_t>(global_warp()); P < a.steps;
       P += stride) {
    // packed row P of tile P / half holds input rows lo and lo + half
    const uint32_t tile = div_by(P, a.recip);
    const uint32_t lo = P + tile * a.half;
    const uint8_t* src = a.words + lo * kRow + lane * 16;
    const uint4 x = load_vec<16>(src);
    const uint4 y = load_vec<16>(src + a.half * kRow);
    unsigned m;
    if (G == 2)
      m = or_bytes(x.x | x.y) | or_bytes(x.z | x.w) << 8 |
          or_bytes(y.x | y.y) << 16 | or_bytes(y.z | y.w) << 24;
    else
      m = or_group(x) | or_group(y) << 8;
    for (int i = 0; i < k; ++i) m |= __shfl_xor_sync(kFullMask, m, 1 << i);
    // width of frame i of row half h, per word c of the lane's four
    const int x0 = width_of(m & 0xffu), y0 = width_of((m >> (8 * G)) & 0xffu);
    const int x1 = G == 2 ? width_of((m >> 8) & 0xffu) : x0;
    const int y1 = G == 2 ? width_of(m >> 24) : y0;
    *reinterpret_cast<uint4*>(a.out + P * kRow + lane * 16) = make_uint4(
        (spread(x.x, x0) & 0xffffu) | spread(y.x, y0) << 16,
        (spread(x.y, x0) & 0xffffu) | spread(y.y, y0) << 16,
        (spread(x.z, x1) & 0xffffu) | spread(y.z, y1) << 16,
        (spread(x.w, x1) & 0xffffu) | spread(y.w, y1) << 16);
    if (G == 2) {
      st[2 * lane] = static_cast<uint8_t>(x0);
      st[2 * lane + 1] = static_cast<uint8_t>(x1);
      st[per_row + 2 * lane] = static_cast<uint8_t>(y0);
      st[per_row + 2 * lane + 1] = static_cast<uint8_t>(y1);
    } else if ((lane & ((1 << k) - 1)) == 0) {
      st[lane >> k] = static_cast<uint8_t>(x0);
      st[per_row + (lane >> k)] = static_cast<uint8_t>(y0);
    }
    __syncwarp();
    store_widths(a.bits + lo * per_row, st, per_row, per_row, lane);
    store_widths(a.bits + (lo + a.half) * per_row, st + per_row, per_row,
                 per_row, lane);
    __syncwarp();
  }
}

// --------------------------------------------------------------------------
// Base mode, any other L (24, 40, 136, 1024, ...): a warp a frame.
// --------------------------------------------------------------------------
template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
encode_frames_kernel(const EncodeArgs a) {
  const int lane = threadIdx.x % kWarp;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t f = static_cast<uint32_t>(global_warp()); f < a.frames;
       f += stride) {
    const uint32_t p0 = f * a.L;
    const uint32_t end = p0 + a.L;
    unsigned o = 0;
    for (uint32_t p = p0 + lane * U; p < end; p += kWarp * U)
      o |= or_group(load_vec<U>(a.words + p));
    const int b = width_of(__reduce_or_sync(kFullMask, o));
    if (lane == 0) a.bits[f] = static_cast<uint8_t>(b);
    for (uint32_t p = p0 + lane * U; p < end; p += kWarp * U)
      store_fields<U>(a.out + p, load_vec<U>(a.words + p), b);
  }
}

// --------------------------------------------------------------------------
// Decode.  Replaces _decode_kernel and _decode_packed_kernel
// (fl_pallas.py:152, :331).
// --------------------------------------------------------------------------

struct DecodeArgs {
  const uint8_t* in;    // fields (base) or pack-2 slots, 16-byte aligned
  const uint8_t* bits;  // a width a frame, each 1..8
  uint32_t nw;          // output words: 4·nw ≤ 2^31, whole frames
  uint32_t steps;       // warp steps
  int sh;               // base: log2 L, or -1; pack-2: log2 (L/4)
  uint64_t recip;       // base: reciprocal(L); pack-2: reciprocal(half)
  uint32_t half;        // pack-2: tile_r / 2
  uint8_t* out;         // 16-byte aligned
};

// The four fields of q at width b, unspread (the first U/4 count).
__device__ __forceinline__ uint4 unspread4(const uint4& q, int b) {
  return make_uint4(unspread(q.x, b), unspread(q.y, b), unspread(q.z, b),
                    unspread(q.w, b));
}

// Base mode, every L: a lane's U bytes lie in one frame, since U divides L.
template <int U>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
decode_lanes_kernel(const DecodeArgs a) {
  constexpr int kGroups = kFieldsStep / (kWarp * U);
  constexpr uint32_t kSpan = kWarp * U;
  const uint32_t n = 4 * a.nw;
  const int lane = threadIdx.x % kWarp;
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t s = static_cast<uint32_t>(global_warp()); s < a.steps;
       s += stride) {
    // n is a multiple of L, so a group is all in or all past it
    const uint32_t p = s * kFieldsStep + lane * U;
    uint4 q[kGroups];
    int b[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const uint32_t pj = p + j * kSpan;
      q[j] = make_uint4(0, 0, 0, 0);
      b[j] = 0;
      if (pj < n) {
        q[j] = load_vec<U>(a.in + pj);
        b[j] = __ldg(a.bits + (a.sh >= 0 ? pj >> a.sh : div_by(pj, a.recip)));
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      if (p + j * kSpan < n)
        store_vec<U>(a.out + p + j * kSpan, unspread4(q[j], b[j]));
  }
}

// Words w..w+3 of the fields f (one 16-bit half of a packed group) at frame
// widths b0 (words w, w+1) and b1 (w+2, w+3), unspread to out; left =
// nw - w > 0 words remain, 2 only where a lane holds two frames (G == 2).
template <int G>
__device__ __forceinline__ void store_half(uint32_t* out, uint32_t w,
                                           const uint4& f, int b0, int b1,
                                           uint32_t left) {
  const uint4 v = make_uint4(unspread(f.x, b0), unspread(f.y, b0),
                             unspread(f.z, b1), unspread(f.w, b1));
  if (G == 1 || left >= 4)
    store_vec<16>(reinterpret_cast<uint8_t*>(out + w), v);
  else
    store_vec<8>(reinterpret_cast<uint8_t*>(out + w), v);
}

// Pack-2 mode: R = kDecodeRows packed rows a warp step (half is a multiple
// of 8, so they lie in one tile).  G: the frames of a lane's four words of
// a row (2 at L = 8, else 1).  Word positions are 32-bit: the launcher
// takes at most 2^29 words and tiles of at most 2^29 words.
template <int G>
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
decode_pack2_kernel(const DecodeArgs a) {
  constexpr int R = kDecodeRows;
  constexpr uint32_t kRow = kPackLanes * 4;  // bytes of a row
  const int lane = threadIdx.x % kWarp;
  uint32_t* out = reinterpret_cast<uint32_t*>(a.out);
  const uint32_t apart = a.half * kPackLanes;  // words from row r to r + half
  const uint32_t stride = static_cast<uint32_t>(warp_stride());
  for (uint32_t s = static_cast<uint32_t>(global_warp()); s < a.steps;
       s += stride) {
    // packed row P of tile P / half holds output rows lo and lo + half
    const uint32_t P = s * R;
    const uint32_t lo = P + div_by(P, a.recip) * a.half;
    uint4 q[R];
    int x0[R], x1[R], y0[R], y1[R];  // widths in rows lo + r, lo + r + half
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // a lane's packed group is loaded where its low row's words are < nw
      const uint32_t w = (lo + r) * kPackLanes + 4 * lane;
      const uint32_t f = w >> a.sh;
      q[r] = make_uint4(0, 0, 0, 0);
      x0[r] = x1[r] = y0[r] = y1[r] = 0;
      if (w < a.nw) {
        q[r] = load_vec<16>(a.in + (P + r) * kRow + lane * 16);
        x0[r] = __ldg(a.bits + f);
        if (G == 2 && w + 2 < a.nw) x1[r] = __ldg(a.bits + f + 1);
        if (w + apart < a.nw) {
          const uint32_t fh = f + (apart >> a.sh);
          y0[r] = __ldg(a.bits + fh);
          if (G == 2 && w + apart + 2 < a.nw) y1[r] = __ldg(a.bits + fh + 1);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t w = (lo + r) * kPackLanes + 4 * lane;
      const uint4 x = q[r];
      if (w < a.nw)
        store_half<G>(out, w,
                      make_uint4(x.x & 0xffffu, x.y & 0xffffu, x.z & 0xffffu,
                                 x.w & 0xffffu),
                      x0[r], G == 2 ? x1[r] : x0[r], a.nw - w);
      if (w + apart < a.nw)
        store_half<G>(out, w + apart,
                      make_uint4(x.x >> 16, x.y >> 16, x.z >> 16, x.w >> 16),
                      y0[r], G == 2 ? y1[r] : y0[r], a.nw - w - apart);
    }
  }
}

bool bad_fields(int64_t nw, int64_t L, int tile_r) {
  if (nw < 0 || L <= 0 || L % 8 != 0 || L / 4 > (int64_t(1) << 30))
    return true;
  const int64_t wpf = L / 4;
  if (nw % wpf != 0) return true;
  return tile_r != 0 && (tile_r < 0 || tile_r % 16 != 0 || 128 % wpf != 0);
}

template <typename Kernel, typename Args>
cudaError_t launch_resident(Kernel kernel, const Args& a, int64_t warps,
                            int device, cudaStream_t stream) {
  unsigned blocks = 0;
  const cudaError_t err = resident_grid(
      (warps + kDenseWarps - 1) / kDenseWarps, device, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kDenseThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_fields_encode(const void* words, int64_t nw,
                                int64_t frame_length, int tile_r, void* bits,
                                void* out, int device, void* stream) {
  if (bad_fields(nw, frame_length, tile_r) || nw > kDenseMaxBytes / 4 ||
      (tile_r != 0 && nw % (int64_t(tile_r) * kPackLanes) != 0) ||
      misaligned(words) || misaligned(bits) || misaligned(out))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nw == 0) return cudaSuccess;
  const uint32_t n = static_cast<uint32_t>(4 * nw);
  const uint32_t L = static_cast<uint32_t>(frame_length);
  const uint32_t half = static_cast<uint32_t>(tile_r / 2);
  EncodeArgs a{static_cast<const uint8_t*>(words),
               n,
               L,
               n / L,
               0,
               0,
               half,
               half ? reciprocal(half) : 0,
               static_cast<uint8_t*>(bits),
               static_cast<uint8_t*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_r != 0) {
    // a packed row a step: its two input rows' 16-byte groups a lane
    a.steps = static_cast<uint32_t>(nw / (2 * kPackLanes));
    a.k = L >= 16 ? __builtin_ctz(L / 16) : 0;
    return L == 8 ? launch_resident(encode_pack2_kernel<2>, a, a.steps,
                                    device, s)
                  : launch_resident(encode_pack2_kernel<1>, a, a.steps,
                                    device, s);
  }
  const uint32_t U = L % 16 == 0 ? 16 : 8;
  if (kWarp * U % L == 0) {
    a.steps = (n + kFieldsStep - 1) / kFieldsStep;
    a.k = __builtin_ctz(L / U);
    return U == 16 ? launch_resident(encode_spans_kernel<16>, a, a.steps,
                                     device, s)
                   : launch_resident(encode_spans_kernel<8>, a, a.steps,
                                     device, s);
  }
  return U == 16 ? launch_resident(encode_frames_kernel<16>, a, a.frames,
                                   device, s)
                 : launch_resident(encode_frames_kernel<8>, a, a.frames,
                                   device, s);
}

FLRL_API int flrl_fields_decode(const void* in, const void* bits, int64_t nw,
                                int64_t frame_length, int tile_r, void* out,
                                int device, void* stream) {
  if (bad_fields(nw, frame_length, tile_r) || nw > kDenseMaxBytes / 4 ||
      int64_t(tile_r) * kPackLanes > kDenseMaxBytes / 4 || misaligned(in) ||
      misaligned(out))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nw == 0) return cudaSuccess;
  const uint32_t L = static_cast<uint32_t>(frame_length);
  DecodeArgs a{static_cast<const uint8_t*>(in),
               static_cast<const uint8_t*>(bits),
               static_cast<uint32_t>(nw),
               0,
               0,
               0,
               static_cast<uint32_t>(tile_r / 2),
               static_cast<uint8_t*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_r != 0) {
    // the packed rows whose low row holds a word < nw: whole tiles, then
    // at most half of the last one
    const int64_t rows = (nw + kPackLanes - 1) / kPackLanes;
    const int64_t last = (rows - 1) / tile_r;
    const int64_t tail = rows - last * tile_r;
    const int64_t half = a.half;
    const int64_t prows = last * half + (tail < half ? tail : half);
    a.steps = static_cast<uint32_t>((prows + kDecodeRows - 1) / kDecodeRows);
    a.sh = __builtin_ctz(L / 4);
    a.recip = reciprocal(a.half);
    return L == 8 ? launch_resident(decode_pack2_kernel<2>, a, a.steps,
                                    device, s)
                  : launch_resident(decode_pack2_kernel<1>, a, a.steps,
                                    device, s);
  }
  a.steps = static_cast<uint32_t>((4 * nw + kFieldsStep - 1) / kFieldsStep);
  a.sh = (L & (L - 1)) == 0 ? __builtin_ctz(L) : -1;
  a.recip = reciprocal(L);
  return L % 16 == 0 ? launch_resident(decode_lanes_kernel<16>, a, a.steps,
                                       device, s)
                     : launch_resident(decode_lanes_kernel<8>, a, a.steps,
                                       device, s);
}
