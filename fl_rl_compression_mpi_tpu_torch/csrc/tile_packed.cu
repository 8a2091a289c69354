// The tile-packed field codec for Hopper (sm_90a).
//
// This replaces the TPU kernels of two archived layout studies:
//
//   experiments/exp21_tile_packed.py   enc_packed (:161, pallas_call :166),
//                                      dec_packed (:221, pallas_call :226)
//   experiments/exp22_tile_packed2.py  enc_packed (:156, pallas_call :161),
//                                      dec_packed (:246, pallas_call :251)
//
//   -> flrl_tile_packed_encode / flrl_tile_packed_decode, the cursor layout
//      (exp21: offs) or the sparse one (exp22: no offs)
//
// The Pallas kernels walk the tiles on a sequential grid: each step computes
// its tile's widths and fields in VMEM, halves them d times and DMAs the
// R>>d rows out behind a cursor carried in SMEM (exp21) or to row t·R
// (exp22), double-buffering the staging so that a tile's emit overlaps the
// next tile's compute.  Hopper's blocks run in no order and carry nothing,
// so each launcher splits the work where a tile's depth must be known:
//
// - encode: tile_or_kernel, a block a chunk of kChunkRows rows of a tile, a
//   warp a row (a 16-byte vector a lane, a frame's 8 lanes ORed by xor
//   shuffles), stores the widths and ORs the tile's bytes into key[t]; in
//   the cursor layout offsets_kernel, one block, scans the tiles' row counts
//   R >> d into offs (scan.cuh's block_exclusive_scan); pack_kernel, a block
//   a chunk of packed rows, a thread a 16-byte vector of one packed row,
//   reads the 2^d source vectors of its slots, spreads each word at its
//   frame's width and ORs them at their shifts;
// - decode: depth_kernel, a warp a chunk of rows, ORs (1 << b) - 1 over the
//   tile's widths into key[t] (its bit length is the tile's widest width);
//   unpack_kernel, laid out as pack_kernel, reads each packed vector once
//   and writes its 2^d output vectors, each its slot's bits
//   (z >> shift(k)) & (2^(32>>d) - 1) unspread at its frame's width.  That
//   is the mirrored ladder of masks {0xFFFF, 0xFF00FF, 0xF0F0F0F} of the
//   Pallas decode, for any packed word.
//
// The key is an OR, so blocks of one tile meet by atomicOr and need no
// order; the launcher clears it on the stream.  Widths of at most 8 bits in
// a frame of 32 words are an OR-reduce across the frame's lanes, as in
// flrl_fields_encode: no f32 exponent trick and no matrix unit, which the
// TPU kernels use for their segment max.
//
// Bound by memory.  Encode: the words read once by the widths and once
// more by the pack (the second read may hit L2), the widths and the
// tiles' packed rows written once.  Decode: the widths read twice (depth,
// unpack) at 1/128 of the words' bytes, the packed rows read once, the
// words written once.  A few integer operations a word.
#include <cuda_runtime.h>

#include "scan.cuh"
#include "tile_packed.cuh"

namespace flrl {
namespace {

constexpr int kPackThreads = 256;
constexpr int kChunkRows = 32;          // rows of a tile a block takes
constexpr int kRowVecs = kPackedLanes / 4;  // 16-byte vectors a row: 32
constexpr int kRowsPerStep = kPackThreads / kRowVecs;  // 8
constexpr int kOffsetsThreads = 1024;

static_assert(kRowVecs == kWarp, "a warp takes a row");

bool misaligned(const void* p, int align = 16) {
  return reinterpret_cast<uintptr_t>(p) % align != 0;
}

// A frame's width from the OR of its bytes: max(1, bitlen).
__device__ __forceinline__ int width_of_or(uint32_t o) {
  return max(1, 32 - __clz(o));
}

// Pack depth of a tile whose widest frame has width bt.
__device__ __forceinline__ int depth_of(int bt) {
  return bt <= 1 ? 3 : bt <= 2 ? 2 : bt <= 4 ? 1 : 0;
}

// Slot k of depth D: its source row offset in the tile and its shift.
template <int D>
__device__ __forceinline__ int slot_rows(int k, int R) {
  int off = 0;
#pragma unroll
  for (int s = 0; s < D; ++s)
    if ((k >> s) & 1) off += R >> (s + 1);
  return off;
}

template <int D>
__host__ __device__ constexpr int slot_shift(int k) {
  int sh = 0;
  for (int s = 0; s < D; ++s)
    if ((k >> s) & 1) sh += 16 >> s;
  return sh;
}

__device__ __forceinline__ uint32_t spread(uint32_t w, int b) {
  return (w & 0xffu) | ((w >> 8) & 0xffu) << b |
         ((w >> 16) & 0xffu) << (2 * b) | (w >> 24) << (3 * b);
}

__device__ __forceinline__ uint32_t unspread(uint32_t f, int b) {
  const uint32_t m = (1u << b) - 1u;
  return (f & m) | ((f >> b) & m) << 8 | ((f >> (2 * b)) & m) << 16 |
         ((f >> (3 * b)) & m) << 24;
}

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ---------------------------------------------------------------------------
// Encode
// ---------------------------------------------------------------------------

// Block (t, c): rows [c·kChunkRows, ...) of tile t, a warp a row.
__global__ void __launch_bounds__(kPackThreads)
tile_or_kernel(const uint32_t* __restrict__ words, int R, int chunks,
               uint32_t* __restrict__ bits, uint32_t* __restrict__ key) {
  const int64_t t = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * kChunkRows;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int rows = min(kChunkRows, R - r0);
  uint32_t acc = 0;
  uint4 q[kChunkRows / kRowsPerStep];
#pragma unroll
  for (int i = 0; i < kChunkRows / kRowsPerStep; ++i) {
    const int r = warp + i * kRowsPerStep;
    q[i] = r < rows ? load4(words + ((t * R + r0 + r) * kPackedLanes +
                                     lane * 4))
                    : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kChunkRows / kRowsPerStep; ++i) {
    const int r = warp + i * kRowsPerStep;
    uint32_t o = q[i].x | q[i].y | q[i].z | q[i].w;
    o |= o >> 16;
    o = (o | o >> 8) & 0xffu;
    // the frame's 8 lanes
    o |= __shfl_xor_sync(kFullMask, o, 1);
    o |= __shfl_xor_sync(kFullMask, o, 2);
    o |= __shfl_xor_sync(kFullMask, o, 4);
    acc |= o;
    // the row's four widths, one byte each, as one word from lane 0
    const uint32_t b = static_cast<uint32_t>(width_of_or(o));
    const uint32_t row = __shfl_sync(kFullMask, b, 0) |
                         __shfl_sync(kFullMask, b, 8) << 8 |
                         __shfl_sync(kFullMask, b, 16) << 16 |
                         __shfl_sync(kFullMask, b, 24) << 24;
    if (lane == 0 && r < rows) bits[t * R + r0 + r] = row;
  }
  acc = __reduce_or_sync(kFullMask, acc);
  if (lane == 0 && acc) atomicOr(key + t, acc);
}

// offs[t] = rows of the tiles before t, offs[tiles] = all of them.
__global__ void __launch_bounds__(kOffsetsThreads)
offsets_kernel(const uint32_t* __restrict__ key, int64_t tiles, int R,
               int32_t* __restrict__ offs) {
  int64_t carry = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += kOffsetsThreads) {
    const int64_t t = t0 + threadIdx.x;
    const int64_t rows =
        t < tiles ? R >> depth_of(width_of_or(key[t])) : 0;
    int64_t total;
    const int64_t ex = block_exclusive_scan<kOffsetsThreads>(rows, &total);
    if (t < tiles) offs[t] = static_cast<int32_t>(carry + ex);
    carry += total;
  }
  if (threadIdx.x == 0) offs[tiles] = static_cast<int32_t>(carry);
}

template <int D>
__device__ __forceinline__ void pack_rows(const uint32_t* __restrict__ words,
                                          const uint8_t* __restrict__ bits,
                                          int64_t t, int R, int p0, int prows,
                                          uint32_t* __restrict__ dst) {
  const int v = threadIdx.x % kRowVecs;
  const int f = v / (kRowVecs / kPackedFrames);
  for (int pr = p0 + threadIdx.x / kRowVecs; pr < prows;
       pr += kRowsPerStep) {
    uint4 q[1 << D];
    int b[1 << D];
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      const int64_t src = t * R + pr + slot_rows<D>(k, R);
      q[k] = load4(words + src * kPackedLanes + v * 4);
      b[k] = bits[src * kPackedFrames + f];
    }
    uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      const int sh = slot_shift<D>(k);
      acc.x |= spread(q[k].x, b[k]) << sh;
      acc.y |= spread(q[k].y, b[k]) << sh;
      acc.z |= spread(q[k].z, b[k]) << sh;
      acc.w |= spread(q[k].w, b[k]) << sh;
    }
    *reinterpret_cast<uint4*>(dst + int64_t(pr) * kPackedLanes + v * 4) = acc;
  }
}

// Block (t, c): packed rows [c·kChunkRows, ...) of tile t, where the tile
// has them.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint32_t* __restrict__ words,
            const uint8_t* __restrict__ bits, const uint32_t* __restrict__ key,
            const int32_t* __restrict__ offs, int R, int chunks,
            uint32_t* __restrict__ packed) {
  const int64_t t = blockIdx.x / chunks;
  const int p0 = (blockIdx.x % chunks) * kChunkRows;
  const int d = depth_of(width_of_or(key[t]));
  const int prows = R >> d;
  if (p0 >= prows) return;
  const int pend = min(prows, p0 + kChunkRows);
  uint32_t* dst =
      packed + (offs ? int64_t(offs[t]) : t * R) * kPackedLanes;
  switch (d) {
    case 0: pack_rows<0>(words, bits, t, R, p0, pend, dst); break;
    case 1: pack_rows<1>(words, bits, t, R, p0, pend, dst); break;
    case 2: pack_rows<2>(words, bits, t, R, p0, pend, dst); break;
    default: pack_rows<3>(words, bits, t, R, p0, pend, dst); break;
  }
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

// Block (t, c), one warp: rows [c·kChunkRows, ...) of tile t, a lane a row.
__global__ void __launch_bounds__(kWarp)
depth_kernel(const uint32_t* __restrict__ bits, int R, int chunks,
             uint32_t* __restrict__ key) {
  const int64_t t = blockIdx.x / chunks;
  const int r = (blockIdx.x % chunks) * kChunkRows + threadIdx.x;
  uint32_t m = 0;
  if (r < R) {
    const uint32_t w = bits[t * R + r];
#pragma unroll
    for (int f = 0; f < kPackedFrames; ++f)
      m |= (1u << min((w >> (8 * f)) & 0xffu, 8u)) - 1u;
  }
  m = __reduce_or_sync(kFullMask, m);
  if (threadIdx.x == 0 && m) atomicOr(key + t, m);
}

template <int D>
__device__ __forceinline__ void unpack_rows(const uint32_t* __restrict__ src,
                                            const uint8_t* __restrict__ bits,
                                            int64_t t, int R, int p0,
                                            int prows,
                                            uint32_t* __restrict__ out) {
  constexpr uint32_t kMask = 0xffffffffu >> (32 - (32 >> D));  // 32>>D bits
  const int v = threadIdx.x % kRowVecs;
  const int f = v / (kRowVecs / kPackedFrames);
  for (int pr = p0 + threadIdx.x / kRowVecs; pr < prows;
       pr += kRowsPerStep) {
    const uint4 z = load4(src + int64_t(pr) * kPackedLanes + v * 4);
    int b[1 << D];
#pragma unroll
    for (int k = 0; k < (1 << D); ++k)
      b[k] = bits[(t * R + pr + slot_rows<D>(k, R)) * kPackedFrames + f];
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      const int sh = slot_shift<D>(k);
      const int64_t j = t * R + pr + slot_rows<D>(k, R);
      *reinterpret_cast<uint4*>(out + j * kPackedLanes + v * 4) = make_uint4(
          unspread((z.x >> sh) & kMask, b[k]),
          unspread((z.y >> sh) & kMask, b[k]),
          unspread((z.z >> sh) & kMask, b[k]),
          unspread((z.w >> sh) & kMask, b[k]));
    }
  }
}

__global__ void __launch_bounds__(kPackThreads)
unpack_kernel(const uint8_t* __restrict__ bits,
              const uint32_t* __restrict__ packed,
              const uint32_t* __restrict__ key,
              const int32_t* __restrict__ offs, int R, int chunks,
              uint32_t* __restrict__ out) {
  const int64_t t = blockIdx.x / chunks;
  const int p0 = (blockIdx.x % chunks) * kChunkRows;
  const int d = depth_of(width_of_or(key[t]));
  const int prows = R >> d;
  if (p0 >= prows) return;
  const int pend = min(prows, p0 + kChunkRows);
  const uint32_t* src =
      packed + (offs ? int64_t(offs[t]) : t * R) * kPackedLanes;
  switch (d) {
    case 0: unpack_rows<0>(src, bits, t, R, p0, pend, out); break;
    case 1: unpack_rows<1>(src, bits, t, R, p0, pend, out); break;
    case 2: unpack_rows<2>(src, bits, t, R, p0, pend, out); break;
    default: unpack_rows<3>(src, bits, t, R, p0, pend, out); break;
  }
}

// The geometry both launchers take: R % 8 == 0, nrows % R == 0, row
// offsets in int32 and a grid of at most 2^31 - 1 blocks.
bool bad_geometry(int64_t nrows, int R) {
  return R <= 0 || R % 8 || nrows < 0 || nrows % R || nrows > 0x7fffffff ||
         nrows / R * ((R + kChunkRows - 1) / kChunkRows) > 0x7fffffff;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_tile_packed_encode(const void* words, int64_t nrows, int R,
                                     void* bits, void* packed, void* offs,
                                     void* key, int device, void* stream) {
  if (bad_geometry(nrows, R) || misaligned(words) || misaligned(packed) ||
      misaligned(bits, 4) || misaligned(key, 4) || misaligned(offs, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = nrows / R;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* k = static_cast<uint32_t*>(key);
  int32_t* o = static_cast<int32_t*>(offs);
  if (tiles == 0)
    return o ? cudaMemsetAsync(o, 0, sizeof(int32_t), s) : cudaSuccess;
  err = cudaMemsetAsync(k, 0, tiles * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  const int chunks = (R + kChunkRows - 1) / kChunkRows;
  const unsigned grid = static_cast<unsigned>(tiles * chunks);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  tile_or_kernel<<<grid, kPackThreads, 0, s>>>(
      w, R, chunks, static_cast<uint32_t*>(bits), k);
  if (o) offsets_kernel<<<1, kOffsetsThreads, 0, s>>>(k, tiles, R, o);
  pack_kernel<<<grid, kPackThreads, 0, s>>>(
      w, static_cast<const uint8_t*>(bits), k, o, R, chunks,
      static_cast<uint32_t*>(packed));
  return cudaGetLastError();
}

FLRL_API int flrl_tile_packed_decode(const void* bits, const void* packed,
                                     const void* offs, int64_t nrows, int R,
                                     void* out, void* key, int device,
                                     void* stream) {
  if (bad_geometry(nrows, R) || misaligned(packed) || misaligned(out) ||
      misaligned(bits, 4) || misaligned(key, 4) || misaligned(offs, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = nrows / R;
  if (tiles == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* k = static_cast<uint32_t*>(key);
  err = cudaMemsetAsync(k, 0, tiles * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  const int chunks = (R + kChunkRows - 1) / kChunkRows;
  const unsigned grid = static_cast<unsigned>(tiles * chunks);
  depth_kernel<<<grid, kWarp, 0, s>>>(static_cast<const uint32_t*>(bits), R,
                                      chunks, k);
  unpack_kernel<<<grid, kPackThreads, 0, s>>>(
      static_cast<const uint8_t*>(bits), static_cast<const uint32_t*>(packed),
      k, static_cast<const int32_t*>(offs), R, chunks,
      static_cast<uint32_t*>(out));
  return cudaGetLastError();
}
