// RL codec kernels for Hopper (sm_90a).
//
// These replace the TPU's Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/rl_pallas.py:
//
//   rl_encode_pallas (+ rl_split_packed) -> flrl_rl_piece_tiles
//                                           + flrl_rl_piece_offsets
//                                           + flrl_rl_compact + flrl_rl_counts
//   _decode_impl (rl_decode_pallas and   -> flrl_rl_run_offsets
//   rl_decode_packed_pallas)                + flrl_rl_expand
//
// The function is ported, not the TPU mechanism.  The Pallas kernels route
// pieces through monotone lane networks and carry a write cursor across a
// sequential grid, because a TPU core has no cheap scatter and its grid
// runs in order.  Hopper blocks run in no order but scatter freely, so
// encode is flag -> scan -> compact over 4096-byte tiles:
//
// * piece_tiles: each tile's first and last natural run start and the
//   pieces it can place by itself (those at or after its first natural
//   start, where the run start is known inside the tile);
// * piece_offsets (one block): a prefix max over the tiles' last natural
//   starts gives every tile the run start it continues; the cap
//   boundaries in a tile's head before its first natural start follow in
//   closed form; an exclusive sum of the piece counts gives each tile its
//   output offset.  Every write index is then unique: no atomics.
// * compact: each tile flags again with its carried run start and
//   scatters value and start byte to its offsets;
// * counts: a piece's count is the difference of consecutive start bytes
//   mod 256, exact because every piece is 1..255 long (the TPU encoder
//   relies on the same fact, rl_split_packed).
//
// Decode is scan -> expand over tiles of 4096 runs: per-tile sums of the
// counts and the shared one-block scan give each tile its output offset;
// the expand block scans its counts into shared memory and fills its
// output range with aligned 32-bit stores, each thread finding its run by
// binary search (the search of IMPLEMENTATION-PLAN.md:154-179 at word
// granularity).  Zero counts take no output: the search finds the last
// run starting at or before a byte, and a zero-count run's start equals
// the next run's.  The packed variant of the TPU decode needs no kernel of
// its own: this encoder writes counts and values directly.
//
// All passes but the one-block offsets pass (24 bytes read per tile) are
// memory-bound: encode reads the chunk twice (tiles, compact) and writes 2
// bytes a piece plus the counts; decode reads the counts twice and the
// values once, and writes the output once.
#include <cuda_runtime.h>

#include "rl.cuh"
#include "scan.cuh"

namespace flrl {
namespace {

constexpr int kCap = 255;
constexpr int64_t kNone = -0x7fffffffffffffffLL - 1;  // INT64_MIN
constexpr int64_t kNoneHi = 0x7fffffffffffffffLL;     // INT64_MAX

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// A thread's kScanItems (8) bytes of an encode tile and which of them start
// a natural run (bit k: byte k differs from the byte before it).
struct Bytes8 {
  uint64_t w = 0;
  int m = 0;
  unsigned nat = 0;
  __device__ __forceinline__ int at(int k) const {
    return static_cast<int>((w >> (8 * k)) & 0xffu);
  }
};

__device__ __forceinline__ Bytes8 load8(const uint8_t* __restrict__ x,
                                        int64_t n, int prev, int64_t p0) {
  Bytes8 t;
  if (p0 >= n) return t;
  t.m = n - p0 < kScanItems ? static_cast<int>(n - p0) : kScanItems;
  if (t.m == kScanItems) {
    t.w = __ldg(reinterpret_cast<const uint64_t*>(x + p0));
  } else {
    for (int k = 0; k < t.m; ++k) t.w |= uint64_t(x[p0 + k]) << (8 * k);
  }
  int before = p0 == 0 ? prev : static_cast<int>(x[p0 - 1]);
  for (int k = 0; k < t.m; ++k) {
    const int v = t.at(k);
    if (v != before) t.nat |= 1u << k;
    before = v;
  }
  return t;
}

__device__ __forceinline__ int64_t last_natural(const Bytes8& t, int64_t p0) {
  return t.nat ? p0 + 31 - __clz(static_cast<int>(t.nat)) : kNone;
}

// Calls emit(k) for each byte k that starts a piece, given s, the start of
// the natural run in progress before byte 0 (kNone: unknown, and then only
// bytes from the thread's first natural start on are judged).
template <typename Emit>
__device__ __forceinline__ void walk(const Bytes8& t, int64_t p0, int64_t s,
                                     Emit emit) {
  bool have = s != kNone;
  int r = have ? static_cast<int>((p0 - s) % kCap) : 0;
  for (int k = 0; k < t.m; ++k) {
    if ((t.nat >> k) & 1u) {
      have = true;
      r = 0;
    }
    if (have && r == 0) emit(k);
    r = r == kCap - 1 ? 0 : r + 1;
  }
}

// Cap boundaries in [lo, hi) of a run that started at s < lo.
__device__ __forceinline__ int64_t caps(int64_t lo, int64_t hi, int64_t s) {
  return hi > lo ? (hi - 1 - s) / kCap - (lo - 1 - s) / kCap : 0;
}

__global__ void __launch_bounds__(kScanThreads)
piece_tiles_kernel(const uint8_t* __restrict__ x, int64_t n, int prev,
                   int64_t* __restrict__ summ) {
  const int64_t b0 = int64_t(blockIdx.x) * kScanTile;
  const int64_t p0 = b0 + int64_t(threadIdx.x) * kScanItems;
  const Bytes8 t = load8(x, n, prev, p0);
  const int64_t first = t.nat ? p0 + __ffs(static_cast<int>(t.nat)) - 1
                              : kNoneHi;
  int64_t tile_first, tile_last, tile_after;
  const int64_t s =
      block_exclusive_scan(last_natural(t, p0), kNone, Max(), &tile_last);
  block_exclusive_scan(first, kNoneHi, Min(), &tile_first);
  int64_t after = 0;
  walk(t, p0, s, [&](int) { ++after; });
  block_exclusive_scan(after, &tile_after);
  if (threadIdx.x == 0) {
    int64_t* out = summ + 3 * int64_t(blockIdx.x);
    out[0] = imin(tile_first, imin(b0 + kScanTile, n));
    out[1] = tile_last;
    out[2] = tile_after;
  }
}

__global__ void __launch_bounds__(kScanThreads)
piece_offsets_kernel(const int64_t* __restrict__ summ, int64_t tiles,
                     int64_t seed, int64_t* __restrict__ tstart,
                     int64_t* __restrict__ offs) {
  int64_t run_start = seed;
  int64_t pieces = 0;
  for (int64_t base = 0; base < tiles; base += kScanTile) {
    const int64_t t0 = base + int64_t(threadIdx.x) * kScanItems;
    int64_t last[kScanItems];
    int64_t mx = kNone;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      last[i] = t0 + i < tiles ? summ[3 * (t0 + i) + 1] : kNone;
      mx = imax(mx, last[i]);
    }
    int64_t block_max;
    int64_t s = imax(run_start,
                     block_exclusive_scan(mx, kNone, Max(), &block_max));
    int64_t st[kScanItems], cnt[kScanItems];
    int64_t sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int64_t t = t0 + i;
      st[i] = s;
      cnt[i] = 0;
      if (t < tiles) {
        const int64_t b0 = t * kScanTile;
        cnt[i] = summ[3 * t + 2] + caps(b0, summ[3 * t], s);
      }
      s = imax(s, last[i]);
      sum += cnt[i];
    }
    int64_t block_sum;
    int64_t o = pieces + block_exclusive_scan(sum, &block_sum);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (t0 + i < tiles) {
        tstart[t0 + i] = st[i];
        offs[t0 + i] = o;
      }
      o += cnt[i];
    }
    run_start = imax(run_start, block_max);
    pieces += block_sum;
  }
  if (threadIdx.x == 0) {
    tstart[tiles] = run_start;
    offs[tiles] = pieces;
  }
}

__global__ void __launch_bounds__(kScanThreads)
compact_kernel(const uint8_t* __restrict__ x, int64_t n, int prev,
               const int64_t* __restrict__ tstart,
               const int64_t* __restrict__ offs, uint8_t* __restrict__ values,
               uint8_t* __restrict__ starts8) {
  const int64_t p0 =
      int64_t(blockIdx.x) * kScanTile + int64_t(threadIdx.x) * kScanItems;
  const Bytes8 t = load8(x, n, prev, p0);
  int64_t unused, total;
  const int64_t s = imax(
      tstart[blockIdx.x],
      block_exclusive_scan(last_natural(t, p0), kNone, Max(), &unused));
  int64_t cnt = 0;
  walk(t, p0, s, [&](int) { ++cnt; });
  int64_t o = offs[blockIdx.x] + block_exclusive_scan(cnt, &total);
  walk(t, p0, s, [&](int k) {
    values[o] = static_cast<uint8_t>(t.at(k));
    starts8[o] = static_cast<uint8_t>(p0 + k);
    ++o;
  });
}

__global__ void counts_kernel(const uint8_t* __restrict__ starts8, int64_t R,
                              int64_t n, uint8_t* __restrict__ counts) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t j = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; j < R;
       j += stride) {
    const unsigned next = j + 1 < R ? starts8[j + 1]
                                    : static_cast<unsigned>(n & 0xff);
    counts[j] = static_cast<uint8_t>(next - starts8[j]);
  }
}

// A thread's kScanItems (8) counts of a decode tile, as one 8-byte word.
__device__ __forceinline__ uint64_t load_runs8(const uint8_t* __restrict__ a,
                                               int64_t R, int64_t r0) {
  if (r0 + kScanItems <= R)
    return __ldg(reinterpret_cast<const uint64_t*>(a + r0));
  uint64_t w = 0;
  for (int64_t k = 0; r0 + k < R; ++k) w |= uint64_t(a[r0 + k]) << (8 * k);
  return w;
}

__global__ void __launch_bounds__(kScanThreads)
run_tile_sums_kernel(const uint8_t* __restrict__ counts, int64_t R,
                     int64_t* __restrict__ sums) {
  const int64_t r0 =
      int64_t(blockIdx.x) * kScanTile + int64_t(threadIdx.x) * kScanItems;
  const uint64_t c = load_runs8(counts, R, r0);
  int64_t sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) sum += (c >> (8 * k)) & 0xffu;
  int64_t total;
  block_exclusive_scan(sum, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
expand_kernel(const uint8_t* __restrict__ counts,
              const uint8_t* __restrict__ values, int64_t R,
              const int64_t* __restrict__ offs, int64_t n,
              uint8_t* __restrict__ out) {
  // run starts relative to the tile (< 4096·255, so int32), plus a
  // sentinel at kScanTile holding the tile's total
  __shared__ int32_t starts[kScanTile + 1];
  __shared__ uint8_t vals[kScanTile];
  const int64_t r0 =
      int64_t(blockIdx.x) * kScanTile + int64_t(threadIdx.x) * kScanItems;
  const uint64_t c = load_runs8(counts, R, r0);
  const uint64_t v = load_runs8(values, R, r0);
  int64_t sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) sum += (c >> (8 * k)) & 0xffu;
  int64_t total;
  int64_t pre = block_exclusive_scan(sum, &total);
  const int i0 = threadIdx.x * kScanItems;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    starts[i0 + k] = static_cast<int32_t>(pre);
    vals[i0 + k] = static_cast<uint8_t>(v >> (8 * k));
    pre += (c >> (8 * k)) & 0xffu;
  }
  if (threadIdx.x == 0) starts[kScanTile] = static_cast<int32_t>(total);
  __syncthreads();
  const int64_t base = offs[blockIdx.x];
  const int64_t end = imin(base + total, n);
  // aligned 4-byte words of the output that hold bytes of this tile; the
  // first and last may share bytes with the neighbouring tiles and store
  // only their own bytes
  for (int64_t wd = base / 4 + threadIdx.x; wd * 4 < end;
       wd += kScanThreads) {
    const int64_t p = wd * 4 - base;  // tile-relative position of byte 0
    const int32_t q = static_cast<int32_t>(p > 0 ? p : 0);
    int lo = 0, hi = kScanTile;  // starts[lo] <= q < starts[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (starts[mid] <= q) lo = mid; else hi = mid;
    }
    uint32_t word = 0;
    bool whole = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t rel = p + k;
      if (rel < 0 || base + rel >= end) {
        whole = false;
        continue;
      }
      while (starts[lo + 1] <= rel) ++lo;
      word |= uint32_t(vals[lo]) << (8 * k);
    }
    if (whole) {
      *reinterpret_cast<uint32_t*>(out + wd * 4) = word;
    } else {
      for (int k = 0; k < 4; ++k) {
        const int64_t rel = p + k;
        if (rel >= 0 && base + rel < end)
          out[base + rel] = static_cast<uint8_t>(word >> (8 * k));
      }
    }
  }
}

int64_t tiles_of(int64_t items) { return (items + kScanTile - 1) / kScanTile; }

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_rl_piece_tiles(const void* x, int64_t n, int prev,
                                 void* summ, int device, void* stream) {
  if (n < 0 || prev < -1 || prev > 255) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  piece_tiles_kernel<<<static_cast<unsigned>(tiles_of(n)), kScanThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, prev, static_cast<int64_t*>(summ));
  return cudaGetLastError();
}

FLRL_API int flrl_rl_piece_offsets(const void* summ, int64_t n, int64_t d0,
                                   void* tstart, void* offs, int device,
                                   void* stream) {
  if (n < 0 || d0 < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  piece_offsets_kernel<<<1, kScanThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(summ), tiles_of(n), -d0,
      static_cast<int64_t*>(tstart), static_cast<int64_t*>(offs));
  return cudaGetLastError();
}

FLRL_API int flrl_rl_compact(const void* x, int64_t n, int prev,
                             const void* tstart, const void* offs,
                             void* values, void* starts8, int device,
                             void* stream) {
  if (n < 0 || prev < -1 || prev > 255) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  compact_kernel<<<static_cast<unsigned>(tiles_of(n)), kScanThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, prev,
      static_cast<const int64_t*>(tstart), static_cast<const int64_t*>(offs),
      static_cast<uint8_t*>(values), static_cast<uint8_t*>(starts8));
  return cudaGetLastError();
}

FLRL_API int flrl_rl_counts(const void* starts8, int64_t R, int64_t n,
                            void* counts, int device, void* stream) {
  if (R < 0 || n < R) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0) return cudaSuccess;
  const int64_t blocks = (R + 255) / 256;
  counts_kernel<<<static_cast<unsigned>(blocks < (1 << 20) ? blocks
                                                           : (1 << 20)),
                  256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(starts8), R, n,
      static_cast<uint8_t*>(counts));
  return cudaGetLastError();
}

FLRL_API int flrl_rl_run_offsets(const void* counts, int64_t R, void* offs,
                                 int device, void* stream) {
  if (R < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(R);
  int64_t* o = static_cast<int64_t*>(offs);
  if (tiles > 0) {
    run_tile_sums_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0,
                           s>>>(static_cast<const uint8_t*>(counts), R, o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  scan_carries_kernel<<<1, kScanThreads, 0, s>>>(o, tiles, o + tiles);
  return cudaGetLastError();
}

FLRL_API int flrl_rl_expand(const void* counts, const void* values,
                            int64_t R, const void* offs, int64_t n,
                            void* out, int device, void* stream) {
  if (R < 0 || n < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0 || n == 0) return cudaSuccess;
  expand_kernel<<<static_cast<unsigned>(tiles_of(R)), kScanThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(counts), static_cast<const uint8_t*>(values),
      R, static_cast<const int64_t*>(offs), n, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
