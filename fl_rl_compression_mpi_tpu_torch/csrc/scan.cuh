// Block-level int64 scans shared by the FL and RL kernels.
//
// Hopper blocks run in no order, so anything that places variable-sized
// pieces (FL frames, RL pieces) takes a two-level scan: each block scans
// its own tile with block_exclusive_scan and writes the tile's total, one
// block scans the totals (scan_carries_kernel), and every item adds its
// tile's carry (add_carries_kernel) or reads it directly.  All in int64:
// a 1 GiB chunk has up to 2^30 items.
#pragma once

#include <cstdint>

namespace flrl {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// One scan tile: 512 threads × 8 items.
constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int64_t kScanTile = int64_t(kScanThreads) * kScanItems;

struct Sum {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return a + b;
  }
};

struct Max {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return a > b ? a : b;
  }
};

struct Min {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return a < b ? a : b;
  }
};

namespace {

template <typename Op = Sum>
__device__ __forceinline__ int64_t warp_inclusive_scan(int64_t x, int lane,
                                                       Op op = Op()) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int64_t y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x = op(x, y);
  }
  return x;
}

// Exclusive scan under `op` (identity `id`) of one value per thread across
// a block of kScanThreads; *total receives the whole block's reduction.
// Every thread of the block must call it.  Safe to call repeatedly in a
// loop.
template <typename Op>
__device__ int64_t block_exclusive_scan(int64_t v, int64_t id, Op op,
                                        int64_t* total) {
  constexpr int kWarps = kScanThreads / kWarp;
  __shared__ int64_t warp_sums[kWarps];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t inc = warp_inclusive_scan(v, lane, op);
  int64_t exc = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) exc = id;
  if (lane == kWarp - 1) warp_sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    int64_t s = lane < kWarps ? warp_sums[lane] : id;
    s = warp_inclusive_scan(s, lane, op);
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int64_t prefix = w > 0 ? warp_sums[w - 1] : id;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return op(prefix, exc);
}

// The sum scan the placement passes use.
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t v,
                                                        int64_t* total) {
  return block_exclusive_scan(v, 0, Sum(), total);
}

// One block: carries[t] <- exclusive scan of the tile totals; *end <- sum.
__global__ void __launch_bounds__(kScanThreads)
scan_carries_kernel(int64_t* __restrict__ carries, int64_t tiles,
                    int64_t* __restrict__ end) {
  int64_t running = 0;
  for (int64_t base = 0; base < tiles; base += kScanTile) {
    const int64_t t0 = base + int64_t(threadIdx.x) * kScanItems;
    int64_t x[kScanItems];
    int64_t sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      x[i] = t0 + i < tiles ? carries[t0 + i] : 0;
      sum += x[i];
    }
    int64_t total;
    int64_t pre = running + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (t0 + i < tiles) carries[t0 + i] = pre;
      pre += x[i];
    }
    running += total;
  }
  if (threadIdx.x == 0) *end = running;
}

__global__ void add_carries_kernel(int64_t* __restrict__ offs, int64_t frames,
                                   const int64_t* __restrict__ carries) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t f = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       f < frames; f += stride)
    offs[f] += carries[f / kScanTile];
}

}  // namespace
}  // namespace flrl
