// Block-level int64 scans shared by the FL and RL kernels.
//
// Hopper blocks run in no order, so anything that places variable-sized
// pieces (FL frames, RL pieces, RL run tiles) needs a scan across blocks.
// It is single-pass with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016),
// in int64 (a 1 GiB chunk has up to 2^30 items): flrl_frame_offsets (the
// frame placement of fl_dense_pallas.py:732 and :1074, whose sequential grid
// carries a cursor) and flrl_rl_run_offsets over a sum, and, templated on
// its operator, the run-start operator of flrl_rl_encode (rl.cu).  Bound by
// bytes: each item is read once and each offset written once.  A block
// takes its tile by ticket (take_tile), scans it, publishes its aggregate
// and then its inclusive prefix as one 64-bit status word each
// (publish_status), and one warp folds its predecessors' words until it
// meets a prefix (look_back).  The status words and the ticket must be zero
// when the kernel starts: the launcher clears them on the kernel's stream,
// since a look-back that read a word of an earlier call (the caching
// allocator hands the same memory back) would be wrong.  Forward progress:
// tiles are taken in ticket order, so a block only ever waits on tiles
// whose blocks have already started, and tile 0 publishes its prefix
// without waiting.
#pragma once

#include <cstdint>

namespace flrl {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// The RL run tile of flrl_rl_run_offsets and flrl_rl_expand: 256 threads ×
// 16 runs, one 16-byte load of counts a thread.  ops/rl_cuda.py's TILE must
// match.
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int64_t kScanTile = int64_t(kScanThreads) * kScanItems;

// Status word of a single-pass scan tile: a 2-bit flag over a 62-bit value.
constexpr uint64_t kStatusAggregate = uint64_t(1) << 62;  // tile's own sum
constexpr uint64_t kStatusPrefix = uint64_t(2) << 62;     // inclusive prefix
constexpr uint64_t kStatusValue = (uint64_t(1) << 62) - 1;

namespace {

__device__ __forceinline__ int64_t warp_inclusive_scan(int64_t x, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int64_t y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1)
    x += __shfl_xor_sync(kFullMask, x, d);
  return x;
}

// Exclusive sum of one value per thread across a block of kThreads;
// *total receives the whole block's sum.  Every thread of the block must
// call it.  Safe to call repeatedly in a loop.
template <int kThreads = kScanThreads>
__device__ int64_t block_exclusive_scan(int64_t v, int64_t* total) {
  constexpr int kWarps = kThreads / kWarp;
  __shared__ int64_t warp_sums[kWarps];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t inc = warp_inclusive_scan(v, lane);
  if (lane == kWarp - 1) warp_sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    int64_t s = lane < kWarps ? warp_sums[lane] : 0;
    s = warp_inclusive_scan(s, lane);
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int64_t prefix = w > 0 ? warp_sums[w - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return prefix + inc - v;
}

// Single-pass scan: the block's tile, in the order blocks started.
__device__ __forceinline__ int64_t take_tile(unsigned* ticket) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);
  __syncthreads();
  return tile;
}

// One 64-bit store, so a reader never sees a flag without its value.
__device__ __forceinline__ void publish_status(uint64_t* status,
                                               uint64_t flag, int64_t value) {
  *reinterpret_cast<volatile unsigned long long*>(status) =
      flag | (static_cast<uint64_t>(value) & kStatusValue);
}

// The summation the look-back folds by default: a status value is a tile's
// sum (aggregate) or the sum of every tile up to it (prefix).
struct SumLookBack {
  using T = int64_t;
  __device__ __forceinline__ T identity() const { return 0; }
  __device__ __forceinline__ T value(uint64_t s, int64_t) const {
    return static_cast<int64_t>(s & kStatusValue);
  }
  __device__ __forceinline__ T fold(T x) const { return warp_sum(x); }
  __device__ __forceinline__ T combine(T earlier, T later) const {
    return earlier + later;
  }
};

// Exclusive prefix of tile t >= 1, called by one whole warp: lane i reads
// tile t-1-i's status word, the warp waits until every word up to the
// nearest prefix is published, folds the aggregates and that prefix, or all
// 32 aggregates and steps 32 tiles further back.  `Op` reads a status word
// of tile j (value), folds the warp's values in tile order, lane 31 the
// earliest (fold, its result on every lane), and combines two folds of
// adjacent ranges (combine); any associative operator will do.
template <typename Op = SumLookBack>
__device__ typename Op::T look_back(const uint64_t* status, int64_t t,
                                    int lane, const Op op = Op()) {
  typename Op::T prefix = op.identity();
  for (int64_t end = t;; end -= kWarp) {
    const int64_t j = end - 1 - lane;
    uint64_t s;
    unsigned prefixes, wanted;
    for (;;) {
      // a lane before tile 0 reads a zero prefix; tile 0's own prefix
      // always comes first in the fold
      s = j >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(
                       status + j)
                 : kStatusPrefix;
      const unsigned ready = __ballot_sync(kFullMask, (s >> 62) != 0);
      prefixes = __ballot_sync(kFullMask, (s >> 62) == 2);
      // lanes up to and including the nearest prefix (all if none)
      wanted = prefixes ? (prefixes & (0u - prefixes)) * 2u - 1u : kFullMask;
      if ((ready & wanted) == wanted) break;
    }
    prefix = op.combine(
        op.fold((wanted >> lane) & 1u ? op.value(s, j) : op.identity()),
        prefix);
    if (prefixes) return prefix;
  }
}

}  // namespace
}  // namespace flrl
