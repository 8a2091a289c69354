// Flat-tile primitives for Hopper (sm_90a).
//
// This replaces the TPU kernel of the JAX package's lane-primitive harness
// and that of an archived latency probe:
//
//   _run (tests/test_lanes.py:18, pallas_call at :27)  -> flrl_tile_op
//   make (experiments/exp33_round_latency.py:42,
//         pallas_call at :54)                          -> flrl_tile_op,
//                                                         kTileRounds
//
// The Pallas harness runs one ops/lanes.py function over an (R, 128) int32
// tile in VMEM.  Those functions are built from TPU mechanisms: flat shifts
// from lane and sublane rolls under selects, scans as 7 lane rounds plus
// log2(R) row rounds, and compaction and expansion as routing networks of
// nbits shift-and-select rounds, because gathers and scatters are slow
// there.  Hopper has none of those limits, so each op here computes the same
// function directly (lanes.cuh states each one):
//
// - a block takes one tile and walks it in steps of kTileStep elements (one
//   8-row tile), a thread one 16-byte vector of 4 consecutive elements a
//   step;
// - the shifts read each output's source element straight from memory;
// - the prefix sum runs each step through scan.cuh's block_exclusive_scan
//   (int64, the block scan of flrl_frame_offsets and flrl_rl_run_offsets),
//   carries the running sum from step to step and stores it cut to int32,
//   which is the int32 wrap;
// - the max and min scans use their own shuffle scan, forward for the
//   prefix max and backward, over the steps from the last, for the suffix
//   min;
// - compaction and expansion are direct scatters into the tile staged in
//   shared memory (up to 128 KiB at 256 rows, above the 48 KiB default, so
//   the launcher raises the kernel's limit), which is then stored as
//   16-byte vectors.  Monotone distances, the networks' domain, never send
//   two words to one slot, so no write races another.
//
// - the rounds (exp33's 64 dependent rounds of y*3 + roll(y, 1) on
//   (R, 128) rows, which times the TPU's vector pipeline per dependent
//   round; its R and interleaved parts change only that schedule) give a
//   warp a row, four elements a lane in registers: the roll is one
//   __shfl_sync of lane - 1's last element (lane 0 takes lane 31's) and
//   three moves in registers, so a round is four multiply-adds and one
//   shuffle a lane.
//
// Every op but the rounds is bound by memory: each element is read once and
// written once, with a few integer operations an element.  The rounds do
// aux multiply-adds an element on top of that one read and one write, so
// from a few rounds on they are bound by the card's integer rate.
#include <cuda_runtime.h>

#include <climits>

#include "lanes.cuh"
#include "scan.cuh"

namespace flrl {
namespace {

constexpr int kTileThreads = 256;
constexpr int kTileItems = 4;                                // one int4
constexpr int kTileStep = kTileThreads * kTileItems;         // 1024
static_assert(kTileStep == kTileMinRows * kTileLanes,
              "a step is the smallest tile");

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void store4(int32_t* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}

// y[p] = x[p + m] (kDown) or x[p - m], fill outside the tile.
template <bool kDown, bool kDyn>
__global__ void __launch_bounds__(kTileThreads)
shift_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int n,
             int64_t m_static, const int32_t* __restrict__ m_dev,
             int32_t fill) {
  const int64_t m = kDyn ? int64_t(*m_dev) : m_static;
  const int64_t base = int64_t(blockIdx.x) * n;
  const int32_t* xt = x + base;
  for (int at = threadIdx.x * kTileItems; at < n; at += kTileStep) {
    int32_t v[kTileItems];
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) {
      const int64_t src = kDown ? at + i + m : at + i - m;
      v[i] = src >= 0 && src < n ? xt[src] : fill;
    }
    store4(y + base + at, make_int4(v[0], v[1], v[2], v[3]));
  }
}

struct MaxOp {
  __device__ static int32_t identity() { return INT_MIN; }
  __device__ static int32_t apply(int32_t a, int32_t b) { return max(a, b); }
};

struct MinOp {
  __device__ static int32_t identity() { return INT_MAX; }
  __device__ static int32_t apply(int32_t a, int32_t b) { return min(a, b); }
};

// Inclusive scan of one value a lane, over the lanes before it (forward) or
// after it (kReverse).
template <class Op, bool kReverse>
__device__ __forceinline__ int32_t warp_scan(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int32_t u = kReverse ? __shfl_down_sync(kFullMask, v, d)
                               : __shfl_up_sync(kFullMask, v, d);
    if (kReverse ? lane + d < kWarp : lane >= d) v = Op::apply(v, u);
  }
  return v;
}

// Exclusive scan of one value a thread across the block, over the threads
// before this one (forward) or after it (kReverse); *total receives the
// whole block's.  Every thread of the block must call it.  Safe to call
// repeatedly in a loop.
template <class Op, bool kReverse>
__device__ int32_t block_exclusive(int32_t v, int32_t* total) {
  constexpr int kWarps = kTileThreads / kWarp;
  __shared__ int32_t warp_aggs[kWarps];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int32_t inc = warp_scan<Op, kReverse>(v, lane);
  if (lane == (kReverse ? 0 : kWarp - 1)) warp_aggs[w] = inc;
  __syncthreads();
  if (w == 0) {
    int32_t s = lane < kWarps ? warp_aggs[lane] : Op::identity();
    s = warp_scan<Op, kReverse>(s, lane);
    if (lane < kWarps) warp_aggs[lane] = s;
  }
  __syncthreads();
  // the lanes before (after) this one in its warp, then the warps before
  // (after) its warp
  int32_t ex = kReverse ? __shfl_down_sync(kFullMask, inc, 1)
                        : __shfl_up_sync(kFullMask, inc, 1);
  if (lane == (kReverse ? kWarp - 1 : 0)) ex = Op::identity();
  const int other = kReverse ? w + 1 : w - 1;
  if (other >= 0 && other < kWarps) ex = Op::apply(warp_aggs[other], ex);
  *total = warp_aggs[kReverse ? 0 : kWarps - 1];
  __syncthreads();
  return ex;
}

// Inclusive prefix max (forward, MaxOp) or suffix min (kReverse, MinOp),
// starting from fill.
template <class Op, bool kReverse>
__global__ void __launch_bounds__(kTileThreads)
minmax_scan_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                   int n, int32_t fill) {
  const int64_t base = int64_t(blockIdx.x) * n;
  int32_t carry = fill;
  for (int s = 0; s < n; s += kTileStep) {
    const int at = (kReverse ? n - kTileStep - s : s) +
                   threadIdx.x * kTileItems;
    const int4 q = load4(x + base + at);
    int32_t a0 = q.x, a1 = q.y, a2 = q.z, a3 = q.w;
    if (kReverse) {
      a2 = Op::apply(a2, a3);
      a1 = Op::apply(a1, a2);
      a0 = Op::apply(a0, a1);
    } else {
      a1 = Op::apply(a0, a1);
      a2 = Op::apply(a1, a2);
      a3 = Op::apply(a2, a3);
    }
    int32_t total;
    const int32_t ex = block_exclusive<Op, kReverse>(kReverse ? a0 : a3,
                                                     &total);
    const int32_t pre = Op::apply(carry, ex);
    store4(y + base + at,
           make_int4(Op::apply(pre, a0), Op::apply(pre, a1),
                     Op::apply(pre, a2), Op::apply(pre, a3)));
    carry = Op::apply(carry, total);
  }
}

__device__ __forceinline__ int32_t wrap32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

// Inclusive prefix sum, in int64 through the shared block scan, stored
// mod 2^32.
__global__ void __launch_bounds__(kTileThreads)
prefix_sum_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                  int n) {
  const int64_t base = int64_t(blockIdx.x) * n;
  int64_t carry = 0;
  for (int s = 0; s < n; s += kTileStep) {
    const int at = s + threadIdx.x * kTileItems;
    const int4 q = load4(x + base + at);
    const int64_t s0 = q.x;
    const int64_t s1 = s0 + q.y;
    const int64_t s2 = s1 + q.z;
    const int64_t s3 = s2 + q.w;
    int64_t total;
    const int64_t pre =
        carry + block_exclusive_scan<kTileThreads>(s3, &total);
    store4(y + base + at, make_int4(wrap32(pre + s0), wrap32(pre + s1),
                                    wrap32(pre + s2), wrap32(pre + s3)));
    carry += total;
  }
}

// Compaction (down by r) or expansion (kExpand: up by r) of live route
// words, through the tile staged in shared memory.
template <bool kExpand>
__global__ void __launch_bounds__(kTileThreads)
route_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int n,
             int32_t mask) {
  extern __shared__ int4 stage4[];
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  const int64_t base = int64_t(blockIdx.x) * n;
  const int vecs = n / kTileItems;
  for (int i = threadIdx.x; i < vecs; i += kTileThreads)
    stage4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int at = threadIdx.x * kTileItems; at < n; at += kTileStep) {
    const int4 q = load4(x + base + at);
    const int32_t w[kTileItems] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) {
      if (w[i] < 0) {
        const int r = (w[i] >> 16) & mask;
        const int d = kExpand ? at + i + r : at + i - r;
        if (d >= 0 && d < n)
          stage[d] = static_cast<int32_t>(static_cast<uint32_t>(w[i]) -
                                          (static_cast<uint32_t>(r) << 16));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < vecs; i += kTileThreads)
    store4(y + base + i * kTileItems, stage4[i]);
}

// aux rounds of y[l] = 3·y[l] + y[l - 1 mod 128] on each row, a warp a row.
__global__ void __launch_bounds__(kTileThreads)
rounds_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int n,
              int64_t rounds) {
  const int64_t base = int64_t(blockIdx.x) * n;
  const int lane = threadIdx.x % kWarp;
  const int left = (lane + kWarp - 1) % kWarp;
  constexpr int kRowsPerStep = kTileThreads / kWarp;
  for (int at = threadIdx.x / kWarp * kTileLanes + lane * kTileItems; at < n;
       at += kRowsPerStep * kTileLanes) {
    const int4 q = load4(x + base + at);
    uint32_t e0 = q.x, e1 = q.y, e2 = q.z, e3 = q.w;
#pragma unroll 4
    for (int64_t r = 0; r < rounds; ++r) {
      const uint32_t before = __shfl_sync(kFullMask, e3, left);
      e3 = e3 * 3u + e2;
      e2 = e2 * 3u + e1;
      e1 = e1 * 3u + e0;
      e0 = e0 * 3u + before;
    }
    store4(y + base + at, make_int4(static_cast<int32_t>(e0),
                                    static_cast<int32_t>(e1),
                                    static_cast<int32_t>(e2),
                                    static_cast<int32_t>(e3)));
  }
}

constexpr int kDefaultSharedBytes = 48 * 1024;

cudaError_t launch_route(bool expand, const int32_t* x, int32_t* y, int n,
                         int64_t nbits, dim3 grid, cudaStream_t stream) {
  if (nbits < 0 || nbits > 15) return cudaErrorInvalidValue;
  const int smem = n * static_cast<int>(sizeof(int32_t));
  auto kernel = expand ? route_kernel<true> : route_kernel<false>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kTileThreads, smem, stream>>>(
      x, y, n, static_cast<int32_t>((1 << nbits) - 1));
  return cudaSuccess;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_tile_op(int op, const void* x, int64_t aux, int fill,
                          const void* m_dev, void* out, int rows,
                          int64_t tiles, int device, void* stream) {
  if (rows < kTileMinRows || rows > kTileMaxRows || (rows & (rows - 1)) ||
      tiles < 0 || tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
      15)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (tiles == 0) return cudaSuccess;
  const int n = rows * kTileLanes;
  const dim3 grid(static_cast<unsigned>(tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* yi = static_cast<int32_t*>(out);
  const int32_t* mi = static_cast<const int32_t*>(m_dev);
  switch (op) {
    case kTileShiftDown:
      shift_kernel<true, false><<<grid, kTileThreads, 0, s>>>(
          xi, yi, n, aux, nullptr, fill);
      break;
    case kTileShiftUp:
      shift_kernel<false, false><<<grid, kTileThreads, 0, s>>>(
          xi, yi, n, aux, nullptr, fill);
      break;
    case kTileShiftDownDyn:
      if (mi == nullptr) return cudaErrorInvalidValue;
      shift_kernel<true, true><<<grid, kTileThreads, 0, s>>>(
          xi, yi, n, 0, mi, fill);
      break;
    case kTileShiftUpDyn:
      if (mi == nullptr) return cudaErrorInvalidValue;
      shift_kernel<false, true><<<grid, kTileThreads, 0, s>>>(
          xi, yi, n, 0, mi, fill);
      break;
    case kTilePrefixMax:
      minmax_scan_kernel<MaxOp, false><<<grid, kTileThreads, 0, s>>>(
          xi, yi, n, fill);
      break;
    case kTilePrefixSum:
      prefix_sum_kernel<<<grid, kTileThreads, 0, s>>>(xi, yi, n);
      break;
    case kTileSuffixMin:
      minmax_scan_kernel<MinOp, true><<<grid, kTileThreads, 0, s>>>(
          xi, yi, n, fill);
      break;
    case kTileCompact:
    case kTileExpand:
      err = launch_route(op == kTileExpand, xi, yi, n, aux, grid, s);
      if (err != cudaSuccess) return err;
      break;
    case kTileRounds:
      if (aux < 0) return cudaErrorInvalidValue;
      rounds_kernel<<<grid, kTileThreads, 0, s>>>(xi, yi, n, aux);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
