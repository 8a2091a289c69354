// The tile-packed field codec for Hopper (sm_90a).
//
// This replaces the TPU kernels of two archived layout studies:
//
//   experiments/exp21_tile_packed.py   enc_packed (:161, pallas_call :166),
//                                      dec_packed (:221, pallas_call :226)
//   experiments/exp22_tile_packed2.py  enc_packed (:156, pallas_call :161),
//                                      dec_packed (:246, pallas_call :251)
//
//   -> flrl_tile_packed_encode / flrl_tile_packed_decode,
//      the cursor layout (exp21: offs) or the sparse one (exp22: no offs)
//
// The Pallas kernels walk the tiles on a sequential grid: each step takes a
// tile into VMEM, computes its widths and fields there, halves them d times
// and DMAs the R>>d rows out behind a cursor carried in SMEM (exp21) or to
// row t·R (exp22).  Each tile's words are read once.  A tile is R·512
// bytes (512 KiB at exp21's R = 1024), more than one SM's shared memory,
// and its depth needs the whole tile's OR before any packed row is known.
//
// Encode, the cluster route (flrl_tile_packed_encode, R up to 6,144):
// cluster_encode_kernel.  Write R = 8·Q.  Every slot source of packed row
// pr at any depth lies in pr's class mod Q (off(k) adds R/2, R/4 and R/8,
// multiples of Q), so a tile splits into the Q classes of 8 rows q + j·Q.
// A thread-block cluster of C blocks holds one tile (C = cluster_blocks(R):
// 8 at R = 1024, 16 at 2048, 64 KiB a block), block r the classes
// [r·Q/C, (r+1)·Q/C); tiles of at most 64 KiB go whole to one block, up to
// 16 a block (cluster_tiles).  A block:
//   1. cursor layout: rank 0 takes the cluster's unit by ticket (scan.cuh's
//      order; its peers read it through distributed shared memory after a
//      cluster barrier); sparse: the unit is the cluster's index;
//   2. loads its rows into shared memory by TMA bulk copies
//      (cp.async.bulk, eight runs of contiguous rows, one per j), which
//      hold no registers in flight, and waits on their mbarrier;
//   3. a warp a class: each lane ORs its 16-byte vector of the class's 8
//      rows, a frame's 8 lanes combine by xor shuffles, and the row's four
//      widths go to shared memory and then to `bits`; the block's OR of a
//      tile goes by atomicOr into every block's word for the tile through
//      distributed shared memory, and one cluster barrier later every block
//      knows the tile's depth;
//   4. sparse layout: packs each class (the lane's 8 vectors in registers)
//      straight to its packed rows q + i·Q, i < 8 >> d, from row t·R;
//   5. cursor layout: packs each class in place while rank 0 publishes the
//      unit's packed rows, finds its first row by decoupled look-back
//      (scan.cuh), writes offs and puts each tile's first row into every
//      block; after a second cluster barrier each block stores its packed
//      rows from shared memory, 16 bytes a thread.
// Bytes: the words read once, the widths and the packed rows written once.
// A persistent form of this kernel (clusters that walk the units with two
// or three stages, tickets taken ahead) was slower in the cursor layout
// and no faster in the sparse one (PERF.md §6, the tile-packed encode).
//
// Encode, the two-pass route (flrl_tile_packed_encode_2pass, any R):
// - tile_or_kernel, a block a chunk of kChunkRows rows of a tile, a warp a
//   row, stores the widths and ORs the tile's bytes into key[t]; in the
//   cursor layout offsets_kernel, one block, scans the tiles' row counts
//   R >> d into offs (scan.cuh's block_exclusive_scan); pack_kernel, a
//   block a chunk of packed rows, a thread a 16-byte vector of one packed
//   row, reads the 2^d source vectors of its slots, spreads each word at its
//   frame's width and ORs them at their shifts.  The words are read twice:
//   a 256 MiB stream does not stay in the 50 MB L2 between the passes.
//
// Decode: depth_kernel, a warp a chunk of rows, ORs (1 << b) - 1 over the
// tile's widths into key[t] (its bit length is the tile's widest width);
// unpack_kernel, laid out as pack_kernel, reads each packed vector once and
// writes its 2^d output vectors, each its slot's bits
// (z >> shift(k)) & (2^(32>>d) - 1) unspread at its frame's width.  That is
// the mirrored ladder of masks {0xFFFF, 0xFF00FF, 0xF0F0F0F} of the Pallas
// decode, for any packed word.
//
// The ORs need no order, so blocks of one tile meet by atomicOr; the
// two-pass and decode launchers clear key on the stream.  Widths of at most
// 8 bits in a frame of 32 words are an OR-reduce across the frame's lanes,
// as in flrl_fields_encode: no f32 exponent trick and no matrix unit, which
// the TPU kernels use for their segment max.  Bound by memory; a few
// integer operations a word.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <tuple>

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

// Slot k of depth D within a class: the source's row j of the 8 rows
// q + j·Q, for packed row i of the class (off(k) / Q: R/2, R/4, R/8 are
// 4Q, 2Q, Q).
template <int D>
__host__ __device__ constexpr int class_slot(int k) {
  int j = 0;
  for (int s = 0; s < D; ++s)
    if ((k >> s) & 1) j += 4 >> s;
  return j;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier of one arrival, made visible to the bulk copies.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival, expecting `bytes` of bulk copies.
__device__ __forceinline__ void barrier_expect(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Until the barrier's phase of the given parity completes.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// A TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Encode, the two-pass route
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
// Encode, the cluster route
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterWarps = kClusterThreads / kWarp;
static_assert(kClusterThreads % kWarp == 0, "whole warps");
// a thread a block and tile of the cluster sends the block's OR (C > 1
// takes one tile, a one-block unit at most kClusterTiles)
static_assert(kClusterMax <= kClusterThreads &&
                  kClusterTiles <= kClusterThreads,
              "too few threads");

// A block's words beside its staged rows: the bulk copies' barrier, the
// cluster's unit (rank 0's ticket, cursor layout), and a word each of its
// tiles: the block's OR, the cluster's OR, the tile's first packed row
// (cursor layout).
struct ClusterShared {
  uint64_t bar;
  int64_t base[kClusterTiles];
  uint32_t block_or[kClusterTiles];
  uint32_t tile_or[kClusterTiles];
  unsigned unit;
};

// Rows of class ql of a unit's tile tt in a block's stage: rows j = 0..7
// of the class at (tt·8 + j)·ncls + ql, 32 vectors a row.
__device__ __forceinline__ int staged_row(int tt, int j, int ncls, int ql) {
  return (tt * 8 + j) * ncls + ql;
}

// Lane `lane`'s vector of class ql of tile tt packed at depth D: packed
// row i < 8 >> D of the class goes to out[i·step] (in place: over row i of
// the stage; or to device memory).  Every row is read before any is
// written, so `out` may alias `rows`.
template <int D>
__device__ __forceinline__ void pack_class(const uint4* rows,
                                           const uint32_t* wid, int tt,
                                           int ncls, int ql, int lane,
                                           uint4* out, int64_t step) {
  const int f = lane / (kRowVecs / kPackedFrames);
  uint4 x[8];
  int b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = staged_row(tt, j, ncls, ql);
    x[j] = rows[row * kRowVecs + lane];
    b[j] = (wid[row] >> (8 * f)) & 0xff;
  }
#pragma unroll
  for (int i = 0; i < (8 >> D); ++i) {
    uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      const int j = i + class_slot<D>(k);
      const int sh = slot_shift<D>(k);
      acc.x |= spread(x[j].x, b[j]) << sh;
      acc.y |= spread(x[j].y, b[j]) << sh;
      acc.z |= spread(x[j].z, b[j]) << sh;
      acc.w |= spread(x[j].w, b[j]) << sh;
    }
    out[i * step] = acc;
  }
}

// Cluster u of C blocks (a unit of T tiles; cursor layout: the unit of
// rank 0's ticket, so that a look-back only waits on units whose clusters
// started), block `rank` the classes [rank·Q/C, (rank+1)·Q/C) of each of
// its tiles.  Dynamic shared memory: the staged rows, then their widths
// (cluster_smem).
template <bool kCursor>
__global__ void __launch_bounds__(kClusterThreads)
cluster_encode_kernel(const uint32_t* __restrict__ words, int64_t tiles,
                      int R, int C, int T, uint32_t* __restrict__ bits,
                      uint32_t* __restrict__ packed,
                      int32_t* __restrict__ offs,
                      uint64_t* __restrict__ status,
                      unsigned* __restrict__ ticket) {
  extern __shared__ __align__(128) uint4 rows[];
  __shared__ ClusterShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int Q = R / 8;
  const int c0 = static_cast<int>(int64_t(rank) * Q / C);
  const int ncls = static_cast<int>(int64_t(rank + 1) * Q / C) - c0;
  const int64_t units = (tiles + T - 1) / T;

  // Thread 0: the barrier, and the loads of unit u's rows: runs of ncls
  // rows, one for each tile and j (one run in all where the block takes
  // whole tiles).
  const auto load = [&](int64_t u) {
    const int64_t t0 = u * T;
    const int nt = tiles - t0 < T ? static_cast<int>(tiles - t0) : T;
    const uint32_t run = uint32_t(ncls) * kRowBytes;
    barrier_expect(&sh.bar, uint32_t(nt) * 8 * run);
    if (C == 1) {
      bulk_load(rows, words + t0 * R * kPackedLanes, uint32_t(nt) * 8 * run,
                &sh.bar);
      return;
    }
    for (int j = 0; j < 8; ++j)
      bulk_load(rows + j * ncls * kRowVecs,
                words + (t0 * R + int64_t(j) * Q + c0) * kPackedLanes, run,
                &sh.bar);
  };
  int64_t u = blockIdx.x / C;
  if (threadIdx.x == 0) {
    barrier_init(&sh.bar);
    for (int i = 0; i < kClusterTiles; ++i) sh.block_or[i] = sh.tile_or[i] = 0;
    if (kCursor && rank == 0) sh.unit = atomicAdd(ticket, 1u);
    if (!kCursor) load(u);
  }
  // every block started and cleared its words; rank 0 holds the ticket
  cluster.sync();
  if (kCursor) {
    u = *cluster.map_shared_rank(&sh.unit, 0);
    if (threadIdx.x == 0) load(u);
  }
  const int64_t t0 = u * T;
  const int nt = tiles - t0 < T ? static_cast<int>(tiles - t0) : T;
  const int items = nt * ncls;  // a warp a class of a tile
  uint32_t* wid = reinterpret_cast<uint32_t*>(rows + items * 8 * kRowVecs);
  barrier_wait(&sh.bar, 0);

  // Widths and the block's OR of each tile.
  for (int it = warp; it < items; it += kClusterWarps) {
    const int tt = it / ncls, ql = it % ncls;
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = staged_row(tt, j, ncls, ql);
      const uint4 x = rows[row * kRowVecs + lane];
      uint32_t o = x.x | x.y | x.z | x.w;
      o |= o >> 16;
      o = (o | o >> 8) & 0xffu;
      // the frame's 8 lanes
      o |= __shfl_xor_sync(kFullMask, o, 1);
      o |= __shfl_xor_sync(kFullMask, o, 2);
      o |= __shfl_xor_sync(kFullMask, o, 4);
      acc |= o;
      const uint32_t b = static_cast<uint32_t>(width_of_or(o));
      const uint32_t w = __shfl_sync(kFullMask, b, 0) |
                         __shfl_sync(kFullMask, b, 8) << 8 |
                         __shfl_sync(kFullMask, b, 16) << 16 |
                         __shfl_sync(kFullMask, b, 24) << 24;
      if (lane == 0) wid[row] = w;
    }
    acc = __reduce_or_sync(kFullMask, acc);
    if (lane == 0 && acc) atomicOr(&sh.block_or[tt], acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < items * 8; i += kClusterThreads) {
    const int tt = i / (8 * ncls), j = i / ncls % 8, ql = i % ncls;
    bits[(t0 + tt) * R + int64_t(j) * Q + c0 + ql] = wid[i];
  }
  if (threadIdx.x < C * nt) {
    const int r = threadIdx.x / nt, tt = threadIdx.x % nt;
    if (sh.block_or[tt])
      atomicOr(cluster.map_shared_rank(&sh.tile_or[tt], r), sh.block_or[tt]);
  }
  // every block's OR is in every block's words
  cluster.sync();

  if (kCursor && rank == 0 && warp == 0) {
    // the unit's packed rows, its first row by look-back, each tile's
    const int64_t m =
        lane < nt ? R >> depth_of(width_of_or(sh.tile_or[lane])) : 0;
    const int64_t inc = warp_inclusive_scan(m, lane);
    const int64_t total = __shfl_sync(kFullMask, inc, kWarp - 1);
    int64_t prefix = 0;
    if (u == 0) {
      if (lane == 0) publish_status(status, kStatusPrefix, total);
    } else {
      if (lane == 0) publish_status(status + u, kStatusAggregate, total);
      prefix = look_back(status, u, lane);
      if (lane == 0) publish_status(status + u, kStatusPrefix, prefix + total);
    }
    if (lane < nt) {
      const int64_t base = prefix + inc - m;
      offs[t0 + lane] = static_cast<int32_t>(base);
      for (int r = 0; r < C; ++r)
        *cluster.map_shared_rank(&sh.base[lane], r) = base;
    }
    if (lane == 0 && u == units - 1)
      offs[tiles] = static_cast<int32_t>(prefix + total);
  }

  // Pack each class: in place while rank 0 looks back (cursor), or straight
  // to its packed rows at t·R (sparse).
  for (int it = warp; it < items; it += kClusterWarps) {
    const int tt = it / ncls, ql = it % ncls;
    uint4* out;
    int64_t step;
    if (kCursor) {
      out = rows + staged_row(tt, 0, ncls, ql) * kRowVecs + lane;
      step = int64_t(ncls) * kRowVecs;
    } else {
      out = reinterpret_cast<uint4*>(
                packed + ((t0 + tt) * R + c0 + ql) * kPackedLanes) + lane;
      step = int64_t(Q) * kRowVecs;
    }
    switch (depth_of(width_of_or(sh.tile_or[tt]))) {
      case 0: pack_class<0>(rows, wid, tt, ncls, ql, lane, out, step); break;
      case 1: pack_class<1>(rows, wid, tt, ncls, ql, lane, out, step); break;
      case 2: pack_class<2>(rows, wid, tt, ncls, ql, lane, out, step); break;
      default: pack_class<3>(rows, wid, tt, ncls, ql, lane, out, step); break;
    }
  }
  if (!kCursor) return;  // no block reads another's words past the barrier
  // every block holds its tiles' first rows from rank 0; after this
  // barrier no block reads another's words
  cluster.sync();
  for (int tt = 0; tt < nt; ++tt) {
    const int d = depth_of(width_of_or(sh.tile_or[tt]));
    for (int i = 0; i < (8 >> d); ++i) {
      const uint4* src = rows + staged_row(tt, i, ncls, 0) * kRowVecs;
      uint4* dst = reinterpret_cast<uint4*>(
          packed + (sh.base[tt] + int64_t(i) * Q + c0) * kPackedLanes);
      for (int e = threadIdx.x; e < ncls * kRowVecs; e += kClusterThreads)
        dst[e] = src[e];
    }
  }
}

// Dynamic shared memory of a cluster-route block: T tiles' 8 rows of
// ceil(Q/C) classes, and their widths.
int cluster_smem(int R) {
  const int q = R / 8, c = cluster_blocks(R);
  return cluster_tiles(R) * 8 * ((q + c - 1) / c) * (kRowBytes + 4);
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

// The geometry every launcher takes: R % 8 == 0, nrows % R == 0, row
// offsets in int32 and a grid of at most 2^31 - 1 blocks.
bool bad_geometry(int64_t nrows, int R) {
  return R <= 0 || R % 8 || nrows < 0 || nrows % R || nrows > 0x7fffffff ||
         nrows / R * ((R + kChunkRows - 1) / kChunkRows) > 0x7fffffff;
}

// Whether the card holds one cluster of this launch (checked where C > 8,
// a size that needs C SMs free in one GPC), once a device, kernel and
// shared memory size: cudaErrorLaunchOutOfResources where it cannot.
cudaError_t cluster_fits_card(const void* kernel, const cudaLaunchConfig_t& cfg,
                              int device) {
  static std::mutex mu;
  static std::set<std::tuple<int, const void*, size_t>> held;
  const auto key = std::make_tuple(device, kernel, cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  if (held.count(key)) return cudaSuccess;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorLaunchOutOfResources;
  held.insert(key);
  return cudaSuccess;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_tile_packed_route(int R) { return tile_packed_route(R); }

FLRL_API int flrl_tile_packed_encode(const void* words, int64_t nrows, int R,
                                     void* bits, void* packed, void* offs,
                                     void* scratch, int device, void* stream) {
  if (!tile_packed_route(R))
    return flrl_tile_packed_encode_2pass(words, nrows, R, bits, packed, offs,
                                         scratch, device, stream);
  if (bad_geometry(nrows, R) || misaligned(words) || misaligned(packed) ||
      misaligned(bits, 4) || misaligned(scratch, 8) || misaligned(offs, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = nrows / R;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(offs);
  if (tiles == 0)
    return o ? cudaMemsetAsync(o, 0, sizeof(int32_t), s) : cudaSuccess;
  const int C = cluster_blocks(R), T = cluster_tiles(R);
  const int64_t units = (tiles + T - 1) / T;
  auto kernel = o ? cluster_encode_kernel<true> : cluster_encode_kernel<false>;
  const int smem = cluster_smem(R);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(units * C));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (C > 8) {
    err = cluster_fits_card(reinterpret_cast<const void*>(kernel), cfg,
                            device);
    if (err != cudaSuccess) return err;
  }
  // a status word a unit, then the ticket (cursor layout), cleared on the
  // stream
  uint64_t* status = static_cast<uint64_t*>(scratch);
  if (o) {
    err = cudaMemsetAsync(status, 0, (units + 1) * sizeof(uint64_t), s);
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint32_t*>(words), tiles, R, C, T,
      static_cast<uint32_t*>(bits), static_cast<uint32_t*>(packed), o, status,
      reinterpret_cast<unsigned*>(status + units));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

FLRL_API int flrl_tile_packed_encode_2pass(const void* words, int64_t nrows,
                                           int R, void* bits, void* packed,
                                           void* offs, void* scratch,
                                           int device, void* stream) {
  if (bad_geometry(nrows, R) || misaligned(words) || misaligned(packed) ||
      misaligned(bits, 4) || misaligned(scratch, 8) || misaligned(offs, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = nrows / R;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tiles' keys
  uint32_t* k = static_cast<uint32_t*>(scratch);
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
