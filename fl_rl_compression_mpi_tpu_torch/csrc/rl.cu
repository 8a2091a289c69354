// RL codec kernels for Hopper (sm_90a).
//
// These replace the TPU's Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/rl_pallas.py:
//
//   rl_encode_pallas (:302, + rl_split_packed) -> flrl_rl_encode
//   _decode_impl (:579; rl_decode_pallas and    -> flrl_rl_run_offsets
//   rl_decode_packed_pallas)                       + flrl_rl_expand
//
// The function is ported, not the TPU mechanism.  The Pallas kernels route
// pieces through monotone lane networks and carry a write cursor across a
// sequential grid, because a TPU core has no cheap scatter and its grid
// runs in order.  Hopper blocks run in no order but scatter freely.
//
// Encode is one launch that reads the chunk once and writes each value and
// count once: n bytes in, 2·R out, bound by bytes.  A block takes its tile
// of kEncodeTile bytes by ticket (scan.cuh), kEncodeItems bytes a thread in
// 16-byte loads, and folds it into an aggregate of three numbers: its first
// and last natural run start f and l, and a, the pieces that start in
// [f, l).  Aggregates of adjacent ranges A, B join as (A.f, B.l, A.a +
// ceil((B.f - A.l)/255) + B.a), an associative operator, so a block scan
// over its threads and a decoupled look-back over the tiles before it
// (scan.cuh's look_back with this operator) give each thread the run in
// progress at its first byte and the pieces before it.  Only the tile's
// head, the bytes before f, needs the look-back: while warp 0 waits for
// it, every thread from f on places its pieces, which the block scan alone
// fixes relative to f; the head's pieces (255 apart) follow the look-back.
// A thread's pieces are its natural run starts and at most one cap
// boundary before the first of them (its bytes are fewer than 255), so it
// visits its pieces, not its bytes.  A piece's count is the distance to the
// next natural run start, at most 255: each thread reads the natural-start
// masks of the threads after it (and of the bytes after the tile, as far
// as a piece reaches), so every count is known where its piece is.  Values
// and counts are staged in shared memory and stored as 16-byte vectors
// behind a bytewise head and tail.  The last tile writes R and the start of
// the chunk's last natural run.
//
// Decode is scan -> expand over tiles of kScanTile runs: one single-pass
// look-back scan of the tiles' sums gives each tile its output offset
// (flrl_rl_run_offsets, below).  The expand block loads its counts and
// values as 16-byte vectors and scans the counts.  A tile whose output fits
// kExpandOut bytes (short runs) writes it run by run into shared memory and
// stores it as 16-byte vectors; a larger one fills its output range by
// aligned 16-byte groups: one binary search a group for the run holding its
// first byte (among the runs of its 256 bytes), then a walk over the runs
// to the group's end (none where one run covers it), the group built in
// registers and stored as one 16-byte vector.  Only the first and last
// group of a tile, which it shares with its neighbours, are stored
// bytewise.  Zero counts take no output: the search finds the last run
// starting at or before a byte, and a zero-count run's start equals the
// next run's.  Bound by bytes: 2·R read, the output written.
#include <cuda_runtime.h>

#include "rl.cuh"
#include "scan.cuh"

namespace flrl {
namespace {

constexpr int kCap = 255;
constexpr int kEncodeWarps = kEncodeThreads / kWarp;
constexpr int kEncodeWords = kEncodeItems / 8;
// A thread's bytes fit its mask of natural starts (at most 64 bits) and are
// fewer than a piece, and the masks of kEncodeAhead threads after it reach
// 255 bytes past its last byte.
static_assert(kEncodeItems % 16 == 0 && kEncodeItems <= 64,
              "a thread takes one to four 16-byte vectors");
constexpr int kEncodeAhead = (kCap + kEncodeItems - 1) / kEncodeItems;
static_assert(kEncodeAhead <= kWarp, "one warp loads the bytes after a tile");
constexpr int32_t kNo = -0x7fffffff - 1;  // INT32_MIN: no natural run start
constexpr int64_t kNone = -0x7fffffffffffffffLL - 1;  // INT64_MIN
// A prefix status word holds a run start S >= -kStartBias and a piece
// count Q >= -2, each biased into 31 bits; an aggregate word holds a flag
// bit and f, l (tile-relative) and a in kFieldBits each.
constexpr int32_t kStartBias = 512;
constexpr int kFieldBits = 20;
constexpr uint64_t kField = (uint64_t(1) << kFieldBits) - 1;
static_assert(kEncodeTile <= (1 << kFieldBits), "aggregate fields too narrow");
// Every tile but the chunk's last is longer than a piece, so it holds a
// piece start.
static_assert(kEncodeTile > kCap, "a tile must hold a piece start");
static_assert(kExpandThreads * kExpandRuns == kScanTile,
              "an expand tile is a run_offsets tile");

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Pieces a run started at s places in [s, s + d): ceil(d / 255), d >= 0.
__device__ __forceinline__ int32_t cap_ceil(int32_t d) {
  return (d + kCap - 1) / kCap;
}

// The natural runs of a range of the chunk: its first and last natural run
// start f and l (kNo if it has none) and a, the pieces starting in [f, l).
// A prefix (the range from the chunk's start) is a Runs whose l is the run
// in progress at its end and a the pieces before l; its f is unused.
struct Runs {
  int32_t f, l, a;
};

__device__ __forceinline__ Runs no_runs() { return {kNo, kNo, 0}; }

// x followed by y.
__device__ __forceinline__ Runs join(const Runs& x, const Runs& y) {
  if (y.l == kNo) return x;
  if (x.l == kNo) return y;
  return {x.f, y.l, x.a + cap_ceil(y.f - x.l) + y.a};
}

// The prefix before the chunk: the run in progress started d0 bytes before
// x[0].  Only r = d0 mod 255 places pieces, so it stands at -r - 255 (the
// same boundaries mod 255, and below -254, never a start in the chunk),
// with a = -1 - [r > 0] so that it places no piece before x[0].
__device__ __forceinline__ Runs carry_in(int r) {
  const int32_t s = -r - kCap;
  return {s, s, -1 - (r > 0)};
}

// Pieces before position p >= prefix.l.
__device__ __forceinline__ int32_t pieces_before(const Runs& prefix,
                                                 int32_t p) {
  return prefix.a + cap_ceil(p - prefix.l);
}

__device__ __forceinline__ Runs shfl_up(const Runs& x, int d) {
  return {__shfl_up_sync(kFullMask, x.f, d), __shfl_up_sync(kFullMask, x.l, d),
          __shfl_up_sync(kFullMask, x.a, d)};
}

__device__ __forceinline__ Runs shfl_down(const Runs& x, int d) {
  return {__shfl_down_sync(kFullMask, x.f, d),
          __shfl_down_sync(kFullMask, x.l, d),
          __shfl_down_sync(kFullMask, x.a, d)};
}

__device__ __forceinline__ Runs shfl(const Runs& x, int lane) {
  return {__shfl_sync(kFullMask, x.f, lane), __shfl_sync(kFullMask, x.l, lane),
          __shfl_sync(kFullMask, x.a, lane)};
}

__device__ __forceinline__ int64_t aggregate_word(const Runs& x, int32_t b0) {
  if (x.l == kNo) return 0;
  return int64_t(1) << (3 * kFieldBits) |
         int64_t(x.f - b0) << (2 * kFieldBits) |
         int64_t(x.l - b0) << kFieldBits | x.a;
}

__device__ __forceinline__ int64_t prefix_word(const Runs& x) {
  return int64_t(x.l + kStartBias) << 31 | (x.a + 2);
}

// The look-back's operator over the encode tiles' status words.
struct RunsLookBack {
  using T = Runs;
  __device__ __forceinline__ T identity() const { return no_runs(); }
  __device__ __forceinline__ T value(uint64_t s, int64_t j) const {
    if ((s >> 62) == 2) {
      const int32_t start = static_cast<int32_t>((s >> 31) & 0x7fffffff) -
                            kStartBias;
      return {start, start, static_cast<int32_t>(s & 0x7fffffff) - 2};
    }
    if (((s >> (3 * kFieldBits)) & 1) == 0) return no_runs();
    const int32_t b0 = static_cast<int32_t>(j) * kEncodeTile;
    return {b0 + static_cast<int32_t>((s >> (2 * kFieldBits)) & kField),
            b0 + static_cast<int32_t>((s >> kFieldBits) & kField),
            static_cast<int32_t>(s & kField)};
  }
  // Lane i holds tile t-1-i: fold towards lane 0, each lane joining the
  // earlier range from lane + d in front of its own.
  __device__ __forceinline__ T fold(T x) const {
    const int lane = threadIdx.x % kWarp;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const Runs y = shfl_down(x, d);
      if (lane + d < kWarp) x = join(y, x);
    }
    return shfl(x, 0);
  }
  __device__ __forceinline__ T combine(T earlier, T later) const {
    return join(earlier, later);
  }
};

// Exclusive scan under join of one Runs a thread across the encode block;
// *total receives the tile's.  Called once a block.
__device__ Runs block_exclusive_runs(Runs v, Runs* total) {
  __shared__ Runs warp_runs[kEncodeWarps];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const Runs y = shfl_up(v, d);
    if (lane >= d) v = join(y, v);
  }
  Runs exc = shfl_up(v, 1);
  if (lane == 0) exc = no_runs();
  if (lane == kWarp - 1) warp_runs[w] = v;
  __syncthreads();
  if (w == 0) {
    Runs s = lane < kEncodeWarps ? warp_runs[lane] : no_runs();
#pragma unroll
    for (int d = 1; d < kEncodeWarps; d <<= 1) {
      const Runs y = shfl_up(s, d);
      if (lane >= d) s = join(y, s);
    }
    if (lane < kEncodeWarps) warp_runs[lane] = s;
  }
  __syncthreads();
  *total = warp_runs[kEncodeWarps - 1];
  return join(w > 0 ? warp_runs[w - 1] : no_runs(), exc);
}

// Bit k set where byte k of w differs from byte k of p.
__device__ __forceinline__ unsigned differ8(uint64_t w, uint64_t p) {
  constexpr uint64_t kLow7 = 0x7f7f7f7f7f7f7f7full;
  const uint64_t d = w ^ p;
  const uint64_t top = (((d & kLow7) + kLow7) | d) & ~kLow7;
  // bit 7 of byte i -> bit i (the products do not overlap)
  return static_cast<unsigned>(((top >> 7) * 0x0102040810204080ull) >> 56);
}

// The stages in shared memory, of the encode's values and counts and of
// the expand's output: word w of a stage lies at stage_word(w), the words
// of each 32-byte chunk permuted by the index of its 128 bytes, so that lanes
// writing 16, 32 or 64 bytes apart fall in distinct banks (the permutation
// stays inside the chunk).
__host__ __device__ constexpr int stage_word(int w) {
  return w ^ ((w >> 5) & 7);
}
__host__ __device__ constexpr int stage_byte(int i) {
  return stage_word(i >> 2) << 2 | (i & 3);
}
// Bytes a stage needs to hold logical bytes [0, n) and be read 16 at a time
// from any of them.
__host__ __device__ constexpr int stage_bytes(int n) {
  return (n + 20 + 31) / 32 * 32;
}

// Logical bytes [o0, o0 + len) of the stage st to dst, by the whole block:
// a bytewise head up to dst's first 16-byte boundary, 16-byte vectors
// (each from five stage words and four funnel shifts: o0 may have any
// alignment), a bytewise tail.
template <int kThreads>
__device__ __forceinline__ void store_stage(uint8_t* dst, const uint8_t* st,
                                            int o0, int len) {
  const int head =
      min(len, (16 - static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15)) &
                   15);
  const int body = (len - head) / 16;
  const int tail = len - head - 16 * body;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(st);
  if (int(threadIdx.x) < head)
    dst[threadIdx.x] = st[stage_byte(o0 + threadIdx.x)];
  for (int i = threadIdx.x; i < body; i += kThreads) {
    const int o = o0 + head + 16 * i;
    const int w = o >> 2;
    const unsigned sh = 8 * (o & 3);
    const uint32_t a0 = sw[stage_word(w)], a1 = sw[stage_word(w + 1)],
                   a2 = sw[stage_word(w + 2)], a3 = sw[stage_word(w + 3)],
                   a4 = sw[stage_word(w + 4)];
    reinterpret_cast<uint4*>(dst + head)[i] =
        make_uint4(__funnelshift_r(a0, a1, sh), __funnelshift_r(a1, a2, sh),
                   __funnelshift_r(a2, a3, sh), __funnelshift_r(a3, a4, sh));
  }
  if (int(threadIdx.x) < tail)
    dst[head + 16 * body + threadIdx.x] =
        st[stage_byte(o0 + head + 16 * body + threadIdx.x)];
}

struct EncodeArgs {
  const uint8_t* x;
  int32_t n;  // ≤ kEncodeMaxBytes
  int prev;
  int r;      // d0 mod 255
  uint8_t* values;
  uint8_t* counts;
  int64_t* meta;
  uint64_t* status;
  unsigned* ticket;
};

// The kEncodeItems bytes from p on, 8 a word, zeros past n; returns how
// many are real.
__device__ __forceinline__ int load_bytes(const EncodeArgs& a, int32_t p,
                                          uint64_t (&w)[kEncodeWords]) {
  const int m = a.n - p < kEncodeItems ? max(0, a.n - p) : kEncodeItems;
#pragma unroll
  for (int i = 0; i < kEncodeWords; ++i) w[i] = 0;
  if (m == kEncodeItems) {
#pragma unroll
    for (int v = 0; v < kEncodeWords / 2; ++v) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.x + p) + v);
      w[2 * v] = q.x | uint64_t(q.y) << 32;
      w[2 * v + 1] = q.z | uint64_t(q.w) << 32;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kEncodeItems; ++k)
      if (k < m) w[k / 8] |= uint64_t(a.x[p + k]) << (8 * (k % 8));
  }
  return m;
}

// A thread's mask of natural run starts, bit k for byte k.
using Mask = uint64_t;

__device__ __forceinline__ int first_bit(Mask m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}
__device__ __forceinline__ int last_bit(Mask m) {
  return 63 - __clzll(static_cast<long long>(m));
}

// Bit k set where byte k of w starts a natural run (`before`: the byte
// before byte 0); none past the m real bytes.
__device__ __forceinline__ Mask natural(const uint64_t (&w)[kEncodeWords],
                                        unsigned before, int m) {
  uint64_t nat = 0;
#pragma unroll
  for (int i = 0; i < kEncodeWords; ++i)
    nat |= uint64_t(differ8(w[i], w[i] << 8 | (i == 0 ? before
                                                      : w[i - 1] >> 56)))
           << (8 * i);
  return m < kEncodeItems ? nat & ((uint64_t(1) << m) - 1) : nat;
}

// The stage keeps room before a tile's body pieces for the pieces of its
// head (the bytes before its first natural start, at most one a 255).
constexpr int kHeadRoom = (kEncodeTile + kCap - 1) / kCap;
constexpr int kEncodeStage = stage_bytes(kHeadRoom + kEncodeTile);

// The first natural start in the kEncodeAhead masks from m (the byte
// position of m[0]'s bit 0 is p), or p + kEncodeItems·kEncodeAhead if none.
__device__ __forceinline__ int32_t next_natural(const Mask* m, int32_t p) {
  int32_t at = p + kEncodeItems * kEncodeAhead;
#pragma unroll
  for (int j = kEncodeAhead - 1; j >= 0; --j)
    if (m[j]) at = p + kEncodeItems * j + first_bit(m[j]);
  return at;
}

__global__ void __launch_bounds__(kEncodeThreads)
encode_kernel(const EncodeArgs a) {
  __shared__ __align__(16) uint8_t vstage[kEncodeStage];
  __shared__ __align__(16) uint8_t cstage[kEncodeStage];
  // natural-start masks of the tile's threads, then of the bytes after it
  __shared__ Mask natm[kEncodeThreads + kEncodeAhead];
  __shared__ Runs tile_prefix;
  __shared__ uint8_t head_value;
  const int lane = threadIdx.x % kWarp;
  const int32_t t = static_cast<int32_t>(take_tile(a.ticket));
  const int32_t n = a.n;
  const int32_t b0 = t * kEncodeTile;
  const int32_t end = n - b0 < kEncodeTile ? n : b0 + kEncodeTile;
  const int32_t p0 = b0 + static_cast<int32_t>(threadIdx.x) * kEncodeItems;

  uint64_t w[kEncodeWords];
  const int m = load_bytes(a, p0, w);
  // the byte before: the lane before's last one; lane 0 loads it
  unsigned before = __shfl_up_sync(
      kFullMask, static_cast<unsigned>(w[kEncodeWords - 1] >> 56), 1);
  if (lane == 0 && m > 0)
    before = p0 == 0 ? static_cast<unsigned>(a.prev) & 0xffu : a.x[p0 - 1];
  Mask nat = natural(w, before, m);
  if (p0 == 0 && a.prev < 0) nat |= 1u;
  natm[threadIdx.x] = nat;
  if (threadIdx.x < kEncodeAhead) {
    const int32_t pa = b0 + kEncodeTile + threadIdx.x * kEncodeItems;
    uint64_t wa[kEncodeWords];
    const int ma = load_bytes(a, pa, wa);
    natm[kEncodeThreads + threadIdx.x] =
        ma > 0 ? natural(wa, a.x[pa - 1], ma) : 0;
  }
  if (threadIdx.x == 0) head_value = static_cast<uint8_t>(w[0]);
  Runs own = no_runs();
  if (nat) own = {p0 + first_bit(nat), p0 + last_bit(nat), __popcll(nat) - 1};

  Runs total;
  const Runs exc = block_exclusive_runs(own, &total);
  if (threadIdx.x < kWarp) {
    Runs prefix = carry_in(a.r);
    if (t > 0) {
      if (lane == 0)
        publish_status(a.status + t, kStatusAggregate,
                       aggregate_word(total, b0));
      prefix = look_back(a.status, t, lane, RunsLookBack());
    }
    if (lane == 0) {
      const Runs inc = join(prefix, total);
      publish_status(a.status + t, kStatusPrefix, prefix_word(inc));
      tile_prefix = prefix;
      if (end == n) {
        a.meta[0] = pieces_before(inc, n);
        a.meta[1] = inc.l >= 0 ? inc.l : kNone;
      }
    }
  }

  // The body, from the tile's first natural start f on, while warp 0 looks
  // back: a thread after f knows its run (exc) and so its pieces and their
  // places; the one holding f places its natural starts from 0.  Piece i
  // of the body goes to stage byte kHeadRoom + i.
  if (m > 0 && (nat || exc.l != kNo)) {
    const bool known = exc.l != kNo;
    int idx = kHeadRoom + (known ? exc.a + cap_ceil(p0 - exc.l) : 0);
    Mask pieces = nat;
    if (known) {  // the run's cap boundary before the first natural start
      const int cap = (kCap - (p0 - exc.l) % kCap) % kCap;
      if (cap < m && (nat & ((Mask(1) << cap) - 1)) == 0)
        pieces |= Mask(1) << cap;
    }
    // the first natural start after the thread's bytes, if a piece reaches
    const int32_t after =
        min(next_natural(natm + threadIdx.x + 1, p0 + kEncodeItems), n);
    // A piece ends where the next begins, the thread's last at the next
    // natural start or after 255 bytes.  The pieces go word by word, so
    // that every word of w is named at compile time (w stays in registers).
    int last = -1, last_at = 0;
#pragma unroll
    for (int i = 0; i < kEncodeWords; ++i) {
      for (unsigned b = static_cast<unsigned>(pieces >> (8 * i)) & 0xffu; b;
           b &= b - 1) {
        const int k = 8 * i + __ffs(static_cast<int>(b)) - 1;
        const int at = stage_byte(idx++);
        vstage[at] = static_cast<uint8_t>(w[i] >> (8 * (k % 8)));
        if (last >= 0) cstage[last_at] = static_cast<uint8_t>(k - last);
        last = k;
        last_at = at;
      }
    }
    if (last >= 0)
      cstage[last_at] = static_cast<uint8_t>(min(kCap, after - p0 - last));
  }
  __syncthreads();

  // The head, now that the run in progress at b0 is known: h pieces of the
  // byte at b0, 255 apart, before the body.  The tile's pieces are
  // [P, P + cnt), stage bytes [kHeadRoom - h, kHeadRoom - h + cnt).
  const Runs prefix = tile_prefix;
  const int32_t P = pieces_before(prefix, b0);
  const int cnt = pieces_before(join(prefix, total), end) - P;
  const int32_t head_end = total.l != kNo ? total.f : end;
  const int h = pieces_before(prefix, head_end) - P;
  if (int(threadIdx.x) < h) {
    const int32_t s =
        b0 + (kCap - (b0 - prefix.l) % kCap) % kCap + kCap * threadIdx.x;
    const int32_t next =
        total.l != kNo
            ? total.f
            : min(next_natural(natm + kEncodeThreads, b0 + kEncodeTile), n);
    const int at = stage_byte(kHeadRoom - h + threadIdx.x);
    vstage[at] = head_value;
    cstage[at] = static_cast<uint8_t>(min(kCap, next - s));
  }
  __syncthreads();
  store_stage<kEncodeThreads>(a.values + P, vstage, kHeadRoom - h, cnt);
  store_stage<kEncodeThreads>(a.counts + P, cstage, kHeadRoom - h, cnt);
}

// The bytes k and up of a 64-bit word (all for k <= 0, none for k >= 8).
__device__ __forceinline__ uint64_t from_byte(int k) {
  return k <= 0 ? ~0ull : k >= 8 ? 0 : ~0ull << (8 * k);
}

// Sum of the four bytes of w.
__device__ __forceinline__ uint32_t byte_sum(uint32_t w) {
  w = (w & 0x00ff00ffu) + ((w >> 8) & 0x00ff00ffu);
  return (w & 0xffffu) + (w >> 16);
}

// --------------------------------------------------------------------------
// Run offsets: offs[t], the output bytes of the tiles of kScanTile runs
// before tile t, in one launch.  A block takes a group of K = kRunGroup
// consecutive tiles by ticket, a thread one 16-byte load of counts a tile,
// all K in flight before any is summed.  Each tile's sum is byte_sum and one
// warp
// reduction (__reduce_add_sync) a thread, then the block's warp sums; warp
// 0 scans the K tile totals, finds the group's carry by decoupled look-back
// over one status word a group (scan.cuh), and writes the K offsets.  Reads
// R count bytes and writes 8·(T+1) offset bytes, each once.  A tile sums to
// at most 4096·255 < 2^20, and the 62-bit status value holds any sum.
// --------------------------------------------------------------------------
struct RunOffsetsArgs {
  const uint8_t* counts;  // 16-byte aligned
  int64_t R;
  int64_t tiles;          // T
  int64_t* offs;          // offs[0..T]
  uint64_t* status;       // a word a group, then the ticket
  unsigned* ticket;
};

constexpr int kScanWarps = kScanThreads / kWarp;

__global__ void __launch_bounds__(kScanThreads)
run_offsets_kernel(const RunOffsetsArgs a) {
  constexpr int K = kRunGroup;
  __shared__ uint32_t warp_sums[K][kScanWarps];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t g = take_tile(a.ticket);
  const int64_t r0 = g * K * kScanTile + int64_t(threadIdx.x) * kScanItems;
  uint4 q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t r = r0 + k * kScanTile;
    q[k] = r + kScanItems <= a.R
               ? __ldg(reinterpret_cast<const uint4*>(a.counts + r))
               : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t r = r0 + k * kScanTile;
    uint32_t sum = byte_sum(q[k].x) + byte_sum(q[k].y) + byte_sum(q[k].z) +
                   byte_sum(q[k].w);
    if (r < a.R && r + kScanItems > a.R)  // the stream's last, cut load
      for (int64_t i = r; i < a.R; ++i) sum += a.counts[i];
    sum = __reduce_add_sync(kFullMask, sum);
    if (lane == 0) warp_sums[k][w] = sum;
  }
  __syncthreads();
  if (w != 0) return;
  int64_t total = 0;  // lane k: tile g·K + k
  if (lane < K)
    for (int i = 0; i < kScanWarps; ++i) total += warp_sums[lane][i];
  const int64_t inc = warp_inclusive_scan(total, lane);
  const int64_t group = __shfl_sync(kFullMask, inc, K - 1);
  int64_t carry = 0;
  if (g == 0) {
    if (lane == 0) publish_status(a.status, kStatusPrefix, group);
  } else {
    if (lane == 0) publish_status(a.status + g, kStatusAggregate, group);
    carry = look_back(a.status, g, lane);
    if (lane == 0) publish_status(a.status + g, kStatusPrefix, carry + group);
  }
  const int64_t t = g * K + lane;
  if (lane < K && t < a.tiles) a.offs[t] = carry + inc - total;
  if (lane == 0 && g == (a.tiles - 1) / K) a.offs[a.tiles] = carry + group;
}

// The expand stage: each run of the tile as (start << 8 | value), start
// relative to the tile (< 4096·255 < 2^20), one word of padding every 32
// so that lanes walking runs 16 apart fall in distinct banks, then a
// sentinel holding the tile's total.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }
constexpr int kExpandStage = kScanTile + kScanTile / kWarp + 2;
// first_run[b]: the run holding tile byte 256·b (a run covers at most one
// such byte), so that a group's search spans the runs of its 256 bytes.
constexpr int kExpandBlocks = (kScanTile * kCap) / 256 + 2;
// Output bytes of a tile that the expand stages in shared memory; the
// stage shares its memory with the runs and the 256-byte index.
constexpr int kExpandOut = 24576;
constexpr int kExpandGroupBytes = 4 * kExpandStage + 2 * kExpandBlocks;
constexpr int kExpandStageBytes = stage_bytes(kExpandOut + 16);
constexpr int kExpandShared = kExpandGroupBytes > kExpandStageBytes
                                  ? kExpandGroupBytes
                                  : kExpandStageBytes;

__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const uint8_t* __restrict__ counts,
              const uint8_t* __restrict__ values, int64_t R,
              const int64_t* __restrict__ offs, int64_t n,
              uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t smem[kExpandShared];
  int32_t* runs = reinterpret_cast<int32_t*>(smem);
  uint16_t* first_run = reinterpret_cast<uint16_t*>(smem + 4 * kExpandStage);
  uint8_t* ostage = smem;
  const int64_t base = offs[blockIdx.x];
  const int i0 = threadIdx.x * kExpandRuns;
  const int64_t r0 = int64_t(blockIdx.x) * kScanTile + i0;
  uint64_t c0 = 0, c1 = 0, v0 = 0, v1 = 0;  // counts, values; 0: the first 8
  if (r0 + kExpandRuns <= R) {
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(counts + r0));
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(values + r0));
    c0 = c.x | uint64_t(c.y) << 32;
    c1 = c.z | uint64_t(c.w) << 32;
    v0 = v.x | uint64_t(v.y) << 32;
    v1 = v.z | uint64_t(v.w) << 32;
  } else {
    for (int k = 0; r0 + k < R; ++k) {
      if (k < 8) {
        c0 |= uint64_t(counts[r0 + k]) << (8 * k);
        v0 |= uint64_t(values[r0 + k]) << (8 * k);
      } else {
        c1 |= uint64_t(counts[r0 + k]) << (8 * (k - 8));
        v1 |= uint64_t(values[r0 + k]) << (8 * (k - 8));
      }
    }
  }
  const uint32_t sum = byte_sum(static_cast<uint32_t>(c0)) +
                       byte_sum(static_cast<uint32_t>(c0 >> 32)) +
                       byte_sum(static_cast<uint32_t>(c1)) +
                       byte_sum(static_cast<uint32_t>(c1 >> 32));
  int64_t total64;
  int32_t s = static_cast<int32_t>(
      block_exclusive_scan<kExpandThreads>(int64_t(sum), &total64));
  const int32_t total = static_cast<int32_t>(total64);
  // A tile whose output fits the stage writes it run by run into shared
  // memory and stores it as 16-byte vectors; a larger one (long runs)
  // fills aligned groups from the staged runs.
  const bool small = total <= kExpandOut;
  const int phase = static_cast<int>(base & 15);
#pragma unroll
  for (int k = 0; k < kExpandRuns; ++k) {
    const int c = static_cast<int>((k < 8 ? c0 : c1) >> (8 * (k % 8))) & 0xff;
    const int v = static_cast<int>((k < 8 ? v0 : v1) >> (8 * (k % 8))) & 0xff;
    if (small) {
      for (int j = 0; j < c; ++j)
        ostage[stage_byte(phase + s + j)] = static_cast<uint8_t>(v);
    } else {
      runs[padded(i0 + k)] = s << 8 | v;
      const int32_t b = (s + 255) >> 8;  // the first 256-byte mark >= s
      if (b * 256 < s + c) first_run[b] = static_cast<uint16_t>(i0 + k);
    }
    s += c;
  }
  if (!small && threadIdx.x == 0) runs[padded(kScanTile)] = total << 8;
  __syncthreads();

  const int64_t end = imin(base + total, n);
  if (small) {
    if (end > base)
      store_stage<kExpandThreads>(out + base, ostage, phase,
                                   static_cast<int>(end - base));
    return;
  }
  // Aligned 16-byte groups of the output that hold bytes of this tile.
  for (int64_t g = base / 16 + threadIdx.x; g * 16 < end;
       g += kExpandThreads) {
    const int32_t q = static_cast<int32_t>(g * 16 - base);  // > -16
    const int k0 = q < 0 ? -q : 0;
    const int k1 = static_cast<int>(imin(16, end - g * 16));
    const int32_t first = q + k0;
    const int32_t b = first >> 8;
    // runs[lo] starts at or before `first`, runs[hi] after it
    int lo = first_run[b];
    int hi = (b + 1) * 256 < total ? first_run[b + 1] + 1 : kScanTile;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if ((runs[padded(mid)] >> 8) <= first) lo = mid; else hi = mid;
    }
    // The group's bytes from k0 on take the value of run lo; at each later
    // run start s below k1 the bytes from s on change to the new run's
    // value (an xor of the two fills masked to bytes >= s).
    uint64_t fill = uint64_t(runs[padded(lo)] & 0xff) * 0x0101010101010101ull;
    uint64_t w0 = fill & from_byte(k0), w1 = fill & from_byte(k0 - 8);
    for (;;) {
      const int32_t next = runs[padded(++lo)];
      const int k = (next >> 8) - q;
      if (k >= k1) break;
      const uint64_t f = uint64_t(next & 0xff) * 0x0101010101010101ull;
      w0 ^= (f ^ fill) & from_byte(k);
      w1 ^= (f ^ fill) & from_byte(k - 8);
      fill = f;
    }
    uint8_t* dst = out + g * 16;
    if (k0 == 0 && k1 == 16) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(static_cast<uint32_t>(w0), static_cast<uint32_t>(w0 >> 32),
                     static_cast<uint32_t>(w1),
                     static_cast<uint32_t>(w1 >> 32));
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k >= k0 && k < k1)
          dst[k] = static_cast<uint8_t>((k < 8 ? w0 >> (8 * k)
                                               : w1 >> (8 * (k - 8))) & 0xffu);
    }
  }
}

int64_t tiles_of(int64_t items) { return (items + kScanTile - 1) / kScanTile; }

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_rl_encode(const void* x, int64_t n, int prev, int64_t d0,
                            void* values, void* counts, void* meta,
                            int device, void* stream) {
  if (n < 0 || n > kEncodeMaxBytes || prev < -1 || prev > 255 || d0 < 0 ||
      misaligned(x) || misaligned(values) || misaligned(counts))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t tiles = (n + kEncodeTile - 1) / kEncodeTile;
  int64_t* m = static_cast<int64_t*>(meta);
  uint64_t* status = reinterpret_cast<uint64_t*>(m + 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the status words and the ticket start at zero on this stream
  err = cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return err;
  const EncodeArgs a{static_cast<const uint8_t*>(x),
                     static_cast<int32_t>(n),
                     prev,
                     static_cast<int>(d0 % kCap),
                     static_cast<uint8_t*>(values),
                     static_cast<uint8_t*>(counts),
                     m,
                     status,
                     reinterpret_cast<unsigned*>(status + tiles)};
  encode_kernel<<<static_cast<unsigned>(tiles), kEncodeThreads, 0, s>>>(a);
  return cudaGetLastError();
}

FLRL_API int flrl_rl_run_offsets(const void* counts, int64_t R, void* offs,
                                 int device, void* stream) {
  if (R < 0 || misaligned(counts)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(R);
  int64_t* o = static_cast<int64_t*>(offs);
  if (tiles == 0) return cudaMemsetAsync(o, 0, sizeof(int64_t), s);
  const int64_t groups = (tiles + kRunGroup - 1) / kRunGroup;
  uint64_t* status = reinterpret_cast<uint64_t*>(o + tiles + 1);
  // the status words and the ticket start at zero on this stream
  err = cudaMemsetAsync(status, 0, (groups + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return err;
  const RunOffsetsArgs a{static_cast<const uint8_t*>(counts), R, tiles, o,
                         status, reinterpret_cast<unsigned*>(status + groups)};
  run_offsets_kernel<<<static_cast<unsigned>(groups), kScanThreads, 0, s>>>(
      a);
  return cudaGetLastError();
}

FLRL_API int flrl_rl_expand(const void* counts, const void* values,
                            int64_t R, const void* offs, int64_t n,
                            void* out, int device, void* stream) {
  if (R < 0 || n < 0 || misaligned(counts) || misaligned(values) ||
      misaligned(out))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0 || n == 0) return cudaSuccess;
  expand_kernel<<<static_cast<unsigned>(tiles_of(R)), kExpandThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(counts), static_cast<const uint8_t*>(values),
      R, static_cast<const int64_t*>(offs), n, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
