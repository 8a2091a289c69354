// Flat-tile primitives for Hopper (sm_90a): the plain C interface that
// ops/_build.py loads with ctypes.
//
// A tile is rows × 128 int32 in flat row-major order, N = rows·128 elements,
// rows a power of two from kTileMinRows to kTileMaxRows (so a tile holds at
// most 2^15 elements, the routing networks' cap).  One launch applies one op
// to `tiles` independent tiles of `x` and writes `out` (same shape, not
// aliasing `x`).  On the flat index p of a tile:
//
//   kTileShiftDown     y[p] = x[p + m] where 0 <= p + m < N, else fill
//   kTileShiftUp       y[p] = x[p - m] where 0 <= p - m < N, else fill
//   kTileShiftDownDyn  as kTileShiftDown, m the int32 at m_dev (on the card)
//   kTileShiftUpDyn    as kTileShiftUp, m the int32 at m_dev
//   kTilePrefixMax     y[p] = max(fill, x[0..p])
//   kTilePrefixSum     y[p] = x[0] + ... + x[p], wrapping mod 2^32
//   kTileSuffixMin     y[p] = min(fill, x[p..N-1])
//   kTileCompact       each live word w (w < 0) with r = (w >> 16) & mask,
//                      mask = 2^nbits - 1, is written to p - r as
//                      w - r·2^16; every other slot is 0; a word whose
//                      p - r < 0 is dropped
//   kTileExpand        as kTileCompact, to p + r, dropped where p + r >= N
//
// `aux` is m for the static shifts and nbits (0..15) for the routes, else
// unused; `m_dev` is read only by the dynamic shifts.  The routes assume
// their input domain (ops/lanes.py in the JAX package): dead words are 0
// and no two live words land on one slot, which monotone distances
// guarantee; outside it the result is unspecified.
//
// The launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 on success) as an int.  `x` and `out` must
// be 16-byte aligned.
#pragma once

#include <cstdint>

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

// ops/lanes_cuda.py's OPS names these in this order (a test reads them).
enum FlrlTileOp {
  kTileShiftDown = 0,
  kTileShiftUp = 1,
  kTileShiftDownDyn = 2,
  kTileShiftUpDyn = 3,
  kTilePrefixMax = 4,
  kTilePrefixSum = 5,
  kTileSuffixMin = 6,
  kTileCompact = 7,
  kTileExpand = 8,
};

constexpr int kTileLanes = 128;
constexpr int kTileMinRows = 8;
constexpr int kTileMaxRows = 256;

FLRL_API int flrl_tile_op(int op, const void* x, int64_t aux, int fill,
                          const void* m_dev, void* out, int rows,
                          int64_t tiles, int device, void* stream);
