// RL codec kernels for Hopper (sm_90a): the plain C interface that
// ops/_build.py loads with ctypes.
//
// Conventions as in fl_dense.cuh: every launcher runs on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (0 on success).
// Positions and offsets are int64.  Encode tiles are kScanTile (4096)
// bytes, decode tiles kScanTile runs; ops/rl_cuda.py's TILE must match.
//
// Encode of a chunk x[n] with its carry-in: `prev` is the previous chunk's
// last byte (-1 for none) and `d0` the distance of x[0] from the start of
// the natural run it continues (0 when there is no previous chunk).  A
// byte that differs from the one before it starts a natural run; position
// i starts a piece when its distance from its natural run start is a
// multiple of 255.
#pragma once

#include <cstdint>

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

// summ[T][3], T = ceil(n / 4096): per tile, its first natural run start
// (the tile's end if none), its last natural run start (INT64_MIN if none)
// and the number of pieces at or after its first natural run start.
FLRL_API int flrl_rl_piece_tiles(const void* x, int64_t n, int prev,
                                 void* summ, int device, void* stream);

// From summ: tstart[0..T], the start of the natural run in progress at
// each tile's first byte (tstart[T]: that of the chunk's last byte, the
// carry-out), and offs[0..T], the exclusive scan of pieces per tile
// (offs[T] = R, the chunk's piece count).
FLRL_API int flrl_rl_piece_offsets(const void* summ, int64_t n, int64_t d0,
                                   void* tstart, void* offs, int device,
                                   void* stream);

// values[R] and starts8[R] (each piece's start position, low byte).
FLRL_API int flrl_rl_compact(const void* x, int64_t n, int prev,
                             const void* tstart, const void* offs,
                             void* values, void* starts8, int device,
                             void* stream);

// counts[j] = starts8[j+1] - starts8[j] (mod 256) for j < R-1, and
// counts[R-1] = n - start of the last piece (mod 256): the chunk's last
// piece measured to the chunk's end.  Exact: every piece is 1..255 long.
FLRL_API int flrl_rl_counts(const void* starts8, int64_t R, int64_t n,
                            void* counts, int device, void* stream);

// offs[0..T], T = ceil(R / 4096): exclusive scan of the output bytes of
// each tile of runs; offs[T] = sum of counts.
FLRL_API int flrl_rl_run_offsets(const void* counts, int64_t R, void* offs,
                                 int device, void* stream);

// out[n] = values[j] repeated counts[j] times, j = 0..R-1 (n = offs[T]).
FLRL_API int flrl_rl_expand(const void* counts, const void* values,
                            int64_t R, const void* offs, int64_t n,
                            void* out, int device, void* stream);
