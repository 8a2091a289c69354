// RL codec kernels for Hopper (sm_90a): the plain C interface that
// ops/_build.py loads with ctypes.
//
// Conventions as in fl_dense.cuh: every launcher runs on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (0 on success).
// Encode tiles are kEncodeTile (16384) bytes, decode tiles kScanTile (4096)
// runs; ops/rl_cuda.py's ENCODE_TILE and TILE must match.
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

namespace flrl {

// Encode: a block takes a tile of 256 threads × 64 bytes, four 16-byte loads
// a thread.  Positions are 32-bit, so a launch takes at most 2^30 bytes
// (the chunk walk's 1 GiB chunk).
constexpr int kEncodeThreads = 256;
constexpr int kEncodeItems = 64;
constexpr int kEncodeTile = kEncodeThreads * kEncodeItems;
constexpr int64_t kEncodeMaxBytes = int64_t(1) << 30;

// Expand: a block takes a tile of 256 threads × 16 runs (kScanTile), one
// 16-byte load of counts and one of values a thread.
constexpr int kExpandThreads = 256;
constexpr int kExpandRuns = 16;

// Run offsets: a block takes a group of kRunGroup tiles of kScanTile runs,
// one 16-byte load of counts a tile in flight a thread.  ops/rl_cuda.py's
// RUN_GROUP must match.
constexpr int kRunGroup = 16;

}  // namespace flrl

// One launch encodes the chunk: values[R] (each piece's byte) and
// counts[R] (each piece's length; the last measured to the chunk's end),
// meta[0] = R and meta[1] = the start of the natural run the chunk's last
// byte belongs to, or INT64_MIN when that run began before the chunk.
// x, values and counts are 16-byte aligned and hold n ≤ kEncodeMaxBytes
// bytes (R ≤ n); meta holds 2 + ceil(n / kEncodeTile) + 1 int64 words, the
// last ones the tiles' status words and the ticket, which the launcher
// clears on `stream` before the kernel runs.  n = 0 launches nothing.
FLRL_API int flrl_rl_encode(const void* x, int64_t n, int prev, int64_t d0,
                            void* values, void* counts, void* meta,
                            int device, void* stream);

// The same pieces of a whole stream x[n] (no carry: prev -1, d0 0), each
// stored as one int32 value | (start & 0xFF) << 8, start its position in x:
// out[0..R), out holding n int32 (R <= n), meta[0] = R.  The counts follow
// from consecutive starts mod 256 (every piece is at most 255 bytes), the
// last one from n.  Scratch, alignment and limits as flrl_rl_encode's; n = 0
// launches nothing.
FLRL_API int flrl_rl_encode_starts(const void* x, int64_t n, void* out,
                                   void* meta, int device, void* stream);

// offs[0..T], T = ceil(R / 4096): exclusive scan of the output bytes of
// each tile of runs; offs[T] = sum of counts.  One launch, a block a group
// of kRunGroup tiles.  counts is 16-byte aligned; offs holds
// T + 1 + ceil(T / kRunGroup) + 1 int64 words, the last ones the groups'
// status words and the ticket, which the launcher clears on `stream` before
// the kernel runs.
FLRL_API int flrl_rl_run_offsets(const void* counts, int64_t R, void* offs,
                                 int device, void* stream);

// out[n] = values[j] repeated counts[j] times, j = 0..R-1 (n = offs[T]).
// counts, values and out are 16-byte aligned.
FLRL_API int flrl_rl_expand(const void* counts, const void* values,
                            int64_t R, const void* offs, int64_t n,
                            void* out, int device, void* stream);
