// Dense FL codec kernels for Hopper (sm_90a): shared constants, frame
// geometry and the plain C interface that ops/_build.py loads with ctypes.
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 on success) as an int.  Pointers and the
// stream are passed as void*, sizes as int64_t.
#pragma once

#include <cstdint>

#include "scan.cuh"

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

namespace flrl {

// Offsets: a block scans a tile of 256 threads × 16 frames, one 16-byte
// load of widths a thread.  ops/fl_dense_cuda.py's OFFSETS_TILE must match.
constexpr int kOffsetsThreads = 256;
constexpr int kOffsetsItems = 16;
constexpr int64_t kOffsetsTile = int64_t(kOffsetsThreads) * kOffsetsItems;

// Widths, pack, unpack and the field encode (fl_fields.cu): 8 warps a
// block, 8 blocks an SM (32 registers a thread), a grid of the blocks the
// card holds at once (lane_io.cuh's resident_grid).  A warp span is
// 32 lanes × U stream bytes (U = 16, or 8 where L % 16 != 0).  The widths
// take kWidthsSpans spans a warp step, loaded before any is reduced.  The
// pack and unpack stage a span's payload (at most 32·U bytes) behind up to
// 15 bytes that align it to its 16-byte phase in device memory; the
// unpack's stage has room for the 20-byte aligned reads of its last lane.
// Positions are 32-bit, so a launch takes at most 2^31 bytes.
constexpr int kDenseWarps = 8;
constexpr int kDenseThreads = kDenseWarps * kWarp;
constexpr int kDenseBlocksPerSm = 8;
constexpr int kWidthsSpans = 4;
constexpr int kPackStage = kWarp * 16 + 16;
constexpr int kUnpackStage = kWarp * 16 + 64;
constexpr int64_t kDenseMaxBytes = int64_t(1) << 31;

// Number of real bytes in frame f of an n-byte stream cut into L-byte frames.
__host__ __device__ inline int64_t frame_count(int64_t f, int64_t n,
                                               int64_t L) {
  const int64_t rest = n - f * L;
  return rest < L ? rest : L;
}

// Payload bytes of a frame of `count` values at width b: ceil(count·b/8).
__host__ __device__ inline int64_t frame_bytes(int b, int64_t count) {
  return (count * b + 7) / 8;
}

}  // namespace flrl

// Per-frame width max(1, bitlen(max byte)) into bits[F] of the n ≤
// kDenseMaxBytes bytes at `data`; `data` and `bits` are 16-byte aligned.
// fb_expect != 0 sets *flag to 1 when any frame's width differs from it
// (uniform mode).  The caller zeroes *flag before the launch; the kernel
// only ever sets it.
FLRL_API int flrl_frame_widths(const void* data, int64_t n,
                               int64_t frame_length, int fb_expect,
                               void* bits, void* flag, int device,
                               void* stream);

// offs[0..F] = exclusive scan of ceil(count_f·bits[f]/8); offs[F] is the
// payload size.  `offs` is 16-byte aligned.  `scratch` holds
// ceil(F / kOffsetsTile) + 1 int64 words (the tiles' status words, then
// the ticket); the launcher clears it on `stream` before the kernel runs.
FLRL_API int flrl_frame_offsets(const void* bits, int64_t n,
                                int64_t frame_length, void* offs,
                                void* scratch, int device, void* stream);

// Pack n ≤ kDenseMaxBytes bytes (`data` 16-byte aligned) into the container
// payload.
// General mode: widths `bits` and offsets `offs` (fb = 0).  Uniform mode:
// fb in 1..8, bits and offs null, frame f at the static offset f·L·fb/8.
FLRL_API int flrl_pack(const void* data, int64_t n, int64_t frame_length,
                       const void* bits, const void* offs, int fb,
                       void* values, int device, void* stream);

// Inverse of flrl_pack: payload `values` (values_size bytes, any alignment)
// → n ≤ kDenseMaxBytes bytes at `out` (16-byte aligned); modes as there.
// No byte at or past values[values_size] is read: payload bytes the frames
// need beyond it decode as zeros.
FLRL_API int flrl_unpack(const void* values, int64_t values_size, int64_t n,
                         int64_t frame_length, const void* bits,
                         const void* offs, int fb, void* out, int device,
                         void* stream);

FLRL_API const char* flrl_cuda_error_string(int code);
