// FL field-form kernels for Hopper (sm_90a): the pack-2 layout and the plain
// C interface that ops/_build.py loads with ctypes.
//
// Field form (fl_rl_compression_mpi_tpu/ops/fl_jax.py:20-25): the input is
// little-endian u32 words, wpf = L/4 words a frame.  Word q of a frame of
// width b becomes the 4·b-bit field e0 | e1<<b | e2<<2b | e3<<3b of its four
// bytes; the host folds a frame's fields into its payload bytes.
//
// Launchers run on the stream they are given, allocate nothing, and return
// cudaGetLastError() (0 on success) as an int.
#pragma once

#include <cstdint>

#include "fl_dense.cuh"

namespace flrl {

// Field encode: a base-mode warp step is kFieldsStep input bytes, 32 a
// lane: 2 warp spans of 16-byte lanes or 4 of 8-byte lanes (a lane's span
// ORs share one word).  A warp's stage holds a step's widths (base mode) or
// a packed row's two input rows' (pack-2, at most 64 each).
constexpr int kFieldsStep = 1024;
constexpr int kFieldsStage = 4 * kWarp;
static_assert(kFieldsStep == 32 * kWarp, "32 bytes a lane");
static_assert(kFieldsStep / 8 <= kFieldsStage, "a step's widths");
// Words of a row of the pack-2 layout.
constexpr int kPackLanes = 128;

// Pack-2 layout (ops/fl_pallas.py:291-296, csrc/flrlio.cpp:110-124): within
// each tile of tile_r rows of 128 words, packed u32 word r holds the field of
// row r in its low 16 bits and the field of row r + tile_r/2 in its high 16
// bits.  Both kernels go by packed row: one multiply-high a warp step finds
// its tile.
//
// The pack-2 decode takes kDecodeRows packed rows a warp step, a lane one
// 16-byte load of each.  One was 1.2–5.2 % faster than two a launch on an
// H100 at L = 8, 128 and 512 (two spilled at 32 registers; PERF.md §6).
constexpr int kDecodeRows = 1;

}  // namespace flrl

// Field encode of nw ≤ kDenseMaxBytes / 4 words (a frame multiple; bytes
// past the stream's end must be zero: there is no tail mask).  Writes the
// width of each of the nw/wpf frames to bits.  tile_r == 0: base mode, u32
// fields to out[nw].  tile_r > 0: pack-2 mode, the low 16 bits of each field
// to its u16 slot of out[nw/2 u32] (nw a multiple of tile_r·128,
// tile_r % 16 == 0, 128 % wpf == 0); valid only where every width is ≤ 4.
// words, bits and out are 16-byte aligned.
FLRL_API int flrl_fields_encode(const void* words, int64_t nw,
                                int64_t frame_length, int tile_r, void* bits,
                                void* out, int device, void* stream);

// Inverse: nw ≤ kDenseMaxBytes / 4 output words (a frame multiple) from
// the fields `in` (u32[nw], tile_r == 0) or the pack-2 slots of `in`
// (tile_r > 0: whole tiles of tile_r·128 words, at most 2^29 words a tile)
// and the widths bits[nw/wpf] (each 1..8).  No width at or past
// bits[nw/wpf] is read and no word at or past out[nw] is written.  in and
// out are 16-byte aligned.
FLRL_API int flrl_fields_decode(const void* in, const void* bits, int64_t nw,
                                int64_t frame_length, int tile_r, void* out,
                                int device, void* stream);
