// The tile-packed field codec for Hopper (sm_90a): the plain C interface
// that ops/_build.py loads with ctypes.
//
// Words are u32 in rows of kPackedLanes (128), four frames of 32 words a
// row; the stream is nrows rows cut into tiles of R rows (R % 8 == 0,
// nrows % R == 0).  A frame's width b is max(1, bitlen(OR of its bytes)),
// stored as one byte a frame in bits[nrows][4], and each word
// e0 | e1<<8 | e2<<16 | e3<<24 becomes its 4·b-bit field
// e0 | e1<<b | e2<<2b | e3<<3b.  A tile whose widest frame has width bt
// packs 2^d fields a word, d = 3, 2, 1, 0 for bt <= 1, 2, 4, else: its R>>d
// packed rows hold, at packed row r and lane l,
//
//   OR over k < 2^d of  field[r + off(k)][l] << shift(k),
//   off(k) = sum over s < d of k_s·(R >> (s+1)),
//   shift(k) = sum over s < d of k_s·(16 >> s),
//
// k_s being bit s of k (the static halvings x[:m/2] | x[m/2:] << (16>>s)).
// Two layouts of the packed rows:
//
//   cursor  tile t's rows start at row offs[t], offs[0] = 0 and
//           offs[t+1] = offs[t] + (R >> d_t); offs[tiles] is the total
//   sparse  tile t's rows start at row t·R; there is no offs
//
// Rows of `packed` outside a tile's rows are left unwritten.  Each launcher
// runs its kernels on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 on success) as an int.  words, packed and
// out are 16-byte aligned, bits 4-byte aligned; `key` is int32[tiles] of
// scratch, which the launcher clears on the stream before its kernels run.
#pragma once

#include <cstdint>

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

constexpr int kPackedLanes = 128;
constexpr int kPackedFrames = 4;        // frames a row, 32 words each

// bits, packed (and offs[tiles + 1] when offs is not null: the cursor
// layout) of the words.
FLRL_API int flrl_tile_packed_encode(const void* words, int64_t nrows, int R,
                                     void* bits, void* packed, void* offs,
                                     void* key, int device, void* stream);

// out[nrows][128], the words of bits and packed, the tiles' rows at offs[t]
// (cursor) or at t·R (sparse: offs is null).
FLRL_API int flrl_tile_packed_decode(const void* bits, const void* packed,
                                     const void* offs, int64_t nrows, int R,
                                     void* out, void* key, int device,
                                     void* stream);
