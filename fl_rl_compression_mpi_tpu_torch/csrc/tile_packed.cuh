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
// out are 16-byte aligned, bits 4-byte aligned.  `scratch` is int64[tiles
// + 1] for the encodes and int32[tiles] for the decode, which each launcher
// clears on the stream before its kernels run where it needs it cleared.
//
// flrl_tile_packed_encode takes one of two routes, by R alone
// (tile_packed_route below; the wrapper asks flrl_tile_packed_route which
// one a call took):
//
//   cluster  each tile's words are read from device memory once, by a
//            thread-block cluster that holds the tile in its blocks' shared
//            memory; R up to kClusterMax·kClusterMaxRows (6,144;
//            cluster_fits below)
//   2pass    any R (flrl_tile_packed_encode_2pass): the widths pass, the
//            offsets scan (cursor layout) and the pack, which reads the
//            words a second time
//
// Clusters of more than 8 blocks (R > 1,024) are a size the card allows but
// does not promise: each needs that many SMs free in one GPC, which an H100
// SXM's GPCs hold.  Where the card cannot hold one such cluster, the
// launcher refuses with cudaErrorLaunchOutOfResources before any launch.
#pragma once

#include <cstdint>

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

// The cluster route's geometry, fixed from one sweep on an H100
// (chip_tile_packed.py; PERF.md §6): threads a block, and bytes of words a
// block aims to hold.  The sweep builds this file with other values, from
// a pre-included file that defines FLRL_TP_GEOMETRY as `threads, bytes`;
// nothing else sets it.
#ifndef FLRL_TP_GEOMETRY
#define FLRL_TP_GEOMETRY 256, 65536
#endif

constexpr int kPackedLanes = 128;
constexpr int kPackedFrames = 4;        // frames a row, 32 words each
constexpr int kRowBytes = kPackedLanes * 4;

constexpr int kClusterGeometry[] = {FLRL_TP_GEOMETRY};
// Threads a block of the cluster route.
constexpr int kClusterThreads = kClusterGeometry[0];
// Bytes of words a block of the cluster route aims to hold: a tile of more
// is split over the fewest blocks (a power of two, at most kClusterMax)
// that bring each block's share to at most this, and a smaller tile is
// taken whole, with as many tiles (at most kClusterTiles) as fit.
constexpr int kClusterBlockBytes = kClusterGeometry[1];
// Blocks a cluster at most (above 8 a size the card allows but does not
// promise: cudaFuncAttributeNonPortableClusterSizeAllowed).
constexpr int kClusterMax = 16;
constexpr int kClusterTiles = 16;                 // tiles a one-block unit
// Rows a block of the cluster route may hold: 198 KiB of words and widths,
// within the 227 KB of shared memory a block can take.
constexpr int kClusterMaxRows = 384;

// Blocks of the cluster holding a tile of R rows, and tiles a cluster
// takes (more than one only where a tile fits one block).
constexpr int cluster_blocks(int R) {
  int c = 1;
  while (c < kClusterMax && int64_t(R) * kRowBytes > int64_t(c) *
                                kClusterBlockBytes && c * 2 <= R / 8)
    c *= 2;
  return c;
}
constexpr int cluster_tiles(int R) {
  const int64_t fit = kClusterBlockBytes / (int64_t(R) * kRowBytes);
  return cluster_blocks(R) > 1 ? 1
         : fit > kClusterTiles ? kClusterTiles
                               : static_cast<int>(fit);
}
// Whether the cluster route takes tiles of R rows: each block's share of
// its tiles' classes (R / 8 of them a tile, 8 rows each) fits
// kClusterMaxRows.
constexpr bool cluster_fits(int R) {
  const int q = R / 8, c = cluster_blocks(R);
  return R > 0 && R % 8 == 0 &&
         int64_t(cluster_tiles(R)) * 8 * ((q + c - 1) / c) <= kClusterMaxRows;
}
// The encode's route for tiles of R rows: 1 the cluster route, 0 the
// two-pass one.
constexpr int tile_packed_route(int R) { return cluster_fits(R) ? 1 : 0; }

// tile_packed_route(R), for the wrapper, which counts each launch under
// its route.
FLRL_API int flrl_tile_packed_route(int R);

// bits, packed (and offs[tiles + 1] when offs is not null: the cursor
// layout) of the words, by the route tile_packed_route(R) names.
FLRL_API int flrl_tile_packed_encode(const void* words, int64_t nrows, int R,
                                     void* bits, void* packed, void* offs,
                                     void* scratch, int device, void* stream);

// The same outputs by the two-pass route, for any R (exported so that a
// check can reach that route where flrl_tile_packed_encode takes the
// cluster one).
FLRL_API int flrl_tile_packed_encode_2pass(const void* words, int64_t nrows,
                                           int R, void* bits, void* packed,
                                           void* offs, void* scratch,
                                           int device, void* stream);

// out[nrows][128], the words of bits and packed, the tiles' rows at offs[t]
// (cursor) or at t·R (sparse: offs is null).
FLRL_API int flrl_tile_packed_decode(const void* bits, const void* packed,
                                     const void* offs, int64_t nrows, int R,
                                     void* out, void* key, int device,
                                     void* stream);
