// Dense FL codec kernels for Hopper (sm_90a).
//
// These replace the TPU's dense-on-device Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/fl_dense_pallas.py:
//
//   fl_encode_dense_pallas          -> flrl_frame_widths + flrl_frame_offsets
//                                      + flrl_pack (general mode)
//   fl_encode_dense_uniform_pallas  -> flrl_frame_widths (fb_expect flag)
//                                      + flrl_pack (uniform mode)
//   fl_decode_dense_pallas          -> flrl_frame_offsets + flrl_unpack
//   fl_decode_dense_uniform_pallas  -> flrl_unpack (uniform mode)
//
// The function is ported, not the TPU mechanism.  The Pallas kernels route
// words through monotone lane networks because a TPU core has no cheap
// per-lane byte addressing.  Here a full frame of L bytes at width b packs to
// exactly L·b/8 bytes, so frames never share an output byte and one warp owns
// one frame: no atomics on the payload, no routing.  Frame placement is an
// exclusive scan of the per-frame payload sizes; in uniform mode it is the
// closed form f·L·fb/8 and the scan is skipped (the point of the TPU's
// single-width kernels).
//
// All four launches are memory-bound: encode reads n bytes and writes about
// n·b̄/8 (b̄ the mean width), decode the reverse.  Loads are 8 bytes a lane
// where a frame is whole, neighbouring lanes on neighbouring addresses;
// stores are one byte (pack) or four bytes (unpack) a lane, contiguous
// across the warp.
#include <cuda_runtime.h>

#include "fl_dense.cuh"
#include "scan.cuh"

namespace flrl {
namespace {

__device__ __forceinline__ int64_t global_warp() {
  return (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
}

__device__ __forceinline__ int64_t warp_stride() {
  return int64_t(gridDim.x) * blockDim.x / kWarp;
}

// --------------------------------------------------------------------------
// Frame widths.  Replaces the width half of fl_dense_pallas._encode_kernel
// and _uniform_enc_kernel (the f32-exponent / MXU width tricks there exist
// because the TPU's VPU lacks a cheap clz).  Reads n bytes, writes n/L: a
// pure read stream, so each lane ORs 8-byte words and the warp reduces with
// one __reduce_or_sync.  bitlen(OR of bytes) == bitlen(max byte).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kFrameThreads)
frame_widths_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t L,
                    int64_t frames, int fb_expect, uint8_t* __restrict__ bits,
                    int* __restrict__ flag) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t f = global_warp(); f < frames; f += warp_stride()) {
    const int64_t count = frame_count(f, n, L);
    const uint8_t* src = data + f * L;
    uint64_t acc = 0;
    const int64_t words = count / 8;
    const uint64_t* src8 = reinterpret_cast<const uint64_t*>(src);
    for (int64_t i = lane; i < words; i += kWarp) acc |= __ldg(src8 + i);
    for (int64_t i = words * 8 + lane; i < count; i += kWarp) acc |= src[i];
    unsigned m = static_cast<unsigned>(acc | (acc >> 32));
    m |= m >> 16;
    m |= m >> 8;
    m = __reduce_or_sync(kFullMask, m & 0xffu);
    const int b = max(1, 32 - __clz(static_cast<int>(m)));
    if (lane == 0) {
      bits[f] = static_cast<uint8_t>(b);
      // Read before the atomic: a mixed stream would otherwise send one
      // atomic per frame to the same address.
      if (fb_expect != 0 && b != fb_expect &&
          *reinterpret_cast<volatile int*>(flag) == 0)
        atomicOr(flag, 1);
    }
  }
}

// --------------------------------------------------------------------------
// Exclusive scan of per-frame payload bytes.  Replaces the in-kernel
// placement of fl_dense_pallas._encode_kernel (the sequential-grid cursor
// and its per-tile word offsets `woffs`) and the host offset scan that feeds
// _decode_kernel.  The TPU grid runs in order and can carry a cursor; Hopper
// blocks run in no order, so placement is a two-level scan: each block scans
// a tile of 4096 frames and writes its total (scan_tiles), one block scans
// the tile totals (scan_carries), and every frame adds its tile's carry
// (add_carries); the shared pieces live in scan.cuh.  Reads F width bytes,
// writes 8·F offset bytes twice: small beside the payload passes.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const uint8_t* __restrict__ bits, int64_t n, int64_t L,
                  int64_t frames, int64_t* __restrict__ offs,
                  int64_t* __restrict__ carries) {
  const int64_t f0 = int64_t(blockIdx.x) * kScanTile +
                     int64_t(threadIdx.x) * kScanItems;
  int64_t x[kScanItems];
  int64_t sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t f = f0 + i;
    x[i] = f < frames ? frame_bytes(bits[f], frame_count(f, n, L)) : 0;
    sum += x[i];
  }
  int64_t total;
  int64_t pre = block_exclusive_scan(sum, &total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (f0 + i < frames) offs[f0 + i] = pre;
    pre += x[i];
  }
  if (threadIdx.x == 0) carries[blockIdx.x] = total;
}

// --------------------------------------------------------------------------
// Pack.  Replaces the spread + group-pack + routing emit of
// fl_dense_pallas._encode_kernel (general mode) and _uniform_enc_kernel /
// _uniform_enc_kernel_mr (uniform mode).  Reads n bytes, writes the payload.
// A warp stages 256 input bytes of its frame in shared memory with one
// 8-byte load a lane, then lane j writes payload bytes j, j+32, ... of the
// segment: byte t ORs values k in [8t/b, (8t+7)/b], each shifted by k·b-8t.
// Values past the frame's end stage as zero, so the tail frame's last byte
// keeps zeros above its bits.  In uniform mode every value is masked to fb
// bits, so a frame of another width writes junk but stays inside its slot;
// the caller reads the widths flag and discards the payload.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kFrameThreads)
pack_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t L,
            int64_t frames, const uint8_t* __restrict__ bits,
            const int64_t* __restrict__ offs, int fb,
            uint8_t* __restrict__ values) {
  __shared__ __align__(8) uint8_t stage[kWarpsPerBlock][kSegValues];
  const int lane = threadIdx.x % kWarp;
  uint8_t* seg = stage[threadIdx.x / kWarp];
  for (int64_t f = global_warp(); f < frames; f += warp_stride()) {
    const int64_t count = frame_count(f, n, L);
    const int b = offs != nullptr ? bits[f] : fb;
    const int64_t base = offs != nullptr ? offs[f] : f * (L * fb / 8);
    const int64_t nbytes = frame_bytes(b, count);
    const unsigned mask = (1u << b) - 1u;
    const uint8_t* src = data + f * L;
    for (int64_t s0 = 0; s0 < count; s0 += kSegValues) {
      const int64_t p = s0 + lane * 8;
      uint64_t w = 0;
      if (p + 8 <= count) {
        w = __ldg(reinterpret_cast<const uint64_t*>(src + p));
      } else {
        for (int j = 0; j < 8; ++j)
          if (p + j < count) w |= uint64_t(src[p + j]) << (8 * j);
      }
      reinterpret_cast<uint64_t*>(seg)[lane] = w;
      __syncwarp();
      const int64_t out0 = s0 * b / 8;  // exact: s0 is a multiple of 256
      const int64_t left = nbytes - out0;
      const int nout = left < 32 * b ? static_cast<int>(left) : 32 * b;
      for (int t = lane; t < nout; t += kWarp) {
        const int k0 = (8 * t) / b;
        const int k1 = min((8 * t + 7) / b, kSegValues - 1);
        unsigned acc = 0;
        for (int k = k0; k <= k1; ++k) {
          const unsigned v = seg[k] & mask;
          const int sh = k * b - 8 * t;
          acc |= sh >= 0 ? (v << sh) : (v >> -sh);
        }
        values[base + out0 + t] = static_cast<uint8_t>(acc);
      }
      __syncwarp();
    }
  }
}

// --------------------------------------------------------------------------
// Unpack.  Replaces fl_dense_pallas._decode_kernel (window DMA + expansion
// routing + group unpack) and _uniform_dec_kernel / _uniform_dec_kernel_mr.
// Reads the payload, writes n bytes.  Lane i decodes values 4i..4i+3 of each
// 128-value step: value k sits at bit k·b of the frame payload, so the four
// values lie in a 5-byte little-endian window starting at byte 4i·b/8.
// Reads stop at values_size; the four bytes are stored as one 32-bit word.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kFrameThreads)
unpack_kernel(const uint8_t* __restrict__ values, int64_t values_size,
              int64_t n, int64_t L, int64_t frames,
              const uint8_t* __restrict__ bits,
              const int64_t* __restrict__ offs, int fb,
              uint8_t* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t f = global_warp(); f < frames; f += warp_stride()) {
    const int64_t count = frame_count(f, n, L);
    const int b = offs != nullptr ? bits[f] : fb;
    const int64_t base = offs != nullptr ? offs[f] : f * (L * fb / 8);
    const uint64_t mask = (1u << b) - 1u;
    uint8_t* dst = out + f * L;
    for (int64_t i = 4 * lane; i < count; i += 4 * kWarp) {
      const int64_t bit = i * b;
      const int64_t p = base + bit / 8;
      const int sh = static_cast<int>(bit % 8);
      uint64_t w = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (p + j < values_size)
          w |= uint64_t(__ldg(values + p + j)) << (8 * j);
      uint32_t o = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o |= static_cast<uint32_t>((w >> (sh + k * b)) & mask) << (8 * k);
      if (i + 4 <= count) {
        *reinterpret_cast<uint32_t*>(dst + i) = o;
      } else {
        for (int k = 0; i + k < count; ++k)
          dst[i + k] = static_cast<uint8_t>(o >> (8 * k));
      }
    }
  }
}

int64_t frame_blocks(int64_t frames) {
  const int64_t blocks = (frames + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks < kMaxFrameBlocks ? blocks : kMaxFrameBlocks;
}

bool bad_geometry(int64_t n, int64_t L) {
  return n < 0 || L <= 0 || L % 8 != 0;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_frame_widths(const void* data, int64_t n,
                               int64_t frame_length, int fb_expect,
                               void* bits, void* flag, int device,
                               void* stream) {
  if (bad_geometry(n, frame_length) || fb_expect < 0 || fb_expect > 8)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  if (frames == 0) return cudaSuccess;
  frame_widths_kernel<<<static_cast<unsigned>(frame_blocks(frames)),
                        kFrameThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, frame_length, frames, fb_expect,
      static_cast<uint8_t*>(bits), static_cast<int*>(flag));
  return cudaGetLastError();
}

FLRL_API int64_t flrl_scan_carries_size(int64_t frames) {
  return frames > 0 ? (frames + kScanTile - 1) / kScanTile : 1;
}

FLRL_API int flrl_frame_offsets(const void* bits, int64_t n,
                                int64_t frame_length, void* offs,
                                void* carries, int device, void* stream) {
  if (bad_geometry(n, frame_length)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* o = static_cast<int64_t*>(offs);
  int64_t* c = static_cast<int64_t*>(carries);
  if (frames == 0) {
    return cudaMemsetAsync(o, 0, sizeof(int64_t), s);
  }
  const int64_t tiles = flrl_scan_carries_size(frames);
  scan_tiles_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0, s>>>(
      static_cast<const uint8_t*>(bits), n, frame_length, frames, o, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_carries_kernel<<<1, kScanThreads, 0, s>>>(c, tiles, o + frames);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t add_blocks = (frames + 255) / 256;
  add_carries_kernel<<<static_cast<unsigned>(
                           add_blocks < kMaxFrameBlocks ? add_blocks
                                                        : kMaxFrameBlocks),
                       256, 0, s>>>(o, frames, c);
  return cudaGetLastError();
}

FLRL_API int flrl_pack(const void* data, int64_t n, int64_t frame_length,
                       const void* bits, const void* offs, int fb,
                       void* values, int device, void* stream) {
  const bool uniform = offs == nullptr;
  if (bad_geometry(n, frame_length) ||
      (uniform ? (fb < 1 || fb > 8) : (fb != 0 || bits == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  if (frames == 0) return cudaSuccess;
  pack_kernel<<<static_cast<unsigned>(frame_blocks(frames)), kFrameThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, frame_length, frames,
      static_cast<const uint8_t*>(bits), static_cast<const int64_t*>(offs),
      fb, static_cast<uint8_t*>(values));
  return cudaGetLastError();
}

FLRL_API int flrl_unpack(const void* values, int64_t values_size, int64_t n,
                         int64_t frame_length, const void* bits,
                         const void* offs, int fb, void* out, int device,
                         void* stream) {
  const bool uniform = offs == nullptr;
  if (bad_geometry(n, frame_length) || values_size < 0 ||
      (uniform ? (fb < 1 || fb > 8) : (fb != 0 || bits == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t frames = (n + frame_length - 1) / frame_length;
  if (frames == 0) return cudaSuccess;
  unpack_kernel<<<static_cast<unsigned>(frame_blocks(frames)), kFrameThreads,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), values_size, n, frame_length,
      frames, static_cast<const uint8_t*>(bits),
      static_cast<const int64_t*>(offs), fb, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

FLRL_API const char* flrl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
