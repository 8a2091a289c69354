// Helpers of the kernels that give a lane U stream bytes (U = 16, or 8 where
// L % 16 == 8) on a grid of the blocks the card holds at once: the widths,
// pack and unpack of fl_dense.cu and the field encode and decode of
// fl_fields.cu.
//
// A lane loads its U bytes with one vector load, ORs them into one byte
// (bitlen(OR of bytes) == bitlen(max byte), so the OR gives the frame's
// width), and a warp stores a step's widths from its shared-memory stage as
// 16-byte vectors.  Positions are 32-bit: the launchers take at most
// kDenseMaxBytes (2^31) bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fl_dense.cuh"

namespace flrl {
namespace {

__device__ __forceinline__ int64_t global_warp() {
  return (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
}

__device__ __forceinline__ int64_t warp_stride() {
  return int64_t(gridDim.x) * blockDim.x / kWarp;
}

// The U bytes from byte p on of the n-byte stream at data (v0: the first
// 8, v1: the next 8); zeros past the stream's end.  data + p is U-byte
// aligned.
template <int U>
__device__ __forceinline__ void load_group(const uint8_t* data, uint32_t n,
                                           uint32_t p, uint64_t& v0,
                                           uint64_t& v1) {
  v0 = v1 = 0;
  if (p + U <= n) {
    if (U == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(data + p));
      v0 = q.x | uint64_t(q.y) << 32;
      v1 = q.z | uint64_t(q.w) << 32;
    } else {
      v0 = __ldg(reinterpret_cast<const uint64_t*>(data + p));
    }
  } else {
    for (int j = 0; j < U && p + j < n; ++j) {
      if (j < 8)
        v0 |= uint64_t(data[p + j]) << (8 * j);
      else
        v1 |= uint64_t(data[p + j]) << (8 * (j - 8));
    }
  }
}

// The U bytes at an aligned address, in the first U bytes of a uint4.
template <int U>
__device__ __forceinline__ uint4 load_vec(const uint8_t* src) {
  if (U == 16) return __ldg(reinterpret_cast<const uint4*>(src));
  const uint2 h = __ldg(reinterpret_cast<const uint2*>(src));
  return make_uint4(h.x, h.y, 0, 0);
}

// The first U bytes of q to dst, U-byte aligned, as one vector store.
template <int U>
__device__ __forceinline__ void store_vec(uint8_t* dst, const uint4& q) {
  if (U == 16)
    *reinterpret_cast<uint4*>(dst) = q;
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(q.x, q.y);
}

// p / d for p < 2^32 and 2 ≤ d < 2^32, given recip = reciprocal(d):
// exact, since e = recip·d − 2^64 < d, so p·e < 2^64 and the error
// p·e / (d·2^64) stays below the distance 1/d from p/d to the next integer.
__device__ __forceinline__ uint32_t div_by(uint32_t p, uint64_t recip) {
  return static_cast<uint32_t>(__umul64hi(uint64_t(p), recip));
}

inline uint64_t reciprocal(uint64_t d) { return UINT64_MAX / d + 1; }

// The OR of the four bytes of x.
__device__ __forceinline__ unsigned or_bytes(uint32_t x) {
  x |= x >> 16;
  x |= x >> 8;
  return x & 0xffu;
}

// The reference's width rule, max(1, bitlen(max byte)) (fl_jax.py:27-30),
// of the OR of a frame's bytes.
__device__ __forceinline__ int width_of(unsigned m) {
  return max(1, 32 - __clz(static_cast<int>(m)));
}

// A step's `count` widths from the stage to dst (a multiple of `whole`
// widths from the 16-byte aligned start of bits): 16-byte vectors, or one
// word where a whole step has 4 or 8, and bytes where the step is cut.
__device__ __forceinline__ void store_widths(uint8_t* dst, const uint8_t* st,
                                             uint32_t count, uint32_t whole,
                                             int lane) {
  if (count == whole && whole >= 16) {
    if (lane < static_cast<int>(whole / 16))
      reinterpret_cast<uint4*>(dst)[lane] =
          reinterpret_cast<const uint4*>(st)[lane];
  } else if (count == whole && whole == 8) {
    if (lane == 0)
      *reinterpret_cast<uint64_t*>(dst) =
          *reinterpret_cast<const uint64_t*>(st);
  } else if (count == whole && whole == 4) {
    if (lane == 0)
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(st);
  } else {
    for (uint32_t i = lane; i < count; i += kWarp) dst[i] = st[i];
  }
}

// `wanted` blocks, at most the blocks the card holds at once
// (__launch_bounds__ keeps kDenseBlocksPerSm resident).
inline cudaError_t resident_grid(int64_t wanted, int device,
                                 unsigned& blocks) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t resident = int64_t(sms) * kDenseBlocksPerSm;
  blocks = static_cast<unsigned>(wanted < resident ? wanted : resident);
  return err;
}

inline bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace
}  // namespace flrl
