// FL field-form kernels for Hopper (sm_90a).
//
// These replace the TPU's field-form Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/fl_pallas.py:
//
//   fl_encode_fields_pallas         -> flrl_fields_encode (base mode)
//   fl_encode_fields_packed_pallas  -> flrl_fields_encode (pack-2 mode)
//   fl_decode_fields_pallas         -> flrl_fields_decode (base mode)
//   fl_decode_fields_packed_pallas  -> flrl_fields_decode (pack-2 mode)
//
// The function is ported, not the TPU mechanism.  The Pallas kernels take a
// word's width from the f32 exponent, a frame's width as a segment max on the
// MXU and broadcast it back to the lanes with a second matmul, because the
// TPU's vector unit has no cheap clz and no cross-lane reduction over
// segments.  Here a frame's width is an OR of its bytes reduced across the
// lanes that hold its words (shuffles), and max(1, 32 - clz) of the result.
//
// Every launch is a pure stream: encode reads 4 bytes a word and writes 4
// (base) or 2 (pack-2) bytes a word plus one width byte a frame; decode the
// reverse.  Lane i takes word i of a warp's 32, so loads and base-mode stores
// are 128 contiguous bytes a warp; a pack-2 store writes the word's u16 slot,
// every other u16 of the warp's span.  Fields of width-≤4 frames are below
// 2^16, so each owns its slot: no read-modify-write, no atomics.
#include <cuda_runtime.h>

#include "fl_fields.cuh"

namespace flrl {
namespace {

constexpr int kWordThreads = 256;

__device__ __forceinline__ int64_t global_warp() {
  return (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
}

__device__ __forceinline__ int64_t warp_stride() {
  return int64_t(gridDim.x) * blockDim.x / kWarp;
}

// OR of a word's four bytes, in the low byte.  bitlen(OR) == bitlen(max).
__device__ __forceinline__ unsigned byte_or(uint32_t x) {
  const unsigned o = x | (x >> 16);
  return (o | (o >> 8)) & 0xffu;
}

// The reference's width rule, max(1, bitlen(max byte)) (fl_jax.py:27-30).
__device__ __forceinline__ int width_of(unsigned byte_or_value) {
  return max(1, 32 - __clz(static_cast<int>(byte_or_value)));
}

// e0 | e1<<b | e2<<2b | e3<<3b: exact in 32 bits (3b + 8 ≤ 32); b = 8 is
// the identity.
__device__ __forceinline__ uint32_t spread(uint32_t x, int b) {
  return (x & 0xffu) | (((x >> 8) & 0xffu) << b) |
         (((x >> 16) & 0xffu) << (2 * b)) | ((x >> 24) << (3 * b));
}

__device__ __forceinline__ uint32_t unspread(uint32_t f, int b) {
  const uint32_t m = (1u << b) - 1u;
  return (f & m) | (((f >> b) & m) << 8) | (((f >> (2 * b)) & m) << 16) |
         (((f >> (3 * b)) & m) << 24);
}

__device__ __forceinline__ void store_field(uint32_t* out, int64_t w,
                                            uint32_t f, int tile_r) {
  if (tile_r == 0)
    out[w] = f;
  else
    reinterpret_cast<uint16_t*>(out)[p2_idx16(w, tile_r)] =
        static_cast<uint16_t>(f);
}

// Frame index of word w; a shift where wpf is a power of two (sh >= 0).
__device__ __forceinline__ int64_t frame_of(int64_t w, int wpf, int sh) {
  return sh >= 0 ? w >> sh : w / wpf;
}

__device__ __forceinline__ int pow2_shift(int wpf) {
  return (wpf & (wpf - 1)) == 0 ? __ffs(wpf) - 1 : -1;
}

// --------------------------------------------------------------------------
// Encode, wpf a power of two ≤ 32 (L ∈ {8, 16, 32, 64, 128}): a warp takes
// 32 consecutive words, 32/wpf whole frames, and reduces each frame's OR with
// xor shuffles inside its aligned wpf-lane segment.  Replaces _encode_kernel
// and _encode_packed_kernel (fl_pallas.py:121, :309).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kWordThreads)
encode_segments_kernel(const uint32_t* __restrict__ words, int64_t nw,
                       int wpf, int tile_r, uint8_t* __restrict__ bits,
                       uint32_t* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int sh = pow2_shift(wpf);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w0 = int64_t(blockIdx.x) * blockDim.x + threadIdx.x - lane;
       w0 < nw; w0 += stride) {
    // nw is a frame multiple, so a segment is wholly live or wholly past nw
    const int64_t w = w0 + lane;
    const bool live = w < nw;
    const uint32_t x = live ? __ldg(words + w) : 0u;
    unsigned o = byte_or(x);
    for (int s = wpf >> 1; s > 0; s >>= 1)
      o |= __shfl_xor_sync(kFullMask, o, s);
    const int b = width_of(o);
    if (live) {
      if ((lane & (wpf - 1)) == 0)
        bits[frame_of(w, wpf, sh)] = static_cast<uint8_t>(b);
      store_field(out, w, spread(x, b), tile_r);
    }
  }
}

// --------------------------------------------------------------------------
// Encode, any other wpf (L = 24, 256, 512, 1024, ...): one warp a frame, a
// strided OR over its words, __reduce_or_sync, then a second strided pass
// (its words are in L1) that spreads and stores.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kFrameThreads)
encode_frames_kernel(const uint32_t* __restrict__ words, int64_t frames,
                     int wpf, int tile_r, uint8_t* __restrict__ bits,
                     uint32_t* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t f = global_warp(); f < frames; f += warp_stride()) {
    const uint32_t* src = words + f * wpf;
    unsigned o = 0;
    for (int i = lane; i < wpf; i += kWarp) o |= __ldg(src + i);
    o = __reduce_or_sync(kFullMask, byte_or(o));
    const int b = width_of(o);
    if (lane == 0) bits[f] = static_cast<uint8_t>(b);
    for (int i = lane; i < wpf; i += kWarp)
      store_field(out, f * wpf + i, spread(__ldg(src + i), b), tile_r);
  }
}

// --------------------------------------------------------------------------
// Decode: one thread a word; its frame's width from bits, its field from
// the u32 (base) or its u16 slot (pack-2).  Replaces _decode_kernel and
// _decode_packed_kernel (fl_pallas.py:152, :331).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kWordThreads)
decode_kernel(const uint32_t* __restrict__ in,
              const uint8_t* __restrict__ bits, int64_t nw, int wpf,
              int tile_r, uint32_t* __restrict__ out) {
  const int sh = pow2_shift(wpf);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < nw;
       w += stride) {
    const int b = __ldg(bits + frame_of(w, wpf, sh));
    const uint32_t f =
        tile_r == 0
            ? __ldg(in + w)
            : __ldg(reinterpret_cast<const uint16_t*>(in) + p2_idx16(w, tile_r));
    out[w] = unspread(f, b);
  }
}

unsigned grid_for(int64_t items, int per_block) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < kMaxFrameBlocks ? blocks
                                                        : kMaxFrameBlocks);
}

bool bad_fields(int64_t nw, int64_t L, int tile_r) {
  if (nw < 0 || L <= 0 || L % 8 != 0 || L / 4 > (int64_t(1) << 30))
    return true;
  const int64_t wpf = L / 4;
  if (nw % wpf != 0) return true;
  return tile_r != 0 && (tile_r < 0 || tile_r % 16 != 0 || 128 % wpf != 0);
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_fields_encode(const void* words, int64_t nw,
                                int64_t frame_length, int tile_r, void* bits,
                                void* out, int device, void* stream) {
  if (bad_fields(nw, frame_length, tile_r) ||
      (tile_r != 0 && nw % (int64_t(tile_r) * 128) != 0))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nw == 0) return cudaSuccess;
  const int wpf = static_cast<int>(frame_length / 4);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* b = static_cast<uint8_t*>(bits);
  auto* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wpf <= kWarp && (wpf & (wpf - 1)) == 0) {
    encode_segments_kernel<<<grid_for(nw, kWordThreads), kWordThreads, 0, s>>>(
        w, nw, wpf, tile_r, b, o);
  } else {
    const int64_t frames = nw / wpf;
    encode_frames_kernel<<<grid_for(frames, kWarpsPerBlock), kFrameThreads, 0,
                           s>>>(w, frames, wpf, tile_r, b, o);
  }
  return cudaGetLastError();
}

FLRL_API int flrl_fields_decode(const void* in, const void* bits, int64_t nw,
                                int64_t frame_length, int tile_r, void* out,
                                int device, void* stream) {
  if (bad_fields(nw, frame_length, tile_r)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nw == 0) return cudaSuccess;
  decode_kernel<<<grid_for(nw, kWordThreads), kWordThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint8_t*>(bits), nw,
      static_cast<int>(frame_length / 4), tile_r, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}
