// Constant-stream FL kernels for Hopper (sm_90a).
//
// These replace the TPU's verify-and-broadcast Pallas kernels of
// fl_rl_compression_mpi_tpu/ops/fl_dense_pallas.py:
//
//   fl_encode_dense_constant_pallas (_const_enc_kernel)  -> flrl_const_encode
//   fl_decode_dense_constant_pallas (_const_dec_kernel)  -> flrl_const_decode
//
// The function is ported, not the TPU mechanism.  The Pallas kernels walk a
// padded grid of (R, 128)-word tiles in order, and program 0 zeroes the flag
// that later steps OR into.  Hopper blocks run in no order, so the wrapper
// zeroes the flag before the launch, each block reduces its threads' verdicts
// with __syncthreads_or, and a block that saw a mismatch ORs 1 into the flag
// with one atomic.  The kernels take the shard's exact n bytes (no tile
// grid): encode compares n bytes and writes exactly ceil(n/128) widths and
// ceil(n·fb/8) payload bytes; decode compares exactly values_size payload
// bytes (the TPU's byte-masked straddling tail word) and writes n bytes.
//
// Both are bound by memory: encode reads n and writes n/128 + n·fb/8 bytes,
// decode reads n·fb/8 and writes n.  Each range is walked grid-stride in
// 16-byte vectors, neighbouring threads on neighbouring addresses, with a
// byte loop for the unaligned head and the tail, so any pointer works.
#include <cuda_runtime.h>

#include "fl_constant.cuh"

namespace flrl {
namespace {

constexpr int kConstThreads = 256;
// Grid cap: 8 blocks of 256 threads on each of the H100's 132 SMs; the
// grid-stride loops walk the rest.
constexpr int64_t kConstMaxBlocks = 132 * 8;
constexpr int64_t kConstFrame = 128;

__device__ __forceinline__ int64_t thread_index() {
  return int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t thread_stride() {
  return int64_t(gridDim.x) * blockDim.x;
}

// Bytes before p's next 16-byte boundary, at most n.
__device__ __forceinline__ int64_t head_bytes(const void* p, int64_t n) {
  const int64_t h = (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  return h < n ? h : n;
}

// True when some byte of p[0..n) differs from b (this thread's share).
__device__ bool differs(const uint8_t* __restrict__ p, int64_t n, uint8_t b) {
  const int64_t t = thread_index(), s = thread_stride();
  const int64_t head = head_bytes(p, n);
  const int64_t vecs = (n - head) / 16;
  const uint32_t w = b * 0x01010101u;
  uint32_t bad = 0;
  for (int64_t i = t; i < head; i += s) bad |= p[i] ^ b;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int64_t i = t; i < vecs; i += s) {
    const uint4 q = __ldg(v + i);
    bad |= (q.x ^ w) | (q.y ^ w) | (q.z ^ w) | (q.w ^ w);
  }
  for (int64_t i = head + vecs * 16 + t; i < n; i += s) bad |= p[i] ^ b;
  return bad != 0;
}

// p[0..n) = b (this thread's share).
__device__ void fill(uint8_t* __restrict__ p, int64_t n, uint8_t b) {
  const int64_t t = thread_index(), s = thread_stride();
  const int64_t head = head_bytes(p, n);
  const int64_t vecs = (n - head) / 16;
  const uint32_t w = b * 0x01010101u;
  const uint4 q = make_uint4(w, w, w, w);
  for (int64_t i = t; i < head; i += s) p[i] = b;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = t; i < vecs; i += s) v[i] = q;
  for (int64_t i = head + vecs * 16 + t; i < n; i += s) p[i] = b;
}

__device__ __forceinline__ void raise_flag(bool bad, int* flag) {
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

__global__ void __launch_bounds__(kConstThreads)
const_encode_kernel(const uint8_t* __restrict__ data, int64_t n,
                    uint8_t cbyte, uint8_t* __restrict__ bits,
                    int64_t frames, uint8_t fb, uint8_t* __restrict__ values,
                    int64_t values_size, uint8_t pattern, int* flag) {
  const bool bad = differs(data, n, cbyte);
  fill(bits, frames, fb);
  fill(values, values_size, pattern);
  raise_flag(bad, flag);
}

__global__ void __launch_bounds__(kConstThreads)
const_decode_kernel(const uint8_t* __restrict__ values, int64_t values_size,
                    uint8_t pattern, uint8_t* __restrict__ out, int64_t n,
                    uint8_t cbyte, int* flag) {
  const bool bad = differs(values, values_size, pattern);
  fill(out, n, cbyte);
  raise_flag(bad, flag);
}

// c's low fb bits repeated 8/fb times: every payload byte of a constant
// stream at width fb (the byte of const_payload_word's 32-bit pattern).
uint8_t pattern_byte(int cbyte, int fb) {
  int p = 0;
  for (int i = 0; i < 8; i += fb) p |= cbyte << i;
  return static_cast<uint8_t>(p);
}

bool bad_constant(int cbyte, int fb, int64_t n) {
  if (cbyte < 0 || cbyte > 255 || n < 0) return true;
  if (fb != 1 && fb != 2 && fb != 4 && fb != 8) return true;
  int width = 1;
  while (width < 8 && (cbyte >> width) != 0) ++width;
  return fb != width || (cbyte != 0 && n % kConstFrame != 0);
}

int grid_for(int64_t bytes) {
  int64_t blocks = (bytes / 16 + kConstThreads - 1) / kConstThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kConstMaxBlocks) blocks = kConstMaxBlocks;
  return static_cast<int>(blocks);
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_const_encode(const void* data, int64_t n, int cbyte, int fb,
                               void* bits, void* values, void* flag,
                               int device, void* stream) {
  if (bad_constant(cbyte, fb, n)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t frames = (n + kConstFrame - 1) / kConstFrame;
  const int64_t values_size = (n * fb + 7) / 8;
  const_encode_kernel<<<grid_for(n), kConstThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<uint8_t>(cbyte),
      static_cast<uint8_t*>(bits), frames, static_cast<uint8_t>(fb),
      static_cast<uint8_t*>(values), values_size, pattern_byte(cbyte, fb),
      static_cast<int*>(flag));
  return cudaGetLastError();
}

FLRL_API int flrl_const_decode(const void* values, int64_t values_size,
                               int cbyte, int fb, void* out, int64_t n,
                               void* flag, int device, void* stream) {
  if (bad_constant(cbyte, fb, n) || values_size < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0 && values_size == 0) return cudaSuccess;
  const int64_t bytes = n > values_size ? n : values_size;
  const_decode_kernel<<<grid_for(bytes), kConstThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), values_size,
      pattern_byte(cbyte, fb), static_cast<uint8_t*>(out), n,
      static_cast<uint8_t>(cbyte), static_cast<int*>(flag));
  return cudaGetLastError();
}
