// The copy-ceiling probe for Hopper (sm_90a).
//
// This replaces the TPU kernel of bench.py's copy-ceiling probe:
//
//   _cp (_cp_kernel, bench.py:417-429)  -> flrl_copy_probe
//
// The Pallas kernel walks (2048, 128)-word blocks of a (rows, 128) u32
// array, adding 1 to every word, and bench.py chains two such passes a
// step.  Hopper needs no block grid: one thread a 16-byte vector, on a grid
// that covers the flat word array once, as PyTorch's own elementwise
// kernels run (the grid-stride loop on a resident grid, unrolled four deep,
// that came first was slower on the H100: PERF.md §6 row 13), and any word
// count (threads 0..2 take the last nwords % 4 words).  A pointer that is not 16-byte aligned sends the
// whole call down a word-a-thread path.
//
// It is bound by memory: 4·nwords bytes read and as many written.
#include <cuda_runtime.h>

#include "copy_probe.cuh"

namespace flrl {
namespace {

constexpr int kCopyThreads = 128;

__device__ __forceinline__ uint4 add_one(uint4 q) {
  return make_uint4(q.x + 1u, q.y + 1u, q.z + 1u, q.w + 1u);
}

__global__ void __launch_bounds__(kCopyThreads)
copy_probe_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                  int64_t nwords, bool vectors) {
  const int64_t i = int64_t(blockIdx.x) * kCopyThreads + threadIdx.x;
  if (!vectors) {
    if (i < nwords) y[i] = x[i] + 1u;
    return;
  }
  const int64_t nvec = nwords / 4;
  if (i < nvec) {
    reinterpret_cast<uint4*>(y)[i] =
        add_one(reinterpret_cast<const uint4*>(x)[i]);
  }
  if (i < nwords - nvec * 4) y[nvec * 4 + i] = x[nvec * 4 + i] + 1u;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_copy_probe(const void* x, void* y, int64_t nwords,
                             int device, void* stream) {
  if (nwords < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nwords == 0) return cudaSuccess;
  const bool vectors = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t items = vectors ? (nwords + 3) / 4 : nwords;
  const int64_t blocks = (items + kCopyThreads - 1) / kCopyThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  copy_probe_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), nwords,
      vectors);
  return cudaGetLastError();
}
