// The copy-ceiling probe for Hopper (sm_90a).
//
// This replaces the TPU kernels of bench.py's copy-ceiling probe and of
// an archived copy study:
//
//   _cp (_cp_kernel, bench.py:417-429)        -> flrl_copy_probe, addend 1
//   copy_pallas (experiments/exp6_r2_tuning.py:80,
//                pallas_call :83)             -> flrl_copy_probe, addend 0
//
// The Pallas kernels walk (tile_r, 128)-word blocks of a (rows, 128) u32
// array, adding 1 to every word (bench.py chains two such passes a step)
// or copying it; exp6's tile_r and grid semantics change only the TPU's
// schedule.  The addend is a template argument, so the x + 1 probe
// compiles to the code it had before the copy was added.  Hopper needs no
// block grid: one thread a 16-byte vector, on a grid that covers the flat
// word array once, as PyTorch's own elementwise kernels run (the
// grid-stride loop on a resident grid, unrolled four deep, that came first
// was slower on the H100: PERF.md §6 row 13), and any word count (threads
// 0..2 take the last nwords % 4 words).  A pointer that is not 16-byte
// aligned sends the whole call down a word-a-thread path.
//
// Both are bound by memory: 4·nwords bytes read and as many written.
#include <cuda_runtime.h>

#include "copy_probe.cuh"

namespace flrl {
namespace {

constexpr int kCopyThreads = 128;

template <uint32_t kAdd>
__device__ __forceinline__ uint4 add(uint4 q) {
  return make_uint4(q.x + kAdd, q.y + kAdd, q.z + kAdd, q.w + kAdd);
}

template <uint32_t kAdd>
__global__ void __launch_bounds__(kCopyThreads)
copy_probe_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                  int64_t nwords, bool vectors) {
  const int64_t i = int64_t(blockIdx.x) * kCopyThreads + threadIdx.x;
  if (!vectors) {
    if (i < nwords) y[i] = x[i] + kAdd;
    return;
  }
  const int64_t nvec = nwords / 4;
  if (i < nvec) {
    reinterpret_cast<uint4*>(y)[i] =
        add<kAdd>(reinterpret_cast<const uint4*>(x)[i]);
  }
  if (i < nwords - nvec * 4) y[nvec * 4 + i] = x[nvec * 4 + i] + kAdd;
}

}  // namespace
}  // namespace flrl

using namespace flrl;

FLRL_API int flrl_copy_probe(const void* x, void* y, int64_t nwords,
                             int addend, int device, void* stream) {
  if (nwords < 0 || (addend != 0 && addend != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nwords == 0) return cudaSuccess;
  const bool vectors = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t items = vectors ? (nwords + 3) / 4 : nwords;
  const int64_t blocks = (items + kCopyThreads - 1) / kCopyThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = addend ? copy_probe_kernel<1u> : copy_probe_kernel<0u>;
  kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), nwords,
      vectors);
  return cudaGetLastError();
}
