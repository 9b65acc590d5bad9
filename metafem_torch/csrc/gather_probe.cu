// Random-gather probe: out[i] = x[idx[i]] for float32 x and int32 idx.
//
// Replaces the TPU kernel benchmarks/pallas_gather_probe.py
// (vmem_gather_kernel, driven by make_fn.f), which measured how fast
// random reads run against a window held in the TPU's fast on-chip memory
// (VMEM), to decide the design of the sparse kernels.  On Hopper the same
// question is device memory against shared memory, and it informs the
// design of the block-sparse tail of the block-offset SpMV.  Two variants:
//
// * shared-window (gather_window_f32): the TPU kernel's design.  Every
//   block stages the whole x window in dynamic shared memory (float4
//   loads), synchronises, then gathers for its slice of idx from shared
//   memory.  A block may hold at most the opt-in limit of shared memory
//   (227 KB on an H100), so n_win is limited to that over 4 bytes.
//   gather_window_allow raises the kernel's limit above the default 48 KB
//   once per device (cudaFuncSetAttribute), and the wrapper refuses
//   larger windows.
// * device-memory (gather_global_f32): one thread per output reads
//   x[idx[i]] through the read-only data cache.  Any n_win.
//
// Both are bound by memory: 4*n_idx bytes of idx read, 4*n_idx of out
// written and 4*n_win of x read at least once; at the probe's sizes
// (n_idx <= 524288) that is under 5 MB, about a microsecond at 3.35 TB/s,
// so the launch itself dominates.  An index outside [0, n_win) yields NaN
// (the caller keeps them in range).  Plain C interface for ctypes; each
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 16;

__global__ void gather_window_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int n_win,
                                     int64_t n_idx) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  // stage the window: float4 loads where x is 16-byte aligned
  const int n4 = (reinterpret_cast<uintptr_t>(x) % 16 == 0) ? n_win / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int j = threadIdx.x; j < n4; j += blockDim.x) smem4[j] = x4[j];
  for (int j = 4 * n4 + threadIdx.x; j < n_win; j += blockDim.x)
    xs[j] = x[j];
  __syncthreads();
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * blockDim.x * kItemsPerThread;
  for (int k = 0; k < kItemsPerThread; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * blockDim.x
                      + threadIdx.x;
    if (i < n_idx) {
      const int32_t j = idx[i];
      out[i] = (j >= 0 && j < n_win) ? xs[j] : NAN;
    }
  }
}

__global__ void gather_global_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int64_t n_win,
                                     int64_t n_idx) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n_idx) return;
  const int32_t j = idx[i];
  out[i] = (j >= 0 && j < n_win) ? __ldg(x + j) : NAN;
}

}  // namespace

// The largest dynamic shared memory a block of this device may opt in to
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or -1 on error.
extern "C" int gather_window_limit_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Let the window kernel use up to ``bytes`` of dynamic shared memory on
// the current device (needed above the default 48 KB).  Called once per
// device before the first launch, outside any stream capture.
extern "C" int gather_window_allow(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      gather_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes));
}

extern "C" int gather_window_f32(const void* x, const void* idx, void* out,
                                 int64_t n_win, int64_t n_idx,
                                 void* stream) {
  const int bytes = static_cast<int>(n_win * sizeof(float));
  const int64_t per_block = static_cast<int64_t>(kThreads) * kItemsPerThread;
  const unsigned blocks =
      static_cast<unsigned>((n_idx + per_block - 1) / per_block);
  if (blocks == 0) return 0;
  gather_window_kernel<<<blocks, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), static_cast<int>(n_win), n_idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_global_f32(const void* x, const void* idx, void* out,
                                 int64_t n_win, int64_t n_idx,
                                 void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_idx + kThreads - 1) / kThreads);
  if (blocks == 0) return 0;
  gather_global_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_win, n_idx);
  return static_cast<int>(cudaGetLastError());
}
