// Random-gather probe: out[i] = x[idx[i]] for float32 x and int32 idx.
//
// Replaces the TPU kernel benchmarks/pallas_gather_probe.py
// (vmem_gather_kernel, driven by make_fn.f), which measured how fast
// random reads run against a window held in the TPU's fast on-chip memory
// (VMEM), to decide the design of the sparse kernels.  On Hopper the same
// question is device memory (through L2) against shared memory, and it
// informs the design of the block-sparse tail of the block-offset SpMV.
// Two variants, both persistent and grid-striding, 4 outputs per thread
// and step (one 16-byte idx load, one 16-byte store; a scalar tail, and a
// scalar path where idx or out is not 16-byte aligned):
//
// * cluster window (gather_cluster_f32): the TPU kernel's on-chip window,
//   spread over a thread-block cluster.  Block r of a cluster of k blocks
//   stages slice r of x (``slice`` values, a multiple of 4, the last slice
//   shorter) into its own dynamic shared memory with 16-byte loads, the
//   cluster synchronises, and x[j] is read from block j / slice at offset
//   j % slice through distributed shared memory (map_shared_rank).  A
//   second cluster barrier keeps each slice alive while the others read
//   it.  The rank is a float reciprocal product corrected by one step,
//   exact for windows below 2^24 values, which the limit below keeps
//   (the Python helper window_slices repeats that arithmetic).  One
//   block may hold the opt-in limit of shared memory (227 KB on an H100)
//   and a cluster up to 16 blocks (above 8 only with the non-portable
//   attribute), so a window may hold up to 16 x 227 KB.  About as many
//   clusters are launched as the card holds at once
//   (cudaOccupancyMaxActiveClusters); each stages the window once and
//   strides over idx.
// * device memory (gather_global_f32): x read through the read-only data
//   cache (__ldg); a grid that fills the SMs once.  Any n_win.
//
// The entry points size their grids themselves from the occupancy
// queries (gather_global_blocks, gather_cluster_blocks).
//
// Both are bound by memory: 4*n_idx bytes of idx read, 4*n_idx of out
// written and 4*n_win of x read at least once.  idx and out are streamed
// with evict-first hints (__ldcs, __stcs) so that x stays in L2.  An index
// outside [0, n_win) yields NaN (the caller keeps them in range).  Plain C
// interface for ctypes; each launch entry point returns
// cudaGetLastError() after the launch (or the launch call's own error).

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGlobalThreads = 256;
constexpr int kClusterThreads = 1024;

// out[i] = x[idx[i]] for the grid's share of i, x read by ``read``.
template <class Read>
__device__ __forceinline__ void gather_loop(const int32_t* __restrict__ idx,
                                            float* __restrict__ out,
                                            int64_t n_idx, uint32_t n_win,
                                            bool vec, Read read) {
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  auto pick = [&](int32_t j) {
    return static_cast<uint32_t>(j) < n_win ? read(static_cast<uint32_t>(j))
                                            : NAN;
  };
  const int64_t n4 = vec ? n_idx / 4 : 0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t q = start; q < n4; q += stride) {
    const int4 j = __ldcs(idx4 + q);
    __stcs(out4 + q, make_float4(pick(j.x), pick(j.y), pick(j.z), pick(j.w)));
  }
  for (int64_t i = 4 * n4 + start; i < n_idx; i += stride)
    __stcs(out + i, pick(__ldcs(idx + i)));
}

__global__ void __launch_bounds__(kGlobalThreads)
gather_global_kernel(const float* __restrict__ x,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ out, uint32_t n_win, int64_t n_idx,
                     bool vec) {
  gather_loop(idx, out, n_idx, n_win, vec,
              [&](uint32_t j) { return __ldg(x + j); });
}

__global__ void __launch_bounds__(kClusterThreads)
gather_cluster_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, uint32_t n_win,
                      uint32_t slice, int64_t n_idx, bool vec) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  // stage this block's slice: 16-byte loads where x is 16-byte aligned
  // (slice is a multiple of 4, so then every slice is)
  const uint32_t lo = cluster.block_rank() * slice;
  const int cnt = lo < n_win ? static_cast<int>(min(slice, n_win - lo)) : 0;
  const float* src = x + lo;
  const int n4 = (reinterpret_cast<uintptr_t>(x) % 16 == 0) ? cnt / 4 : 0;
  for (int q = threadIdx.x; q < n4; q += blockDim.x)
    smem4[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
  for (int q = 4 * n4 + threadIdx.x; q < cnt; q += blockDim.x)
    xs[q] = __ldg(src + q);
  cluster.sync();
  const int s = static_cast<int>(slice);
  const float inv = __frcp_rn(__int2float_rn(s));
  gather_loop(idx, out, n_idx, n_win, vec, [&](uint32_t j) {
    // rank j / slice and offset j % slice; the rounded product is within
    // one of the quotient for j < 2^24
    int r = static_cast<int>(__fmul_rn(__uint2float_rn(j), inv));
    int o = static_cast<int>(j) - r * s;
    if (o < 0) {
      --r;
      o += s;
    } else if (o >= s) {
      ++r;
      o -= s;
    }
    return *cluster.map_shared_rank(xs + o, r);
  });
  cluster.sync();
}

__global__ void empty_kernel() {}

cudaLaunchConfig_t cluster_config(unsigned clusters, int k, int smem_bytes,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * k);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
             % 16 == 0;
}

// Occupancy of the current device, queried at the first use of each
// (device, k, shared memory) and kept: the first call of a shape comes
// before any stream capture, so a captured launch only reads the table.
struct Resident {
  int device, k, smem, n;
};
Resident g_resident[256];
int g_n_resident = 0;

// Clusters of k blocks with ``smem`` bytes of dynamic shared memory each
// that the current device holds at once (cudaOccupancyMaxActiveClusters;
// 0: it cannot launch one), or minus the CUDA error.  k = 0 stands for
// the device-memory kernel: its resident blocks (SMs x blocks per SM).
int resident(int k, int smem) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  for (int i = 0; i < g_n_resident; ++i) {
    const Resident& r = g_resident[i];
    if (r.device == device && r.k == k && r.smem == smem) return r.n;
  }
  int n = 0;
  if (k == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gather_global_kernel, kGlobalThreads, 0);
    n *= sms;
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(1, k, smem, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(&n, gather_cluster_kernel, &cfg);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // so that the next launch's check does not see it
    return -static_cast<int>(e);
  }
  if (g_n_resident < 256) g_resident[g_n_resident++] = {device, k, smem, n};
  return n;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

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

// Let the cluster kernel use up to ``bytes`` of dynamic shared memory and
// clusters above the portable 8 blocks on the current device, and return
// the largest k <= 16 the device launches with ``bytes`` per block (0:
// none), or minus the CUDA error.  Called once per device, outside any
// stream capture.
extern "C" int gather_cluster_setup(int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      gather_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int k_max = 0;
  for (int k = 1; k <= 16; ++k) {
    const int n = resident(k, bytes);
    if (n < 0) return n;
    if (n > 0) k_max = k;
  }
  return k_max;
}

// Blocks the device-memory kernel launches for n_idx gathers: as many as
// the current device holds at once, fewer where that would leave a
// thread without 4 outputs; or minus the CUDA error.
extern "C" int64_t gather_global_blocks(int64_t n_idx) {
  const int n = resident(0, 0);
  if (n <= 0) return n < 0 ? n : -1;
  return std::max<int64_t>(1, std::min<int64_t>(
                                  n, ceil_div(n_idx, 4 * kGlobalThreads)));
}

// Blocks the window kernel launches for n_idx gathers in clusters of k
// blocks of ``slice`` values each: whole clusters, as many as the current
// device holds at once, fewer where that would leave a thread without 4
// outputs; 0 where the device schedules no such cluster, or minus the
// CUDA error.
extern "C" int64_t gather_cluster_blocks(int64_t n_idx, int k,
                                         int64_t slice) {
  const int n = resident(k, static_cast<int>(slice * sizeof(float)));
  if (n <= 0) return n;
  return k * std::max<int64_t>(
                 1, std::min<int64_t>(
                        n, ceil_div(n_idx, int64_t{4} * kClusterThreads * k)));
}

// The window variant: clusters of k blocks, each block holding ``slice``
// values of x (slice * 4 bytes of shared memory); -1 where the device
// schedules no such cluster.
extern "C" int gather_cluster_f32(const void* x, const void* idx, void* out,
                                  int64_t n_win, int64_t n_idx, int k,
                                  int64_t slice, void* stream) {
  if (n_idx == 0) return 0;
  const int64_t blocks = gather_cluster_blocks(n_idx, k, slice);
  if (blocks < 0) return static_cast<int>(-blocks);
  if (blocks == 0) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(static_cast<unsigned>(blocks / k), k,
                     static_cast<int>(slice * sizeof(float)),
                     static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gather_cluster_kernel, static_cast<const float*>(x),
      static_cast<const int32_t*>(idx), static_cast<float*>(out),
      static_cast<uint32_t>(n_win), static_cast<uint32_t>(slice), n_idx,
      aligned16(idx, out));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The device-memory variant.
extern "C" int gather_global_f32(const void* x, const void* idx, void* out,
                                 int64_t n_win, int64_t n_idx, void* stream) {
  if (n_idx == 0) return 0;
  const int64_t blocks = gather_global_blocks(n_idx);
  if (blocks < 0) return static_cast<int>(-blocks);
  gather_global_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), static_cast<uint32_t>(n_win), n_idx,
      aligned16(idx, out));
  return static_cast<int>(cudaGetLastError());
}

// One empty kernel of one block: the launch floor of this library.
extern "C" int gather_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
