// Dense-segment SpMV of the block-offset storage, one workpiece group:
//
//   y[pd, r] = sum_g sum_k vals[(g*n_off + k)*n_cp + r] * x[pb_g, r + d_k]
//
// with x taken as zero outside [0, n_cp).  Replaces the TPU kernel
// metafem/linsolve/pallas_spmv.py:_group_kernel (driven by group_mv).
//
// Design: one thread per output row r and channel pd (blockIdx.y).  The
// thread walks the units g whose output channel is pd, and for each the
// sorted offsets d_k, in the reference's order, accumulating in a
// register and writing y once.  Neighbouring threads read neighbouring
// vals and x entries, so every load is coalesced.  The kernel is bound by
// memory: at least (G*n_off + 2*C)*n_cp*sizeof(T) bytes move (each value
// read once, x and y once each); the reuse of x across offsets comes from
// L1/L2 rather than from a halo'd window in shared memory, which would
// not fit the 227 KB of a block for 3D offset radii (~2.6e4 rows).
//
// Every storage offset is computed in int64: (g*n_off + k)*n_cp + r passes
// 2^31 at 3D sizes.  Plain C interface for ctypes; each entry point
// returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void offset_spmv_kernel(const T* __restrict__ vals,
                                   const T* __restrict__ x,
                                   T* __restrict__ y,
                                   const int64_t* __restrict__ units,
                                   const int64_t* __restrict__ offsets,
                                   int64_t n_units, int64_t n_off,
                                   int64_t n_cp) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t pd = blockIdx.y;
  if (r >= n_cp) return;
  T acc = T(0);
  for (int64_t g = 0; g < n_units; ++g) {
    if (units[2 * g] != pd) continue;
    const T* xb = x + units[2 * g + 1] * n_cp;
    const T* vg = vals + g * n_off * n_cp + r;
    for (int64_t k = 0; k < n_off; ++k) {
      const int64_t j = r + offsets[k];
      if (j >= 0 && j < n_cp) acc += vg[k * n_cp] * xb[j];
    }
  }
  y[pd * n_cp + r] = acc;
}

template <typename T>
int launch(const void* vals, const void* x, void* y, const void* units,
           const void* offsets, int64_t n_units, int64_t n_off,
           int64_t n_vars, int64_t n_cp, void* stream) {
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((n_cp + threads - 1) / threads),
                  static_cast<unsigned>(n_vars));
  offset_spmv_kernel<T><<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<const int64_t*>(units),
      static_cast<const int64_t*>(offsets), n_units, n_off, n_cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int offset_spmv_f64(const void* vals, const void* x, void* y,
                               const void* units, const void* offsets,
                               int64_t n_units, int64_t n_off,
                               int64_t n_vars, int64_t n_cp, void* stream) {
  return launch<double>(vals, x, y, units, offsets, n_units, n_off, n_vars,
                        n_cp, stream);
}

extern "C" int offset_spmv_f32(const void* vals, const void* x, void* y,
                               const void* units, const void* offsets,
                               int64_t n_units, int64_t n_off,
                               int64_t n_vars, int64_t n_cp, void* stream) {
  return launch<float>(vals, x, y, units, offsets, n_units, n_off, n_vars,
                       n_cp, stream);
}
