// Packed SpMV of the block-offset storage, one workpiece group:
//
//   y[pd, r] = sum_g sum_k vals[g, k, r] * x[pb_g, r + d_k]
//
// over the structural entries only, gathered once per matrix through a
// pack plan (metafem_torch/linsolve/offset_spmv.py: build_pack_plan).
// Replaces the TPU kernel metafem/linsolve/pallas_spmv.py:_group_kernel
// (driven by group_mv).
//
// The plan.  Packed row q = slice*32 + lane is output row rows[q] =
// pd*n_cp + r (-1: a lane that pads the last slice).  meta[q] = mask |
// list << 8: the row's offset codes, code list `list` (list_len[list]
// one-byte codes from word list*words of `codes`, shared by every row
// with the same offsets), serve each participating unit of channel pd
// (bit i of mask: the i-th unit, whose pb is chan_pb[pd*maxu + i]); code
// k decodes to the offset dk[k].  The row's slots run unit by unit, each
// unit's L codes padded to a multiple of V (2 for double, 4 for float)
// with zero values and a valid code; slot group m (V slots, 16 bytes) of
// row q lies at vals[ptr[m] + q*V], sliced jagged-diagonal, so the 32
// lanes of a warp read 512 contiguous bytes.
//
// Bound: memory.  One product reads the packed values and the row
// tables once, the code lists (a few KB, from L1) and x (from L2, where
// it stays: 8.4 MB for the 3D f64 tangent), and writes y once.
// Design: one thread per output row (one launch for all channels) walks
// its units and codes in the reference's (unit, offset) order and writes
// y once, with no atomics, so y repeats bitwise and equals the dense
// formula's (nvcc contracts acc += v*x to an FMA; an FMA with a zero
// value leaves acc unchanged).
// Each value load is a 16-byte vector, read through the non-coherent
// path and unrolled four deep, so each thread keeps several loads in
// flight.  ptr, dk and chan_pb sit in shared memory (lanes that read
// different codes would serialise on constant memory).  Every value and
// x address is computed in int64.  Plain C interface for ctypes; each
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;
constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double at(const double2& v, int t) {
    return t == 0 ? v.x : v.y;
  }
};

template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float at(const float4& v, int t) {
    return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
offset_spmv_packed_kernel(const T* __restrict__ vals,
                          const T* __restrict__ x, T* __restrict__ y,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ meta,
                          const uint8_t* __restrict__ codes,
                          const int32_t* __restrict__ list_len,
                          const int64_t* __restrict__ ptr,
                          const int32_t* __restrict__ dk,
                          const int32_t* __restrict__ chan_pb,
                          int64_t n_slices, int64_t n_groups,
                          int64_t n_off, int64_t maxu, int64_t n_vars,
                          int64_t n_cp, int64_t words) {
  using VT = typename Vec<T>::type;
  constexpr int kV = Vec<T>::n;
  extern __shared__ int64_t smem[];
  int64_t* s_ptr = smem;                                   // n_groups + 1
  int32_t* s_dk = reinterpret_cast<int32_t*>(s_ptr + n_groups + 1);
  int32_t* s_pb = s_dk + n_off;                            // n_vars*maxu
  for (int64_t i = threadIdx.x; i <= n_groups; i += blockDim.x)
    s_ptr[i] = ptr[i];
  for (int64_t i = threadIdx.x; i < n_off; i += blockDim.x) s_dk[i] = dk[i];
  for (int64_t i = threadIdx.x; i < n_vars * maxu; i += blockDim.x)
    s_pb[i] = chan_pb[i];
  __syncthreads();

  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (q >= n_slices * kSlice) return;
  const int32_t row = rows[q];
  if (row < 0) return;
  const uint32_t mt = static_cast<uint32_t>(meta[q]);
  unsigned mask = mt & 0xff;
  const int64_t list = mt >> 8;
  const int L = __ldg(list_len + list);
  const int64_t pd = row / n_cp;
  const int64_t r = row - pd * n_cp;
  const int ng = (L + kV - 1) / kV;            // slot groups per unit
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(codes)
                       + list * words;
  const T* vq = vals + q * kV;
  T acc = T(0);
  int m = 0;
  while (mask) {
    const int i = __ffs(mask) - 1;
    mask &= mask - 1;
    const T* xr = x + static_cast<int64_t>(s_pb[pd * maxu + i]) * n_cp + r;
#pragma unroll 4
    for (int cg = 0; cg < ng; ++cg, ++m) {
      const VT v = __ldg(reinterpret_cast<const VT*>(vq + s_ptr[m]));
      const int c0 = cg * kV;
      const uint32_t w = __ldg(cw + (c0 >> 2)) >> ((c0 & 3) * 8);
#pragma unroll
      for (int t = 0; t < kV; ++t)
        acc = fma(Vec<T>::at(v, t),
                  __ldg(xr + s_dk[(w >> (8 * t)) & 0xff]), acc);
    }
  }
  y[row] = acc;
}

template <typename T>
int launch(const void* vals, const void* x, void* y, const void* rows,
           const void* meta, const void* codes, const void* list_len,
           const void* ptr, const void* dk, const void* chan_pb,
           int64_t n_slices, int64_t n_groups, int64_t n_off, int64_t maxu,
           int64_t n_vars, int64_t n_cp, int64_t words, void* stream) {
  const int64_t n_threads = n_slices * kSlice;
  if (n_threads == 0) return 0;
  const size_t smem = static_cast<size_t>(n_groups + 1) * sizeof(int64_t)
                      + static_cast<size_t>(n_off + n_vars * maxu)
                        * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        offset_spmv_packed_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid =
      static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  offset_spmv_packed_kernel<T><<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(meta),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(list_len),
      static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(dk),
      static_cast<const int32_t*>(chan_pb), n_slices, n_groups, n_off,
      maxu, n_vars, n_cp, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define OFFSET_SPMV_PACKED(NAME, T)                                        \
  extern "C" int NAME(const void* vals, const void* x, void* y,            \
                      const void* rows, const void* meta,                  \
                      const void* codes, const void* list_len,             \
                      const void* ptr, const void* dk,                     \
                      const void* chan_pb, int64_t n_slices,               \
                      int64_t n_groups, int64_t n_off, int64_t maxu,       \
                      int64_t n_vars, int64_t n_cp, int64_t words,         \
                      void* stream) {                                      \
    return launch<T>(vals, x, y, rows, meta, codes, list_len, ptr, dk,     \
                     chan_pb, n_slices, n_groups, n_off, maxu, n_vars,     \
                     n_cp, words, stream);                                 \
  }

OFFSET_SPMV_PACKED(offset_spmv_packed_f64, double)
OFFSET_SPMV_PACKED(offset_spmv_packed_f32, float)
