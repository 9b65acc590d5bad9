// SpMV of the BSR tail of the block-offset storage, over the packed rows
// of the tail's structural entries:
//
//   y[row] += sum_s vals[s] * x[cols[s]]
//
// over the slots s of each packed row, built once per layout by the tail
// plan (metafem_torch/linsolve/bsr_tail.py: build_tail_plan) from the
// BSR storage, y[R*8 + i] += sum_k sum_j vals[(i*8 + j)*nb + k] *
// x[cols[k]*8 + j].  The unstructured meshes' tangent spills its rare
// offsets into that tail; the dense offsets go through offset_spmv.cu
// first and this kernel adds into the y that kernel wrote.  Replaces the
// reference's metafem/linsolve/block_offset.py:372 (_blk_tail_mv), which
// XLA compiled on the TPU (it has no Pallas kernel).
//
// The plan.  Packed row q = slice*32 + lane is matrix row rows[q] (-1: a
// lane that pads the last slice); its entries run in ascending column.
// Rows are sorted by entry count within windows of 4,096 rows and cut
// into slices of 32 rows, and the slices are ordered by their longest
// row.  Slot group m (V slots: 2 for double, 4 for float; 16 bytes of
// values) of row q lies at ptr[m] + q*V of `vals` and `cols`, sliced
// jagged-diagonal, so the 32 lanes of a warp read 512 contiguous bytes of
// values and 256 or 512 of column ids per load.  Slice s reaches group m
// while ptr[m] + q*V < ptr[m+1]: every row of a slice runs to its
// slice's longest row, through slots of zero value and a valid column.
//
// Bound: memory.  One product reads the packed values and their int32
// column ids once (at 1.37M DOF: 19.7M slots, ~157 MB in float32, ~236 MB
// in float64), the row ids, x (through the read-only cache; it stays in
// L2: 5.5 MB in float32, 11 MB in float64), and reads and writes each
// touched row of y once.  Why the BSR storage lost: 93% of its 64*nb
// stored values are zeros that the assembly never writes, so a kernel
// over the blocks streamed 14x the bytes the product needs (1.16 GB in
// float32).  The column ids now double the bytes of the values; the
// structural bound (values, x and y once) stays the yardstick.
// Design: one thread per packed row walks its slot groups with 16-byte
// (values) and 16- or 8-byte (column ids) loads through the
// non-coherent path, unrolled four deep so that several loads are in
// flight, sums its products in the plan's order (nvcc contracts
// acc += v*x into an FMA; a zero value leaves acc unchanged), and adds
// the sum into y[row] once.  Rows are distinct, so no atomics: y repeats
// bitwise.  ptr sits in shared memory.  Every value and x address is
// computed in int64.  Plain C interface for ctypes; each entry point
// returns cudaGetLastError() after the launch.
//
// The two-float product (bsr_tail_packed_df) computes the same sum with
// every value an (hi, lo) pair of floats, as the BSR branch of the
// reference's metafem/linsolve/twofloat.py:236 (df_offset_mv, XLA, no
// Pallas kernel) does.  It walks the float64 plan (V = 2): slot s holds
// the pair (hi, lo) of its entry, so a 16-byte load brings two entries
// and the kernel reads the bytes the float64 one reads; x's words come
// from two vectors.  Each row sums its entries into a fresh pair with
// df_add in the plan's order, then df_adds the row's pair into (y_hi,
// y_lo).  Each entry is 17 float operations, ~8 of them on the running
// pair, behind a column id and two gathers of x's words: a thread that
// waits on each slot group's x before its df_adds is latency-bound.
// Design: one thread per packed row, as the float kernels; per pass it
// takes the row's next 4 slot groups: first their values and column
// ids, then their x pairs, all in flight together, then their df_adds
// in the plan's order, so its bits are those of a walk one group at a
// time.  __launch_bounds__ asks for 3 resident blocks (the loads in
// flight take 74 registers a thread).  Two or four rows per thread
// (lane l of consecutive slices) were level or slower (PERF.md).  The
// error-free transforms must not be contracted, so every add, subtract
// and multiply in them is __fadd_rn/__fsub_rn/__fmul_rn, which nvcc
// never fuses into an FMA, and two_prod's error is fmaf(a, b, -a*b),
// the exact error that the Dekker split computes.  The float kernels
// keep nvcc's contraction: no file-wide --fmad=false.
// bsr_tail_df_occupancy reports the kernel's registers, spills and
// resident warps per SM.

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
  using index = int2;
  static constexpr int n = 2;
  __device__ static double at(const double2& v, int t) {
    return t == 0 ? v.x : v.y;
  }
  __device__ static int col(const int2& c, int t) {
    return t == 0 ? c.x : c.y;
  }
};

template <>
struct Vec<float> {
  using type = float4;
  using index = int4;
  static constexpr int n = 4;
  __device__ static float at(const float4& v, int t) {
    return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
  }
  __device__ static int col(const int4& c, int t) {
    return t == 0 ? c.x : t == 1 ? c.y : t == 2 ? c.z : c.w;
  }
};

// ptr into shared memory; the slot groups that packed row q's slice
// reaches (the same for the 32 lanes of a warp)
__device__ __forceinline__ int load_ptr(const int64_t* __restrict__ ptr,
                                        int64_t* s_ptr, int64_t n_groups,
                                        int64_t q, int v) {
  for (int64_t i = threadIdx.x; i <= n_groups; i += blockDim.x)
    s_ptr[i] = ptr[i];
  __syncthreads();
  int ng = 0;
  while (ng < n_groups && s_ptr[ng] + q * v < s_ptr[ng + 1]) ++ng;
  return ng;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_tail_packed_kernel(const T* __restrict__ vals,
                       const int32_t* __restrict__ cols,
                       const T* __restrict__ x, T* __restrict__ y,
                       const int32_t* __restrict__ rows,
                       const int64_t* __restrict__ ptr, int64_t n_slices,
                       int64_t n_groups) {
  using VT = typename Vec<T>::type;
  using IT = typename Vec<T>::index;
  constexpr int kV = Vec<T>::n;
  extern __shared__ int64_t s_ptr[];
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int ng = load_ptr(ptr, s_ptr, n_groups, q, kV);
  if (q >= n_slices * kSlice) return;
  const int32_t row = rows[q];
  if (row < 0) return;
  T acc = T(0);
#pragma unroll 4
  for (int m = 0; m < ng; ++m) {
    const int64_t s = s_ptr[m] + q * kV;
    const VT v = __ldg(reinterpret_cast<const VT*>(vals + s));
    const IT c = __ldg(reinterpret_cast<const IT*>(cols + s));
#pragma unroll
    for (int t = 0; t < kV; ++t)
      acc = fma(Vec<T>::at(v, t),
                __ldg(x + static_cast<int64_t>(Vec<T>::col(c, t))), acc);
  }
  y[row] += acc;
}

// ----- the two-float product ------------------------------------------

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (xh, xl) += (yh, yl): two_sum of the high words, then fast_two_sum of
// the sum and the low words' error (twofloat.df_add)
__device__ __forceinline__ void df_add(float& xh, float& xl, float yh,
                                       float yl) {
  float s, e;
  two_sum(xh, yh, s, e);
  const float t = __fadd_rn(e, __fadd_rn(xl, yl));
  xh = __fadd_rn(s, t);
  xl = __fsub_rn(t, __fsub_rn(xh, s));
}

// one entry: (p, e) = two_prod(v_hi, x_hi), e += v_hi*x_lo + v_lo*x_hi,
// then df_add into the row's pair
__device__ __forceinline__ void df_entry(float& rh, float& rl, float vh,
                                         float vl, float xh, float xl) {
  const float p = __fmul_rn(vh, xh);
  float e = fmaf(vh, xh, -p);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(vh, xl), __fmul_rn(vl, xh)));
  df_add(rh, rl, p, e);
}

// slot groups of a row whose loads are issued together ahead of their
// df_adds, and the least resident blocks of kThreads that
// __launch_bounds__ asks the register allocator to leave room for
constexpr int kAhead = 4;
constexpr int kDfBlocks = 3;

__global__ void __launch_bounds__(kThreads, kDfBlocks)
bsr_tail_packed_df_kernel(const float4* __restrict__ vals,
                          const int32_t* __restrict__ cols,
                          const float* __restrict__ x_hi,
                          const float* __restrict__ x_lo,
                          float* __restrict__ y_hi, float* __restrict__ y_lo,
                          const int32_t* __restrict__ rows,
                          const int64_t* __restrict__ ptr, int64_t n_slices,
                          int64_t n_groups) {
  constexpr int kV = 2;                  // entries per 16-byte load
  extern __shared__ int64_t s_ptr[];
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int ng = load_ptr(ptr, s_ptr, n_groups, q, kV);
  if (q >= n_slices * kSlice) return;
  const int32_t row = rows[q];
  if (row < 0) return;
  // slot group m: slots s = ptr[m] + 2q, s + 1, i.e. float4 s/2 of the
  // values and int2 s/2 of the column ids (s is even)
  const int2* cols2 = reinterpret_cast<const int2*>(cols);
  float rh = 0.f, rl = 0.f;
  // kAhead slot groups per pass: their values and column ids, then
  // their x pairs, are all in flight before the first df_add
  for (int m = 0; m < ng; m += kAhead) {
    float4 v[kAhead];
    int2 c[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m + k < ng) {
        v[k] = __ldg(vals + s_ptr[m + k] / kV + q);
        c[k] = __ldg(cols2 + s_ptr[m + k] / kV + q);
      }
    }
    float xh0[kAhead], xl0[kAhead], xh1[kAhead], xl1[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m + k < ng) {
        const int64_t c0 = c[k].x, c1 = c[k].y;
        xh0[k] = __ldg(x_hi + c0);
        xl0[k] = __ldg(x_lo + c0);
        xh1[k] = __ldg(x_hi + c1);
        xl1[k] = __ldg(x_lo + c1);
      }
    }
    // the row's entries in the plan's order
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m + k < ng) {
        df_entry(rh, rl, v[k].x, v[k].y, xh0[k], xl0[k]);
        df_entry(rh, rl, v[k].z, v[k].w, xh1[k], xl1[k]);
      }
    }
  }
  float yh = y_hi[row], yl = y_lo[row];
  df_add(yh, yl, rh, rl);
  y_hi[row] = yh;
  y_lo[row] = yl;
}

// lets `kernel` take `smem` bytes of dynamic shared memory where that is
// above the default 48 KB
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, void* y,
           const void* rows, const void* ptr, int64_t n_slices,
           int64_t n_groups, void* stream) {
  const int64_t n_threads = n_slices * kSlice;
  if (n_threads == 0) return 0;
  const size_t smem = static_cast<size_t>(n_groups + 1) * sizeof(int64_t);
  const cudaError_t err = allow_smem(bsr_tail_packed_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  bsr_tail_packed_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const int32_t*>(rows), static_cast<const int64_t*>(ptr),
      n_slices, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BSR_TAIL_PACKED(NAME, T)                                           \
  extern "C" int NAME(const void* vals, const void* cols, const void* x,   \
                      void* y, const void* rows, const void* ptr,          \
                      int64_t n_slices, int64_t n_groups, void* stream) {  \
    return launch<T>(vals, cols, x, y, rows, ptr, n_slices, n_groups,      \
                     stream);                                              \
  }

BSR_TAIL_PACKED(bsr_tail_packed_f64, double)
BSR_TAIL_PACKED(bsr_tail_packed_f32, float)

namespace {

// registers and local (spilled) bytes per thread of `kernel`, and the
// blocks and warps of kThreads that fit on one SM with `smem` bytes each
template <typename K>
int occupancy(K kernel, size_t smem, int* regs, int* local_bytes,
              int* blocks, int* warps) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kThreads, smem);
  *warps = *blocks * kThreads / 32;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int bsr_tail_packed_df(const void* vals, const void* cols,
                                  const void* x_hi, const void* x_lo,
                                  void* y_hi, void* y_lo, const void* rows,
                                  const void* ptr, int64_t n_slices,
                                  int64_t n_groups, void* stream) {
  const int64_t n_threads = n_slices * kSlice;
  if (n_threads == 0) return 0;
  const size_t smem = static_cast<size_t>(n_groups + 1) * sizeof(int64_t);
  const cudaError_t err = allow_smem(bsr_tail_packed_df_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  bsr_tail_packed_df_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const float*>(x_hi), static_cast<const float*>(x_lo),
      static_cast<float*>(y_hi), static_cast<float*>(y_lo),
      static_cast<const int32_t*>(rows), static_cast<const int64_t*>(ptr),
      n_slices, n_groups);
  return static_cast<int>(cudaGetLastError());
}

// registers, spilled bytes, resident blocks and warps per SM of the
// two-float kernel, with the shared ptr of one plan
extern "C" int bsr_tail_df_occupancy(int64_t n_groups, int* regs,
                                     int* local_bytes, int* blocks,
                                     int* warps) {
  return occupancy(bsr_tail_packed_df_kernel,
                   static_cast<size_t>(n_groups + 1) * sizeof(int64_t), regs,
                   local_bytes, blocks, warps);
}
