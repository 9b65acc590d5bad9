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
//
// The two-float product (offset_spmv_packed_df) computes the same sum
// with every value an (hi, lo) pair of floats, as the reference's
// metafem/linsolve/twofloat.py:df_offset_mv does (XLA fused it on the
// TPU; there is no Pallas kernel for it):
//
//   y[pd, r] = sum_g sum_k (v_hi + v_lo)[g, k, r] * (x_hi + x_lo)[pb_g, r + d_k]
//
// It walks the float64 plan (V = 2): slot s holds the pair (hi, lo) of
// its entry, so a 16-byte load brings two entries and the kernel reads
// the same bytes as the float64 one; x's words are read from two
// vectors.  Per unit a fresh pair sums the unit's entries with df_add
// (two_sum, then fast_two_sum); at the unit's end the unit's pair is
// df_added into the row's, and the row writes y_hi and y_lo once: the
// reference's (unit, offset) order, no atomics, bitwise repeats.
// Bound: memory, as the float64 kernel; but each entry is 17 float
// operations of which ~8 depend on the running pair, and x's two words
// are two gathers, which on an unstructured (Morton) group land far
// apart: a thread that waits on each slot group's x before its df_adds
// is latency-bound.  Design: one thread per packed row, as the float64
// kernel; per pass it takes the row's next 4 slot groups (across unit
// ends): first their values and code words, then their x pairs, all in
// flight together, then their df_adds in the row's order, so its bits
// are those of a walk one group at a time.  two_prod and the cross
// terms do not wait on the pair.  The loads in flight take 72
// registers a thread against 40 for a walk one group at a time, so
// __launch_bounds__ asks for 3 resident blocks (24 warps per SM; a cap
// of 64 registers spills).  Where x's gathers land far apart (a Morton
// group) the loads in flight win; on a lattice, whose gathers a warp
// coalesces, the halved occupancy costs a little (PERF.md).  Two or
// four rows per thread (lane l of consecutive slices) lost to one.
// The error-free transforms must not be contracted, so every add,
// subtract and multiply in them is __fadd_rn/__fsub_rn/__fmul_rn,
// which nvcc never fuses into an FMA, and two_prod's error is fmaf(a,
// b, -a*b), the exact error that the reference's Dekker split
// computes.  The file's other kernels keep nvcc's contraction (see
// above): no file-wide --fmad=false.  offset_spmv_df_occupancy reports
// the kernel's registers, spills and resident warps per SM.

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
// then df_add into the unit's pair
__device__ __forceinline__ void df_entry(float& uh, float& ul, float vh,
                                         float vl, float xh, float xl) {
  const float p = __fmul_rn(vh, xh);
  float e = fmaf(vh, xh, -p);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(vh, xl), __fmul_rn(vl, xh)));
  df_add(uh, ul, p, e);
}

// slot groups of a row whose loads are issued together ahead of their
// df_adds, and the least resident blocks of kThreads that
// __launch_bounds__ asks the register allocator to leave room for (at
// most 80 registers a thread; a cap of 64 spills)
constexpr int kAhead = 4;
constexpr int kDfBlocks = 3;

__global__ void __launch_bounds__(kThreads, kDfBlocks)
offset_spmv_packed_df_kernel(const float4* __restrict__ vals,
                             const float* __restrict__ x_hi,
                             const float* __restrict__ x_lo,
                             float* __restrict__ y_hi,
                             float* __restrict__ y_lo,
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
  constexpr int kV = 2;                  // entries per 16-byte load
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
  const int32_t r = static_cast<int32_t>(row - pd * n_cp);
  const int pb0 = static_cast<int>(pd * maxu);
  const int ng = max((L + kV - 1) / kV, 1);      // slot groups per unit
  const int own = __popc(mask) * ((L + kV - 1) / kV);
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(codes)
                       + list * words;
  float rh = 0.f, rl = 0.f, uh = 0.f, ul = 0.f;
  int cg = 0;
  int32_t xo = 0;
  // kAhead slot groups per pass (across unit ends): their values and
  // code words, then their x pairs, are all in flight before the first
  // df_add
  for (int m = 0; m < own; m += kAhead) {
    float4 v[kAhead];
    uint32_t w[kAhead];
    int32_t xb[kAhead];        // x index of the group's unit (< 2^31)
    unsigned last = 0;         // bit k: group m + k ends its unit
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m + k < own) {
        if (cg == 0) {                         // a unit starts
          const int i = __ffs(mask) - 1;
          mask &= mask - 1;
          xo = s_pb[pb0 + i] * static_cast<int32_t>(n_cp) + r;
        }
        // slot group m + k: slots ptr[m+k] + 2q, 2q + 1, i.e. float4
        // ptr[m+k]/2 + q
        v[k] = __ldg(vals + s_ptr[m + k] / kV + q);
        const int c0 = cg * kV;
        w[k] = __ldg(cw + (c0 >> 2)) >> ((c0 & 3) * 8);
        xb[k] = xo;
        if (++cg == ng) {
          cg = 0;
          last |= 1u << k;
        }
      }
    }
    float xh0[kAhead], xl0[kAhead], xh1[kAhead], xl1[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m + k < own) {
        const int64_t a0 = static_cast<int64_t>(xb[k]) + s_dk[w[k] & 0xff];
        const int64_t a1 = static_cast<int64_t>(xb[k])
                           + s_dk[(w[k] >> 8) & 0xff];
        xh0[k] = __ldg(x_hi + a0);
        xl0[k] = __ldg(x_lo + a0);
        xh1[k] = __ldg(x_hi + a1);
        xl1[k] = __ldg(x_lo + a1);
      }
    }
    // the row's entries in its (unit, offset) order; a unit's pair is
    // df_added into the row's at the unit's end
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m + k < own) {
        df_entry(uh, ul, v[k].x, v[k].y, xh0[k], xl0[k]);
        df_entry(uh, ul, v[k].z, v[k].w, xh1[k], xl1[k]);
        if (last >> k & 1) {
          df_add(rh, rl, uh, ul);
          uh = ul = 0.f;
        }
      }
    }
  }
  y_hi[row] = rh;
  y_lo[row] = rl;
}

size_t table_bytes(int64_t n_groups, int64_t n_off, int64_t n_vars,
                   int64_t maxu) {
  return static_cast<size_t>(n_groups + 1) * sizeof(int64_t)
         + static_cast<size_t>(n_off + n_vars * maxu) * sizeof(int32_t);
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
int launch(const void* vals, const void* x, void* y, const void* rows,
           const void* meta, const void* codes, const void* list_len,
           const void* ptr, const void* dk, const void* chan_pb,
           int64_t n_slices, int64_t n_groups, int64_t n_off, int64_t maxu,
           int64_t n_vars, int64_t n_cp, int64_t words, void* stream) {
  const int64_t n_threads = n_slices * kSlice;
  if (n_threads == 0) return 0;
  const size_t smem = table_bytes(n_groups, n_off, n_vars, maxu);
  const cudaError_t err = allow_smem(offset_spmv_packed_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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

extern "C" int offset_spmv_packed_df(
    const void* vals, const void* x_hi, const void* x_lo, void* y_hi,
    void* y_lo, const void* rows, const void* meta, const void* codes,
    const void* list_len, const void* ptr, const void* dk,
    const void* chan_pb, int64_t n_slices, int64_t n_groups, int64_t n_off,
    int64_t maxu, int64_t n_vars, int64_t n_cp, int64_t words,
    void* stream) {
  const int64_t n_threads = n_slices * kSlice;
  if (n_threads == 0) return 0;
  const size_t smem = table_bytes(n_groups, n_off, n_vars, maxu);
  const cudaError_t err = allow_smem(offset_spmv_packed_df_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  offset_spmv_packed_df_kernel<<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(vals), static_cast<const float*>(x_hi),
      static_cast<const float*>(x_lo), static_cast<float*>(y_hi),
      static_cast<float*>(y_lo), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(meta),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(list_len),
      static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(dk),
      static_cast<const int32_t*>(chan_pb), n_slices, n_groups, n_off,
      maxu, n_vars, n_cp, words);
  return static_cast<int>(cudaGetLastError());
}

// registers, spilled bytes, resident blocks and warps per SM of the
// two-float kernel, with its shared tables for one plan
extern "C" int offset_spmv_df_occupancy(int64_t n_groups, int64_t n_off,
                                        int64_t maxu, int64_t n_vars,
                                        int* regs, int* local_bytes,
                                        int* blocks, int* warps) {
  return occupancy(offset_spmv_packed_df_kernel,
                   table_bytes(n_groups, n_off, n_vars, maxu), regs,
                   local_bytes, blocks, warps);
}
