// SpMV of the BSR tail of the block-offset storage (blk_b = 8):
//
//   y[R*8 + i] += sum_k sum_j vals[(i*8 + j)*nb + k] * x[cols[k]*8 + j]
//
// over the blocks k of block row R, for every block row that holds a run
// of tail blocks (the tail's block rows are sorted, so the blocks of one
// row are one run [run_start[r], run_start[r+1]) with row run_row[r]).
// The unstructured meshes' tangent spills its rare offsets into this
// tail; the dense offsets go through offset_spmv.cu first and this
// kernel adds into the y that kernel wrote.  Replaces the reference's
// metafem/linsolve/block_offset.py:_blk_tail_mv, which XLA compiled on
// the TPU (it has no Pallas kernel).
//
// The storage is component-major: entry (i, j) of block k lies at
// (i*8 + j)*nb + k of `vals` (the tail's first value), so the block axis
// is the minor one and consecutive blocks are consecutive addresses.
//
// Bound: memory.  One product reads the 64*nb values once (at 1.37M
// DOF, 4.4M blocks: 1.1 GB in float32), the nb column ids, x (a block
// of 8 contiguous values per block, from L2) and the run tables, and
// writes the touched rows of y.
// Design: one warp per run.  Lane l takes the blocks start + l, start +
// l + 32, ..., so a warp's load of one component (i, j) reads 32
// consecutive values: 128 contiguous bytes in float32.  For each of its
// blocks a lane reads the block's 8 x values (one 32-byte sector in
// float32) through the read-only cache, not staged in shared memory (a
// shared-memory window lost to reads through the cache on the tangent's
// own stream, gather_probe.cu), and adds the 8 products of each row i
// into its own sum for i in order j = 0..7.  The warp then sums each
// row's 32 lane sums by a fixed xor-shuffle tree (16, 8, 4, 2, 1), and
// lane i writes y[R*8 + i] once.  No atomics and a fixed order: y
// repeats bitwise.  A block row at the edge (R*8 + i >= n) is masked,
// and so are the x values of an edge block column.  Every value and x
// address is computed in int64 (64*nb passes 2^31 at full size).  Plain
// C interface for ctypes; each entry point returns cudaGetLastError()
// after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 8;            // block size of the tail
constexpr int kWarps = 8;        // warps per thread block
constexpr int kThreads = 32 * kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_tail_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, const int64_t* __restrict__ cols,
                const int64_t* __restrict__ run_start,
                const int64_t* __restrict__ run_row, int64_t n_runs,
                int64_t nb, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps
                    + (threadIdx.x >> 5);
  if (r >= n_runs) return;             // whole warps leave together
  const int64_t k0 = run_start[r];
  const int64_t k1 = run_start[r + 1];
  T acc[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) acc[i] = T(0);
  for (int64_t k = k0 + lane; k < k1; k += 32) {
    const int64_t c0 = __ldg(cols + k) * kB;
    T xb[kB];
    if (c0 + kB <= n) {
#pragma unroll
      for (int j = 0; j < kB; ++j) xb[j] = __ldg(x + c0 + j);
    } else {
#pragma unroll
      for (int j = 0; j < kB; ++j)
        xb[j] = c0 + j < n ? __ldg(x + c0 + j) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
#pragma unroll
      for (int j = 0; j < kB; ++j)
        acc[i] = fma(__ldg(vals + (i * kB + j) * nb + k), xb[j], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kB; ++i) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], s);
  }
  // every lane holds every row's sum; lane i writes row i
  T mine = acc[0];
#pragma unroll
  for (int i = 1; i < kB; ++i)
    if (lane == i) mine = acc[i];
  const int64_t row = run_row[r] * kB + lane;
  if (lane < kB && row < n) y[row] += mine;
}

template <typename T>
int launch(const void* vals, const void* x, void* y, const void* cols,
           const void* run_start, const void* run_row, int64_t n_runs,
           int64_t nb, int64_t n, void* stream) {
  if (n_runs == 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((n_runs + kWarps - 1) / kWarps);
  bsr_tail_kernel<T><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<const int64_t*>(cols),
      static_cast<const int64_t*>(run_start),
      static_cast<const int64_t*>(run_row), n_runs, nb, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BSR_TAIL_MV(NAME, T)                                               \
  extern "C" int NAME(const void* vals, const void* x, void* y,            \
                      const void* cols, const void* run_start,             \
                      const void* run_row, int64_t n_runs, int64_t nb,     \
                      int64_t n, void* stream) {                           \
    return launch<T>(vals, x, y, cols, run_start, run_row, n_runs, nb, n,  \
                     stream);                                              \
  }

BSR_TAIL_MV(bsr_tail_mv_f64, double)
BSR_TAIL_MV(bsr_tail_mv_f32, float)
