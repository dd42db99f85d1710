// ell_spmv: y = A x over padded ELL.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmv.py:53
// (ell_spmv, pallas_call :69), which forms the initial residual r = b - A x0
// of every solve and is the matvec of every pipelined-PCG step.
//
// What bounds it on the H100: memory.  A call streams the (rows_p, W)
// int32 cols and float vals once -- 12 bytes per slot in float64, 8 in
// float32 -- reads x and writes y, for two flops per slot, far below the
// ~10 flops per byte at which float64 arithmetic would start to matter.
// At the main-path shape (1,048,576 x 8, float64) that is 100.7 MB of
// matrix plus 8.4 MB each of x and y, 117.4 MB: 35.1 us at 3.35 TB/s.
//
// The sum.  The TPU kernel keeps x resident in VMEM and streams (TM, TW)
// matrix tiles past it.  Here every variant computes one fixed sum: a
// row's G = group_size(W) virtual lanes (the power of two >= W, at most
// 32), lane g running an fma chain from 0 over slots g, g + G, ..., and the
// lanes combined by the xor butterfly of repro::group_sum (offsets G/2
// down to 1).  So y is the same bits whichever variant ran, and equals
// lane 0 of ell_spmm (which runs that sum per lane) bit for bit.
//
// Two variants of the same sum (ell_spmv.py pick_variant, from the width
// and the operands' alignment, never from a launch):
//   * rows, for W a multiple of 4 up to 16 (the engine's widths 8 and 16)
//     with 16-byte aligned cols and vals: the k = 1 call of ell_spmm's rows
//     kernel (spmv_dot.cu spmv_dot_rows_kernel with the dot compiled out,
//     below).  A thread owns a row, reads its cols and vals with 16-byte
//     streaming loads (__ldcs: evict-first, so the 100 MB matrix stream
//     does not push the 8.4 MB x out of the 50 MB L2), issues the row's x
//     gathers in two waves before their adds and folds the virtual lanes in
//     registers in the butterfly's pairs and order (repro::row_dot_halves).
//     Blocks stride over the rows on a persistent grid (ell_spmv.py
//     rows_grid).
//   * group, the path for every other operand (the wide skewed ELL,
//     W = 264, among them), and the design of the first slice (this file):
//     a row gets G consecutive lanes; lane g reads slots g, g + G, ..., so a
//     warp reads 32 consecutive slots of cols and vals a step, and the group
//     sums its lanes with shuffles.
// A third design, a producer warp streaming (128, W) tiles into a
// shared-memory ring with cp.async.bulk under mbarriers, lost the A/B to
// rows and was removed (its times are in PERF.md).

// ell_spmm: Y = A X for k right-hand sides in the solver layout, X (k,
// ncols) and Y (k, rows), row-major.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmv.py:106
// (ell_spmm, body :88), which forms the initial residual B - A X0 of every
// batched solve.  The TPU kernel takes the (n, k) kernel layout, and the
// JAX substrate transposes the solver's (k, n) vectors around each call;
// this kernel takes (k, n) as it is, so no copy is made.
//
// What bounds it: memory.  The matrix (12 bytes a slot in float64) is read
// once for all k lanes, X and Y once each: at 1,048,576 x 8 with k = 8 in
// float64, 100.7 + 67.1 + 67.1 MB, about 70 us at 3.35 TB/s.
//
// Two variants of ell_spmv's sum, lane by lane (ell_spmv.py pick_variant,
// ell_spmv's rule), so Y[j] does not depend on k or the variant and
// equals ell_spmv's y on lane j bit for bit:
//   * rows, for W a multiple of 4 up to 16 with 16-byte aligned cols and
//     vals: spmv_dot.cu's rows kernel with the fold and the dot compiled
//     out (repro_ell_spmm_rows there; Y has its own lane stride, so X may
//     be wider than the rows).  A thread holds its row's cols and vals in
//     registers after one pass of 16-byte streaming loads and runs the
//     lanes one after another (no chunk caps k: k = 16 is one launch),
//     each lane's gathers in two waves (repro::row_dot_halves), Y stored
//     with streaming stores, on the persistent grid of ell_spmv.py
//     rows_grid with registers capped for five blocks an SM.
//   * group, the first design and the path for every other operand: the
//     row groups of ell_spmv_kernel.  A thread loads each of its slots'
//     column and value once and applies them to every lane of its chunk
//     (K lanes in registers, K the power of two >= k, at most 8; wider
//     batches run in gridDim.y chunks, each reading the matrix again);
//     the group's threads all hold every lane's sum, thread jj % G writes
//     lane jj.  At k = 8 it reached 25% of its bound (0.281 ms).

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
ell_spmv_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                int w, int group, unsigned long long* launches) {
  repro::count_launch(launches);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = t / group;
  const int g = (int)(t % group);
  T acc = T(0);
  if (r < rows) {
    const int64_t base = r * w;
    for (int j = g; j < w; j += group)
      acc = repro::fma_rn(vals[base + j], __ldg(x + cols[base + j]), acc);
  }
  acc = repro::group_sum(acc, group);
  if (r < rows && g == 0) y[r] = acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           int64_t rows, int32_t w, int32_t group, unsigned long long* launches,
           void* stream) {
  if (rows <= 0 || w <= 0 || group < 1 || group > 32 || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  ell_spmv_kernel<T><<<(unsigned)blocks, repro::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (T*)y, rows, w, group,
      launches);
  return (int)cudaGetLastError();
}

template <typename T, int K>
__global__ void __launch_bounds__(repro::kThreads)
ell_spmm_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                int64_t ldx, int w, int group, int k, unsigned long long* launches) {
  repro::count_launch(launches);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = t / group;
  const int g = (int)(t % group);
  const int j0 = blockIdx.y * K;
  T acc[K];
#pragma unroll
  for (int jj = 0; jj < K; ++jj) acc[jj] = T(0);
  if (r < rows) {
    const int64_t base = r * w;
    for (int s = g; s < w; s += group) {
      const T v = vals[base + s];
      const int64_t c = cols[base + s];
#pragma unroll
      for (int jj = 0; jj < K; ++jj)
        if (j0 + jj < k)
          acc[jj] = repro::fma_rn(v, __ldg(x + (int64_t)(j0 + jj) * ldx + c),
                                  acc[jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < K; ++jj) {
    const T sum = repro::group_sum(acc[jj], group);
    if (r < rows && g == jj % group && j0 + jj < k)
      y[(int64_t)(j0 + jj) * rows + r] = sum;
  }
}

template <typename T, int K>
int launch_spmm_chunk(const void* cols, const void* vals, const void* x,
                      void* y, int64_t rows, int64_t ldx, int32_t w,
                      int32_t group, int32_t k, unsigned long long* launches,
                      void* stream) {
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)blocks, (unsigned)((k + K - 1) / K));
  ell_spmm_kernel<T, K><<<grid, repro::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (T*)y, rows, ldx, w,
      group, k, launches);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spmm(const void* cols, const void* vals, const void* x, void* y,
                int64_t rows, int64_t ldx, int32_t w, int32_t group,
                int32_t k, unsigned long long* launches, void* stream) {
  if (rows <= 0 || w <= 0 || ldx <= 0 || k <= 0 || group < 1 || group > 32 ||
      (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  switch (repro::lane_chunk(k)) {
    case 1: return launch_spmm_chunk<T, 1>(cols, vals, x, y, rows, ldx, w, group, k, launches, stream);
    case 2: return launch_spmm_chunk<T, 2>(cols, vals, x, y, rows, ldx, w, group, k, launches, stream);
    case 4: return launch_spmm_chunk<T, 4>(cols, vals, x, y, rows, ldx, w, group, k, launches, stream);
    default: return launch_spmm_chunk<T, 8>(cols, vals, x, y, rows, ldx, w, group, k, launches, stream);
  }
}

}  // namespace

extern "C" int repro_ell_spmv_f32(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int32_t w, int32_t group, void* launches,
                                  void* stream) {
  return launch<float>(cols, vals, x, y, rows, w, group,
                       (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmv_f64(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int32_t w, int32_t group, void* launches,
                                  void* stream) {
  return launch<double>(cols, vals, x, y, rows, w, group,
                        (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmm_f32(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int64_t ldx, int32_t w, int32_t group,
                                  int32_t k, void* launches, void* stream) {
  return launch_spmm<float>(cols, vals, x, y, rows, ldx, w, group, k,
                            (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmm_f64(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int64_t ldx, int32_t w, int32_t group,
                                  int32_t k, void* launches, void* stream) {
  return launch_spmm<double>(cols, vals, x, y, rows, ldx, w, group, k,
                             (unsigned long long*)launches, stream);
}
