// ell_spmv_pfold_dot: p' = z + beta*p, y = A p', pap = dot(p', y).
// ell_spmv_dot: its unfolded twin, y = A x, pap = dot(x, y).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmv_dot.py:217
// (ell_spmv_pfold_dot), the matrix half of every PCG iteration.
//
// What bounds it on the H100: memory.  Per call it streams the padded ELL
// matrix once (12 bytes per slot in float64), reads z and p and writes p'
// and y (32 bytes per row in float64); three flops per slot plus the fold.
// At the main-path shape (1,048,576 x 8, float64) that is 134 MB: about
// 40 us at 3.35 TB/s.
//
// Design.  The Pallas body writes all of p' on grid step (0, 0) into a
// resident output block that later steps gather from
// (spmv_dot.py:193-197).  Hopper blocks run in no order, so no block can
// rely on another having written p' first.  This kernel therefore
// recomputes z[c] + beta*p[c] at each gather, and each row's owner writes
// p'[r] once.  The alternative, a separate fold pass, would write p' and
// read it back (16 bytes per row more); the recompute costs one extra
// gather per slot, which hits L2 for the banded and stencil matrices the
// solver runs.  The fold rounds product then sum (repro::fold), so the
// gathered and the stored p' are the same bits.
//
// pap: each block sums p'[r] * y[r] over its rows in a fixed order into
// partials[block]; a second one-block launch sums the partials in index
// order.  No float atomics: a run repeats bit for bit.  Row groups of G
// lanes read the matrix coalesced, as in ell_spmv.cu.

// ell_spmm_pfold_dot: the same for k right-hand sides in the solver layout:
// P' = Z + beta * P per lane, Y = A P', pap[j] = dot(P'[j], Y[j]); Z, P,
// P' and Y are (k, rows) row-major, beta and pap (k,).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmv_dot.py:296
// (ell_spmm_pfold_dot, body :267), the matrix half of every batched PCG
// iteration.  That body folds all of P' on grid step (0, 0) into a
// resident block later steps gather from (:273-275) -- the hazard above,
// met the same way: recompute at each gather, the row's owner stores.
//
// What bounds it: memory.  The matrix once for all k lanes, Z and P read,
// P' and Y written: at 1,048,576 x 8 with k = 8 in float64, 100.7 +
// 4 x 67.1 MB = 369.1 MB, about 110 us at 3.35 TB/s.
//
// Design: ell_spmm's K lanes a thread, with spmv_dot_kernel's arithmetic per
// lane.  Each lane's pap runs spmv_dot_kernel's reduction exactly: the
// contribution sits in the row group's lane 0, block_sum_lanes sums it as
// block_sum does, and the per-block partials, (k, nblocks) so that a
// lane's sequence is contiguous, are summed by a second launch of k
// blocks in index order.  The blocks' rows depend on W alone, so lane j's
// P', Y and pap do not depend on k and equal spmv_dot_kernel's on lane j.

// ell_spmv_dot and ell_spmm_dot: the same kernels with the fold compiled
// out (the template flag kFold), so they share the gather, the row
// groups, the per-block partials and the second pass.  Without the fold
// the gather reads x itself: no beta = 0 stands in for it, because
// 0 * p is not 0 where p holds an inf or a NaN.
//
// ell_spmv_dot replaces the Pallas TPU kernel
// src/repro/kernels/spmv_dot.py:67 (pallas_call :90): y = A x and
// pap = dot(x, y) for a square padded operator, x (rows_p,).  Bound:
// memory, the matrix once plus x in and y out, 117.4 MB at 1,048,576 x 8
// in float64: about 35 us at 3.35 TB/s.
//
// ell_spmm_dot replaces spmv_dot.py:134 (pallas_call :158): Y = A X and
// pap[j] = dot(X[:, j], Y[:, j]) in the Pallas kernel's layout, X
// (rows_p, k).  The kernel addresses X and Y through one pair of strides
// (row stride sr, lane stride sl): a row-major (rows_p, k) X and the
// transposed view of a contiguous (k, rows_p) tensor both pass without a
// copy, and Y is written in X's layout.  Bound: the matrix once, X in
// and Y out, 234.9 MB at k = 8 in float64: about 70 us.  Lane j's
// arithmetic does not depend on k, nor on the strides: lane j of a k = 8
// call is bitwise the k = 1 call on lane j.

#include "common.cuh"

namespace {

// One row per group of `group` lanes.  kFold: the gathered vector is
// z + beta * p, recomputed at each gather, and the row's owner stores
// p'[r]; otherwise it is z itself (p, beta and pn are unused).
template <typename T, bool kFold>
__global__ void __launch_bounds__(repro::kThreads)
spmv_dot_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ z, const T* __restrict__ p,
                const T* __restrict__ beta_ptr, T* __restrict__ pn,
                T* __restrict__ y, T* __restrict__ partials, int64_t rows,
                int w, int group) {
  __shared__ T sh[32];
  const T beta = kFold ? *beta_ptr : T(0);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = t / group;
  const int g = (int)(t % group);
  T acc = T(0);
  if (r < rows) {
    const int64_t base = r * w;
    for (int j = g; j < w; j += group) {
      const int c = cols[base + j];
      const T v = kFold ? repro::fold(__ldg(z + c), beta, __ldg(p + c))
                        : __ldg(z + c);
      acc = repro::fma_rn(vals[base + j], v, acc);
    }
  }
  acc = repro::group_sum(acc, group);
  T contrib = T(0);
  if (r < rows && g == 0) {
    const T pr = kFold ? repro::fold(z[r], beta, p[r]) : z[r];
    if (kFold) pn[r] = pr;
    y[r] = acc;
    contrib = repro::mul_rn(pr, acc);
  }
  contrib = repro::block_sum(contrib, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = contrib;
}

template <typename T, bool kFold>
int launch(const void* cols, const void* vals, const void* z, const void* p,
           const void* beta, void* pn, void* y, void* partials, void* pap,
           int64_t rows, int32_t w, int32_t group, int64_t nblocks,
           void* stream) {
  if (rows <= 0 || w <= 0 || group < 1 || group > 32 || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  spmv_dot_kernel<T, kFold><<<(unsigned)blocks, repro::kThreads, 0, s>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)z, (const T*)p,
      (const T*)beta, (T*)pn, (T*)y, (T*)partials, rows, w, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::sum_partials_kernel<T><<<1, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)pap);
  return (int)cudaGetLastError();
}

// Lane j0 + jj of every vector sits at row * sr + lane * sl.
template <typename T, int K, bool kFold>
__global__ void __launch_bounds__(repro::kThreads)
spmm_dot_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ z, const T* __restrict__ p,
                const T* __restrict__ beta_ptr, T* __restrict__ pn,
                T* __restrict__ y, T* __restrict__ partials, int64_t rows,
                int w, int group, int k, int64_t sr, int64_t sl) {
  __shared__ T sh[32 * K];
  const int j0 = blockIdx.y * K;
  T beta[K], acc[K];
#pragma unroll
  for (int jj = 0; jj < K; ++jj) {
    beta[jj] = (kFold && j0 + jj < k) ? beta_ptr[j0 + jj] : T(0);
    acc[jj] = T(0);
  }
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = t / group;
  const int g = (int)(t % group);
  if (r < rows) {
    const int64_t base = r * w;
    for (int s = g; s < w; s += group) {
      const T v = vals[base + s];
      const int64_t c = cols[base + s];
#pragma unroll
      for (int jj = 0; jj < K; ++jj)
        if (j0 + jj < k) {
          const int64_t o = c * sr + (int64_t)(j0 + jj) * sl;
          const T xv = kFold ? repro::fold(__ldg(z + o), beta[jj], __ldg(p + o))
                             : __ldg(z + o);
          acc[jj] = repro::fma_rn(v, xv, acc[jj]);
        }
    }
  }
#pragma unroll
  for (int jj = 0; jj < K; ++jj) {
    const T sum = repro::group_sum(acc[jj], group);
    acc[jj] = T(0);                       // now lane jj's pap contribution
    if (r < rows && g == 0 && j0 + jj < k) {
      const int64_t o = r * sr + (int64_t)(j0 + jj) * sl;
      const T pr = kFold ? repro::fold(z[o], beta[jj], p[o]) : z[o];
      if (kFold) pn[o] = pr;
      y[o] = sum;
      acc[jj] = repro::mul_rn(pr, sum);
    }
  }
  repro::block_sum_lanes<T, K>(acc, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int jj = 0; jj < K; ++jj)
      if (j0 + jj < k) partials[(int64_t)(j0 + jj) * gridDim.x + blockIdx.x] = acc[jj];
  }
}

template <typename T, int K, bool kFold>
int launch_spmm_chunk(const void* cols, const void* vals, const void* z,
                      const void* p, const void* beta, void* pn, void* y,
                      void* partials, int64_t rows, int32_t w, int32_t group,
                      int64_t blocks, int32_t k, int64_t sr, int64_t sl,
                      cudaStream_t s) {
  const dim3 grid((unsigned)blocks, (unsigned)((k + K - 1) / K));
  spmm_dot_kernel<T, K, kFold><<<grid, repro::kThreads, 0, s>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)z, (const T*)p,
      (const T*)beta, (T*)pn, (T*)y, (T*)partials, rows, w, group, k, sr, sl);
  return (int)cudaGetLastError();
}

template <typename T, bool kFold>
int launch_spmm(const void* cols, const void* vals, const void* z,
                const void* p, const void* beta, void* pn, void* y,
                void* partials, void* pap, int64_t rows, int32_t w,
                int32_t group, int64_t nblocks, int32_t k, int64_t sr,
                int64_t sl, void* stream) {
  if (rows <= 0 || w <= 0 || k <= 0 || group < 1 || group > 32 ||
      (group & (group - 1)) || sr < 0 || sl < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (repro::lane_chunk(k)) {
    case 1: err = launch_spmm_chunk<T, 1, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, s); break;
    case 2: err = launch_spmm_chunk<T, 2, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, s); break;
    case 4: err = launch_spmm_chunk<T, 4, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, s); break;
    default: err = launch_spmm_chunk<T, 8, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, s); break;
  }
  if (err != (int)cudaSuccess) return err;
  repro::sum_partials_kernel<T><<<(unsigned)k, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)pap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ell_spmv_pfold_dot_f32(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, void* stream) {
  return launch<float, true>(cols, vals, z, p, beta, pn, y, partials, pap,
                             rows, w, group, nblocks, stream);
}

extern "C" int repro_ell_spmv_pfold_dot_f64(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, void* stream) {
  return launch<double, true>(cols, vals, z, p, beta, pn, y, partials, pap,
                              rows, w, group, nblocks, stream);
}

// The solver layout: Z, P, P' and Y (k, rows) row-major.
extern "C" int repro_ell_spmm_pfold_dot_f32(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, int32_t k,
    void* stream) {
  return launch_spmm<float, true>(cols, vals, z, p, beta, pn, y, partials,
                                  pap, rows, w, group, nblocks, k, 1, rows,
                                  stream);
}

extern "C" int repro_ell_spmm_pfold_dot_f64(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, int32_t k,
    void* stream) {
  return launch_spmm<double, true>(cols, vals, z, p, beta, pn, y, partials,
                                   pap, rows, w, group, nblocks, k, 1, rows,
                                   stream);
}

extern "C" int repro_ell_spmv_dot_f32(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, void* stream) {
  return launch<float, false>(cols, vals, x, nullptr, nullptr, nullptr, y,
                              partials, pap, rows, w, group, nblocks, stream);
}

extern "C" int repro_ell_spmv_dot_f64(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, void* stream) {
  return launch<double, false>(cols, vals, x, nullptr, nullptr, nullptr, y,
                               partials, pap, rows, w, group, nblocks, stream);
}

// X and Y (rows, k) addressed as row * sr + lane * sl.
extern "C" int repro_ell_spmm_dot_f32(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, int32_t k, int64_t sr, int64_t sl, void* stream) {
  return launch_spmm<float, false>(cols, vals, x, nullptr, nullptr, nullptr,
                                   y, partials, pap, rows, w, group, nblocks,
                                   k, sr, sl, stream);
}

extern "C" int repro_ell_spmm_dot_f64(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, int32_t k, int64_t sr, int64_t sl, void* stream) {
  return launch_spmm<double, false>(cols, vals, x, nullptr, nullptr, nullptr,
                                    y, partials, pap, rows, w, group, nblocks,
                                    k, sr, sl, stream);
}
