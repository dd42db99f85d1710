// ell_spmv: y = A x over padded ELL.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmv.py:53
// (ell_spmv), which forms the initial residual r = b - A x0 of every solve.
//
// What bounds it on the H100: memory.  A call streams the (rows_p, W)
// int32 cols and float vals once -- 12 bytes per slot in float64, 8 in
// float32 -- for two flops per slot, far below the ~10 flops per byte at
// which float64 arithmetic would start to matter.  At the main-path shape
// (1,048,576 x 8, float64) the matrix is 100.7 MB: about 30 us at 3.35 TB/s.
//
// Design: the TPU kernel keeps all of x resident in VMEM and streams
// (TM, TW) matrix tiles past it.  Here x (8.4 MB at the main-path size) is
// gathered through the 50 MB L2, and the matrix stream is made coalesced by
// giving each row a group of G consecutive lanes (G = the power of two
// >= W, at most 32): lane g reads slots g, g+G, ..., so a warp reads 32
// consecutive slots of cols and vals per step.  The group then sums its
// lanes with shuffles in a fixed order -- no shared memory, no atomics.

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
// Design: the row groups of ell_spmv_kernel.  A thread loads each of its
// slots' column and value once and applies them to every lane of its chunk
// (K lanes in registers, K the power of two >= k, at most 8; wider
// batches run in gridDim.y chunks).  Lane j's sum runs the same fma chain
// and the same group shuffles as ell_spmv on lane j alone, so Y[j] does
// not depend on k and equals ell_spmv's y bit for bit.  The group's
// threads all hold every lane's sum; thread jj % G writes lane jj.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
ell_spmv_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                int w, int group) {
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
           int64_t rows, int32_t w, int32_t group, void* stream) {
  if (rows <= 0 || w <= 0 || group < 1 || group > 32 || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  ell_spmv_kernel<T><<<(unsigned)blocks, repro::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (T*)y, rows, w, group);
  return (int)cudaGetLastError();
}

template <typename T, int K>
__global__ void __launch_bounds__(repro::kThreads)
ell_spmm_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                int64_t ldx, int w, int group, int k) {
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
                      int32_t group, int32_t k, void* stream) {
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)blocks, (unsigned)((k + K - 1) / K));
  ell_spmm_kernel<T, K><<<grid, repro::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (T*)y, rows, ldx, w,
      group, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spmm(const void* cols, const void* vals, const void* x, void* y,
                int64_t rows, int64_t ldx, int32_t w, int32_t group,
                int32_t k, void* stream) {
  if (rows <= 0 || w <= 0 || ldx <= 0 || k <= 0 || group < 1 || group > 32 ||
      (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  switch (repro::lane_chunk(k)) {
    case 1: return launch_spmm_chunk<T, 1>(cols, vals, x, y, rows, ldx, w, group, k, stream);
    case 2: return launch_spmm_chunk<T, 2>(cols, vals, x, y, rows, ldx, w, group, k, stream);
    case 4: return launch_spmm_chunk<T, 4>(cols, vals, x, y, rows, ldx, w, group, k, stream);
    default: return launch_spmm_chunk<T, 8>(cols, vals, x, y, rows, ldx, w, group, k, stream);
  }
}

}  // namespace

extern "C" int repro_ell_spmv_f32(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int32_t w, int32_t group, void* stream) {
  return launch<float>(cols, vals, x, y, rows, w, group, stream);
}

extern "C" int repro_ell_spmv_f64(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int32_t w, int32_t group, void* stream) {
  return launch<double>(cols, vals, x, y, rows, w, group, stream);
}

extern "C" int repro_ell_spmm_f32(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int64_t ldx, int32_t w, int32_t group,
                                  int32_t k, void* stream) {
  return launch_spmm<float>(cols, vals, x, y, rows, ldx, w, group, k, stream);
}

extern "C" int repro_ell_spmm_f64(const void* cols, const void* vals,
                                  const void* x, void* y, int64_t rows,
                                  int64_t ldx, int32_t w, int32_t group,
                                  int32_t k, void* stream) {
  return launch_spmm<double>(cols, vals, x, y, rows, ldx, w, group, k, stream);
}
