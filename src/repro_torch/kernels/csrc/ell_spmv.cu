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
