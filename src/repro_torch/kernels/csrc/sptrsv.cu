// sptrsv_solve_dot: the whole level-scheduled lower-triangular solve
// L x = b, plus pp = dot(wdot, x), in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sptrsv.py:132
// (sptrsv_solve_dot, pallas_call at :165), the two triangular solves of
// every block-IC(0) PCG iteration (precond.make_fused_ic0_apply).
//
// For each level in order, and each real row r of the level:
//   x[r] = (b[r] - sum_slots (c != r ? v : 0) * x[c]) * dinv[r]
// Padded rows of x stay 0 (the wrapper allocates x zeroed).
//
// What bounds it on the H100.  Bytes: at lap2d_1024 in float64 the
// factor's padded ELL is 1,048,576 x 8 slots x 12 B = 100.7 MB, b, dinv
// and wdot in and x out 33.6 MB, the level list 4.2 MB: about 138 MB, or
// ~41 us at 3.35 TB/s.  That is not what bounds it.  The chain of levels
// does: 2047 levels at lap2d_1024, each of which needs the x values of
// earlier levels, so each level costs one grid-wide barrier plus one
// dependent round trip (level list -> row -> x[c] -> x[r]) to memory,
// whatever the width of the level.
//
// Design.  The Pallas body's one-hot compare/select scatter is O(rows_p)
// work per solved row; here a direct indexed store replaces it.
//   * One cooperative launch per solve (cudaLaunchCooperativeKernel), with
//     cooperative_groups::this_grid().sync() after each level.  The grid
//     is what can be co-resident (occupancy x SMs), cut to the blocks the
//     widest level can use: a block with no row in any level would only
//     add to every barrier.  A refused cooperative launch returns its
//     error; the wrapper raises.
//   * Compact level lists: level_ptr (L+1) and level_rows (n), the
//     schedule's rows in its order.  A grid-stride loop over a level's
//     rows gives one thread a row; the thread reads cols[r]/vals[r]
//     directly and sums the w slots in slot order (product, then sum,
//     each rounded, as the plain version's elementwise product and row
//     sum are: a row with at most two off-diagonal entries comes out
//     bitwise equal to the plain version).
//   * x is written and read in the same launch.  L1 is not coherent
//     across SMs, so a cached read after a barrier could return a stale
//     line: x is read with __ldcg (L2 only) and never through a const
//     __restrict__ pointer.  Everything else is read-only in the launch.
//   * The in-stream dot is deterministic, with no float atomics: each
//     thread accumulates wdot[r] * x[r] over its rows in a fixed
//     row-to-thread assignment, each block reduces its threads into
//     partials[block], and after a final barrier block 0 sums the
//     partials in index order.  The same inputs on the same card give the
//     same bits.


// sptrsv_level_step: ONE wavefront of the level-scheduled lower solve.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sptrsv.py:64
// (sptrsv_level_step, pallas_call :81) together with the gather and the
// scatter its wrapper runs around it (src/repro/kernels/ops.py:181-204).
// It computes what that op computes, not its block structure: x has n + 1
// slots (the last, n, is the sentinel slot), and for each entry id of the
// level's row list (W,):
//   lr = min(id, rows_p - 1)
//   xr = (b[lr] - sum_s (cols[lr,s] != lr ? vals[lr,s] : 0)
//                       * x[min(cols[lr,s], n)]) / diag[min(id, n - 1)]
//   x_out[id] = xr  where id <= n; ids past n are dropped.
// The clamps are the JAX op's: its gathers clamp out-of-range ids, and a
// padded row of a factor whose rows_p >= n + 2 holds columns past n.  It
// divides by diag where sptrsv_solve_dot multiplies by dinv, and sums
// every slot (a masked slot adds 0 * x, as the JAX op's does).
//
// What bounds it on the H100: the launch.  A level of lap2d_1024's IC(0)
// factor has at most 1024 rows: ~100 KB of factor rows, b, diag and x
// gathers, 30 ns at 3.35 TB/s, against a few microseconds to launch and
// drain a kernel.  A whole solve is one launch a level (2047 at
// lap2d_1024), where sptrsv_solve_dot keeps one cooperative launch and
// pays a grid barrier a level instead.
//
// Design: one thread a row of the level, the slots summed in order
// (product, then sum, each rounded), the quotient by div_rn.  The kernel
// reads x_in and writes x_out.  The wrapper makes x_out a copy of x_in,
// so the op stays functional; x_out may also be x_in itself (a solve
// that updates x level by level).  That is legal: a level's rows read
// only x of earlier levels, never of their own (the masked diagonal slot
// reads x[r] but multiplies it by 0, and x[r] is finite before and
// after), and the sentinel slot is read only through zero-valued
// padding.  So x is read through a plain pointer, not a const
// __restrict__ one: no read depends on a write of the same launch.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
sptrsv_solve_dot_kernel(const int* __restrict__ cols,
                        const T* __restrict__ vals,
                        const T* __restrict__ dinv, const T* __restrict__ b,
                        const T* __restrict__ wdot,
                        const int* __restrict__ level_ptr,
                        const int* __restrict__ level_rows, int n_levels,
                        int w, T* x, T* partials, T* pp) {
  __shared__ T sh[32];
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  T acc = T(0);
  for (int l = 0; l < n_levels; ++l) {
    const int end = level_ptr[l + 1];
    for (int i = level_ptr[l] + tid; i < end; i += stride) {
      const int r = level_rows[i];
      const int64_t base = (int64_t)r * w;
      T sum = T(0);
      for (int k = 0; k < w; ++k) {
        const int c = cols[base + k];
        if (c != r) sum = repro::add_rn(sum, repro::mul_rn(vals[base + k], __ldcg(x + c)));
      }
      const T xr = repro::mul_rn(repro::sub_rn(b[r], sum), dinv[r]);
      x[r] = xr;
      if (wdot != nullptr) acc = repro::add_rn(acc, repro::mul_rn(wdot[r], xr));
    }
    grid.sync();
  }
  if (wdot == nullptr) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *pp = T(0);
    return;
  }
  acc = repro::block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  grid.sync();
  if (blockIdx.x != 0) return;
  T s = T(0);
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
    s += __ldcg(partials + i);
  s = repro::block_sum(s, sh);
  if (threadIdx.x == 0) *pp = s;
}

template <typename T>
int coresident_blocks() {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sptrsv_solve_dot_kernel<T>, repro::kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* dinv,
           const void* b, const void* wdot, const void* level_ptr,
           const void* level_rows, void* x, void* partials, void* pp,
           int32_t n_levels, int32_t w, int32_t blocks, void* stream) {
  if (n_levels <= 0 || w <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const int* c = (const int*)cols;
  const T* v = (const T*)vals;
  const T* d = (const T*)dinv;
  const T* bb = (const T*)b;
  const T* wd = (const T*)wdot;
  const int* lp = (const int*)level_ptr;
  const int* lr = (const int*)level_rows;
  T* xx = (T*)x;
  T* part = (T*)partials;
  T* out = (T*)pp;
  int nl = n_levels, ww = w;
  void* args[] = {&c, &v, &d, &bb, &wd, &lp, &lr, &nl, &ww, &xx, &part, &out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)sptrsv_solve_dot_kernel<T>, dim3((unsigned)blocks),
      dim3(repro::kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();   // clear it: the wrapper raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
sptrsv_level_step_kernel(const int* __restrict__ cols,
                         const T* __restrict__ vals,
                         const T* __restrict__ diag, const T* __restrict__ b,
                         const int* __restrict__ level_rows, const T* x_in,
                         T* x_out, int wl, int64_t rows_p, int w, int64_t n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wl) return;
  const int64_t id = level_rows[i];
  if (id < 0) return;                  // schedules hold ids >= 0
  const int64_t lr = id < rows_p - 1 ? id : rows_p - 1;
  const int64_t base = lr * w;
  T sum = T(0);
  for (int s = 0; s < w; ++s) {
    const int64_t c = cols[base + s];
    const T v = c != lr ? vals[base + s] : T(0);
    sum = repro::add_rn(sum, repro::mul_rn(v, x_in[c < n ? c : n]));
  }
  const T xr = repro::div_rn(repro::sub_rn(b[lr], sum),
                             diag[id < n - 1 ? id : n - 1]);
  if (id <= n) x_out[id] = xr;
}

template <typename T>
int launch_level_step(const void* cols, const void* vals, const void* diag,
                      const void* b, const void* level_rows, const void* x_in,
                      void* x_out, int32_t wl, int64_t rows_p, int32_t w,
                      int64_t n, void* stream) {
  if (wl <= 0 || rows_p <= 0 || w <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((wl + repro::kThreads - 1) / repro::kThreads);
  sptrsv_level_step_kernel<T><<<blocks, repro::kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)vals, (const T*)diag, (const T*)b,
      (const int*)level_rows, (const T*)x_in, (T*)x_out, wl, rows_p, w, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of sptrsv_solve_dot_kernel that can be co-resident on the current
// device (occupancy x SMs), or minus the CUDA error.
extern "C" int repro_sptrsv_coresident_f32() { return coresident_blocks<float>(); }
extern "C" int repro_sptrsv_coresident_f64() { return coresident_blocks<double>(); }

extern "C" int repro_sptrsv_solve_dot_f32(
    const void* cols, const void* vals, const void* dinv, const void* b,
    const void* wdot, const void* level_ptr, const void* level_rows, void* x,
    void* partials, void* pp, int32_t n_levels, int32_t w, int32_t blocks,
    void* stream) {
  return launch<float>(cols, vals, dinv, b, wdot, level_ptr, level_rows, x,
                       partials, pp, n_levels, w, blocks, stream);
}

extern "C" int repro_sptrsv_solve_dot_f64(
    const void* cols, const void* vals, const void* dinv, const void* b,
    const void* wdot, const void* level_ptr, const void* level_rows, void* x,
    void* partials, void* pp, int32_t n_levels, int32_t w, int32_t blocks,
    void* stream) {
  return launch<double>(cols, vals, dinv, b, wdot, level_ptr, level_rows, x,
                        partials, pp, n_levels, w, blocks, stream);
}

extern "C" int repro_sptrsv_level_step_f32(
    const void* cols, const void* vals, const void* diag, const void* b,
    const void* level_rows, const void* x_in, void* x_out, int32_t wl,
    int64_t rows_p, int32_t w, int64_t n, void* stream) {
  return launch_level_step<float>(cols, vals, diag, b, level_rows, x_in, x_out,
                                  wl, rows_p, w, n, stream);
}

extern "C" int repro_sptrsv_level_step_f64(
    const void* cols, const void* vals, const void* diag, const void* b,
    const void* level_rows, const void* x_in, void* x_out, int32_t wl,
    int64_t rows_p, int32_t w, int64_t n, void* stream) {
  return launch_level_step<double>(cols, vals, diag, b, level_rows, x_in,
                                   x_out, wl, rows_p, w, n, stream);
}
