// ell_spmv_pfold_dot: p' = z + beta*p, y = A p', pap = dot(p', y).
// ell_spmm_pfold_dot: the same for k right-hand sides in the solver
// layout: Z, P, P' and Y (k, rows) row-major, beta and pap (k,).
// ell_spmv_dot and ell_spmm_dot: the unfolded twins, y = A x and
// pap = dot(x, y); ell_spmm_dot takes the JAX kernel's layout X (rows, k),
// addressed through a row stride sr and a lane stride sl, so a row-major
// X and the transposed view of a contiguous (k, rows) one both pass
// without a copy, and Y is written in X's layout.
//
// Replace the Pallas TPU kernels src/repro/kernels/spmv_dot.py:217
// (ell_spmv_pfold_dot), :296 (ell_spmm_pfold_dot, body :267), :67
// (ell_spmv_dot, pallas_call :90) and :134 (ell_spmm_dot, pallas_call
// :158).  The p-fold pair is the matrix half of every PCG iteration, one
// right-hand side and batched.
//
// What bounds them on the H100: memory.  A call streams the padded ELL
// matrix once for all k lanes (12 bytes a slot in float64), reads z and p
// and writes p' and y (32 bytes a row and lane in float64, 16 without the
// fold); three flops a slot and lane plus the fold.  At the main-path
// shape (1,048,576 x 8, float64): 134.2 MB, 40.1 us at 3.35 TB/s, for
// ell_spmv_pfold_dot; 369.1 MB, 110.2 us, for ell_spmm_pfold_dot at k = 8;
// 117.4 MB (35.1 us) and 234.9 MB (70.1 us) for the dot twins.
//
// The fold.  The Pallas bodies write all of p' on grid step (0, 0) into a
// resident output block that later steps gather from (spmv_dot.py:193-197,
// :273-275).  Hopper blocks run in no order, so no block can rely on
// another having written p' first.  Each gather therefore recomputes
// z[c] + beta*p[c], and each row's owner writes p'[r] once.  A separate
// fold pass would write p' and read it back, 16 bytes a row and lane more
// in float64 (12% of the 1-D bound); the recompute costs a second gather a
// slot, which hits L2 on the banded and stencil matrices the solver runs.
// repro::fold rounds product then sum, so the gathered and the stored p'
// are the same bits.  Without the fold the gather reads x itself: no
// beta = 0 stands in for it, because 0 * p is not 0 where p holds an inf
// or a NaN.
//
// The sums, which every variant computes to the same bits.  y[r]: the
// row's G = group_size(W) virtual lanes (lane g an fma chain from 0 over
// slots g, g + G, ...) combined by repro::group_sum's xor butterfly, as in
// ell_spmv.cu.  pap: the rows' p'[r] * y[r] in "virtual blocks" of 256 / G
// consecutive rows, each summed in the pairing of repro::block_sum over a
// 256-thread block of the row-group design, into one partial a block
// (partials (k, nblocks), a lane's sequence contiguous); a second launch
// of k blocks sums each lane's partials in index order.  No float atomics:
// a run repeats bit for bit.  Nothing depends on k or the strides, so lane
// j of a batched call is bitwise the 1-D call on lane j.
//
// Two variants (spmv_dot.py; the rule is ell_spmv.spmv_variant):
//   * rows, for W a multiple of 4 up to 16 with 16-byte aligned cols and
//     vals (the engine pads widths to multiples of 8).  A thread owns a
//     row.  It loads the row's cols and vals once, with 16-byte streaming
//     loads (__ldcs, evict-first, so the 100 MB matrix stream does not
//     push the gathered vectors out of the 50 MB L2), keeps them in
//     registers, and runs the lanes one after another: lane j's gathers go
//     out in two waves before their adds (repro::row_dot_halves, the
//     butterfly's first stage), P'[j, r] and Y[j, r] are stored with
//     streaming stores.  A warp's gather for one slot and lane reads 32
//     consecutive rows' columns of one plane, coalesced on the stencil and
//     banded matrices.  pap's virtual blocks are one warp at G = 8 (two at
//     G = 16, one over two passes at G = 4): repro::vblock_sum runs
//     block_sum's additions with shuffles alone, no barrier.  The kernel
//     is compiled for each W and for unit row stride; its registers are
//     capped so that five blocks share an SM (three at W > 8), and the
//     warps stride over the rows on that persistent grid (ell_spmv.py
//     rows_grid).  Occupancy is what moves this kernel: uncapped, it held
//     96 registers a thread and two blocks an SM, and ran far slower.
//   * group, the first slice's design, for every other operand (the wide
//     skewed ELL, W = 264, among them): a row gets G consecutive lanes, so
//     a warp reads 32 consecutive slots of cols and vals a step; the group
//     sums its lanes with shuffles and a block_sum (two barriers) sums the
//     block's rows.  The batched kernel carries K <= 8 lanes a thread in
//     registers (wider batches run in gridDim.y chunks).
// The wrapper's choice is a function of the operands' shape, type and
// alignment, never of a launch.  Both variants leave the partials to a
// second launch of k blocks, one a lane: summing them in the kernel's
// last block instead (an integer ticket) was slower at every width and k,
// since one block then sums the lanes in turn (PERF.md).

#include "common.cuh"

namespace {

// The group variant.  One row per group of `group` lanes.  kFold: the
// gathered vector is z + beta * p, recomputed at each gather, and the
// row's owner stores p'[r]; otherwise it is z itself (p, beta and pn are
// unused).
template <typename T, bool kFold>
__global__ void __launch_bounds__(repro::kThreads)
spmv_dot_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ z, const T* __restrict__ p,
                const T* __restrict__ beta_ptr, T* __restrict__ pn,
                T* __restrict__ y, T* __restrict__ partials, int64_t rows,
                int w, int group, unsigned long long* launches) {
  repro::count_launch(launches);
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
           unsigned long long* launches, void* stream) {
  if (rows <= 0 || w <= 0 || group < 1 || group > 32 || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  spmv_dot_kernel<T, kFold><<<(unsigned)blocks, repro::kThreads, 0, s>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)z, (const T*)p,
      (const T*)beta, (T*)pn, (T*)y, (T*)partials, rows, w, group, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::sum_partials_kernel<T><<<1, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)pap);
  return (int)cudaGetLastError();
}

// The group variant for K lanes a thread.  Lane j0 + jj of every vector
// sits at row * sr + lane * sl.
template <typename T, int K, bool kFold>
__global__ void __launch_bounds__(repro::kThreads)
spmm_dot_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ z, const T* __restrict__ p,
                const T* __restrict__ beta_ptr, T* __restrict__ pn,
                T* __restrict__ y, T* __restrict__ partials, int64_t rows,
                int w, int group, int k, int64_t sr, int64_t sl,
                unsigned long long* launches) {
  repro::count_launch(launches);
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
                      unsigned long long* launches, cudaStream_t s) {
  const dim3 grid((unsigned)blocks, (unsigned)((k + K - 1) / K));
  spmm_dot_kernel<T, K, kFold><<<grid, repro::kThreads, 0, s>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)z, (const T*)p,
      (const T*)beta, (T*)pn, (T*)y, (T*)partials, rows, w, group, k, sr, sl,
      launches);
  return (int)cudaGetLastError();
}

template <typename T, bool kFold>
int launch_spmm(const void* cols, const void* vals, const void* z,
                const void* p, const void* beta, void* pn, void* y,
                void* partials, void* pap, int64_t rows, int32_t w,
                int32_t group, int64_t nblocks, int32_t k, int64_t sr,
                int64_t sl, unsigned long long* launches, void* stream) {
  if (rows <= 0 || w <= 0 || k <= 0 || group < 1 || group > 32 ||
      (group & (group - 1)) || sr < 0 || sl < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_block = repro::kThreads / group;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (repro::lane_chunk(k)) {
    case 1: err = launch_spmm_chunk<T, 1, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, launches, s); break;
    case 2: err = launch_spmm_chunk<T, 2, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, launches, s); break;
    case 4: err = launch_spmm_chunk<T, 4, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, launches, s); break;
    default: err = launch_spmm_chunk<T, 8, kFold>(cols, vals, z, p, beta, pn, y, partials, rows, w, group, blocks, k, sr, sl, launches, s); break;
  }
  if (err != (int)cudaSuccess) return err;
  repro::sum_partials_kernel<T><<<(unsigned)k, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)pap);
  return (int)cudaGetLastError();
}

// Blocks of the rows kernel an SM can hold: its registers are capped to
// fit them (__launch_bounds__), and the wrapper's grid is this many blocks
// an SM (ell_spmv.py rows_grid; the A/B is in PERF.md).
__host__ __device__ constexpr int rows_blocks_per_sm(int g) {
  return g <= 8 ? 5 : 3;
}

__host__ __device__ constexpr int group_of(int w) {
  return w <= 4 ? 4 : w <= 8 ? 8 : 16;
}

// The rows variant for ELL width W (4, 8, 12 or 16; G = group_of(W)
// virtual lanes): a thread owns a row, a warp 32 * P consecutive rows at a
// time (P = row_passes<G>(), so that a warp holds whole virtual blocks),
// the grid's warps striding over them.  Every lane of a warp runs the loop
// the same number of times, since vblock_sum shuffles; rows past `rows`
// add +0 to pap, as the group kernels' idle threads do.  Lane j of every
// vector sits at row * sr + j * sl, but y's lane j at row * sr + j * syl;
// kUnit: sr == 1.  The row's gathers go out in two waves
// (row_dot_halves), and p' and y are stored with streaming stores
// (__stcs): both let five blocks share an SM.  kDot false compiles the
// dot out (ell_spmm: y alone, no pap, no partials, no second launch).
template <typename T, int W, bool kFold, bool kUnit, bool kDot = true>
__global__ void __launch_bounds__(repro::kThreads,
                                  rows_blocks_per_sm(group_of(W)))
spmv_dot_rows_kernel(const int32_t* __restrict__ cols,
                     const T* __restrict__ vals, const T* __restrict__ z,
                     const T* __restrict__ p, const T* __restrict__ beta,
                     T* __restrict__ pn, T* __restrict__ y,
                     T* __restrict__ partials, int64_t rows,
                     int64_t nblocks, int k, int64_t sr, int64_t sl,
                     int64_t syl, unsigned long long* launches) {
  repro::count_launch(launches);
  constexpr int G = group_of(W);
  constexpr int P = repro::row_passes<G>();
  constexpr int R = repro::kThreads / G;       // rows of a virtual block
  constexpr int kWarps = repro::kThreads >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t units = (rows + 32 * P - 1) / (32 * P);
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t u = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       u < units; u += stride) {
    const int64_t base = u * 32 * P;
    int c[P][G];
    T v[P][G];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int64_t r = base + 32 * q + lane;
      if (r < rows)
        repro::load_row<T, G>(cols + r * W, vals + r * W, W, c[q], v[q]);
    }
    for (int j = 0; j < k; ++j) {
      const T bj = kFold ? beta[j] : T(0);
      const T* zj = z + j * sl;
      const T* pj = kFold ? p + j * sl : nullptr;
      T contrib[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int64_t r = base + 32 * q + lane;
        contrib[q] = T(0);
        if (r < rows) {
          const T acc = repro::row_dot_halves<T, G>(c[q], v[q], W, [=](int col) {
            const int64_t o = kUnit ? (int64_t)col : (int64_t)col * sr;
            if constexpr (kFold)
              return repro::fold(__ldg(zj + o), bj, __ldg(pj + o));
            else
              return __ldg(zj + o);
          });
          const int64_t o = kUnit ? r : r * sr;
          __stcs(y + o + j * syl, acc);
          if constexpr (kDot) {
            const T pr = kFold ? repro::fold(zj[o], bj, pj[o]) : zj[o];
            if (kFold) __stcs(pn + o + j * sl, pr);
            contrib[q] = repro::mul_rn(pr, acc);
          }
        }
      }
      if constexpr (kDot) {
        const T part = repro::vblock_sum<T, G>(contrib);
        if (lane % R == 0) {
          const int64_t b = (base + lane) / R;
          if (b < nblocks) partials[j * nblocks + b] = part;
        }
      }
    }
  }
}

// sr == 1 (the solver layout, the 1-D calls) takes the kernel whose
// gathers index the lane's vector with the column itself; a second launch
// of k blocks sums each lane's partials.
template <typename T, int W, bool kFold>
int start_rows(const void* cols, const void* vals, const void* z,
               const void* p, const void* beta, void* pn, void* y,
               void* partials, void* pap, int64_t rows, int64_t nblocks,
               int32_t k, int64_t sr, int64_t sl, int32_t grid,
               unsigned long long* launches, cudaStream_t s) {
  constexpr int64_t rows_per_block = repro::kThreads / group_of(W);
  if (nblocks != (rows + rows_per_block - 1) / rows_per_block)
    return (int)cudaErrorInvalidValue;
  auto kernel = sr == 1 ? spmv_dot_rows_kernel<T, W, kFold, true>
                        : spmv_dot_rows_kernel<T, W, kFold, false>;
  kernel<<<(unsigned)grid, repro::kThreads, 0, s>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)z, (const T*)p,
      (const T*)beta, (T*)pn, (T*)y, (T*)partials, rows, nblocks, k, sr, sl,
      sl, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::sum_partials_kernel<T><<<(unsigned)k, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, nblocks, (T*)pap);
  return (int)cudaGetLastError();
}

template <typename T, bool kFold>
int launch_rows(const void* cols, const void* vals, const void* z,
                const void* p, const void* beta, void* pn, void* y,
                void* partials, void* pap, int64_t rows, int32_t w,
                int64_t nblocks, int32_t k, int64_t sr, int64_t sl,
                int32_t grid, unsigned long long* launches, cudaStream_t s) {
#define WIDTH(W)                                                             \
  start_rows<T, W, kFold>(cols, vals, z, p, beta, pn, y, partials, pap,      \
                          rows, nblocks, k, sr, sl, grid, launches, s)
  switch (w) {
    case 4: return WIDTH(4);
    case 8: return WIDTH(8);
    case 12: return WIDTH(12);
    default: return WIDTH(16);
  }
#undef WIDTH
}

template <typename T>
int launch_rows_any(const void* cols, const void* vals, const void* z,
                    const void* p, const void* beta, void* pn, void* y,
                    void* partials, void* pap, int64_t rows, int32_t w,
                    int64_t nblocks, int32_t k, int64_t sr, int64_t sl,
                    int32_t grid, int32_t fold, unsigned long long* launches,
                    void* stream) {
  if (rows <= 0 || w <= 0 || w > 16 || w % 4 || k <= 0 || grid <= 0 ||
      sr < 0 || sl < 0 || ((uintptr_t)cols | (uintptr_t)vals) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return fold ? launch_rows<T, true>(cols, vals, z, p, beta, pn, y, partials,
                                     pap, rows, w, nblocks, k, sr, sl, grid,
                                     launches, s)
              : launch_rows<T, false>(cols, vals, z, nullptr, nullptr, nullptr,
                                      y, partials, pap, rows, w, nblocks, k,
                                      sr, sl, grid, launches, s);
}

// ell_spmm on the rows kernel: X (k, ldx) and Y (k, rows) row-major, the
// dot compiled out; `grid` blocks (ell_spmv.py rows_grid).
template <typename T>
int launch_spmm_rows(const void* cols, const void* vals, const void* x,
                     void* y, int64_t rows, int32_t w, int32_t k, int64_t ldx,
                     int32_t grid, unsigned long long* launches, void* stream) {
  if (rows <= 0 || w <= 0 || w > 16 || w % 4 || k <= 0 || ldx <= 0 ||
      grid <= 0 || ((uintptr_t)cols | (uintptr_t)vals) % 16)
    return (int)cudaErrorInvalidValue;
#define WIDTH(W)                                                             \
  spmv_dot_rows_kernel<T, W, false, true, false>                             \
      <<<(unsigned)grid, repro::kThreads, 0, (cudaStream_t)stream>>>(         \
          (const int32_t*)cols, (const T*)vals, (const T*)x, nullptr,        \
          nullptr, nullptr, (T*)y, nullptr, rows, 0, k, 1, ldx, rows,      \
          launches)
  switch (w) {
    case 4: WIDTH(4); break;
    case 8: WIDTH(8); break;
    case 12: WIDTH(12); break;
    default: WIDTH(16); break;
  }
#undef WIDTH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ell_spmm_rows_f32(const void* cols, const void* vals,
                                       const void* x, void* y, int64_t rows,
                                       int32_t w, int32_t k, int64_t ldx,
                                       int32_t grid, void* launches, void* stream) {
  return launch_spmm_rows<float>(cols, vals, x, y, rows, w, k, ldx, grid,
                                 (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmm_rows_f64(const void* cols, const void* vals,
                                       const void* x, void* y, int64_t rows,
                                       int32_t w, int32_t k, int64_t ldx,
                                       int32_t grid, void* launches, void* stream) {
  return launch_spmm_rows<double>(cols, vals, x, y, rows, w, k, ldx, grid,
                                  (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmv_pfold_dot_f32(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, void* launches, void* stream) {
  return launch<float, true>(cols, vals, z, p, beta, pn, y, partials, pap,
                             rows, w, group, nblocks, (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmv_pfold_dot_f64(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, void* launches, void* stream) {
  return launch<double, true>(cols, vals, z, p, beta, pn, y, partials, pap,
                              rows, w, group, nblocks, (unsigned long long*)launches, stream);
}

// The solver layout: Z, P, P' and Y (k, rows) row-major.
extern "C" int repro_ell_spmm_pfold_dot_f32(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, int32_t k,
    void* launches, void* stream) {
  return launch_spmm<float, true>(cols, vals, z, p, beta, pn, y, partials,
                                  pap, rows, w, group, nblocks, k, 1, rows,
                                  (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmm_pfold_dot_f64(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int32_t group, int64_t nblocks, int32_t k,
    void* launches, void* stream) {
  return launch_spmm<double, true>(cols, vals, z, p, beta, pn, y, partials,
                                   pap, rows, w, group, nblocks, k, 1, rows,
                                   (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmv_dot_f32(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, void* launches, void* stream) {
  return launch<float, false>(cols, vals, x, nullptr, nullptr, nullptr, y,
                              partials, pap, rows, w, group, nblocks, (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmv_dot_f64(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, void* launches, void* stream) {
  return launch<double, false>(cols, vals, x, nullptr, nullptr, nullptr, y,
                               partials, pap, rows, w, group, nblocks, (unsigned long long*)launches, stream);
}

// X and Y (rows, k) addressed as row * sr + lane * sl.
extern "C" int repro_ell_spmm_dot_f32(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, int32_t k, int64_t sr, int64_t sl, void* launches, void* stream) {
  return launch_spmm<float, false>(cols, vals, x, nullptr, nullptr, nullptr,
                                   y, partials, pap, rows, w, group, nblocks,
                                   k, sr, sl, (unsigned long long*)launches, stream);
}

extern "C" int repro_ell_spmm_dot_f64(
    const void* cols, const void* vals, const void* x, void* y,
    void* partials, void* pap, int64_t rows, int32_t w, int32_t group,
    int64_t nblocks, int32_t k, int64_t sr, int64_t sl, void* launches, void* stream) {
  return launch_spmm<double, false>(cols, vals, x, nullptr, nullptr, nullptr,
                                    y, partials, pap, rows, w, group, nblocks,
                                    k, sr, sl, (unsigned long long*)launches, stream);
}

// The rows variant of all four: fold 1 for the p-fold pair (k = 1 and
// sr = 1 for ell_spmv_pfold_dot), 0 for the dot twins (p, beta and pn
// unused); `grid` blocks (ell_spmv.py rows_grid).
extern "C" int repro_spmv_dot_rows_f32(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int64_t nblocks, int32_t k, int64_t sr,
    int64_t sl, int32_t grid, int32_t fold, void* launches, void* stream) {
  return launch_rows_any<float>(cols, vals, z, p, beta, pn, y, partials, pap,
                                rows, w, nblocks, k, sr, sl, grid, fold,
                                (unsigned long long*)launches, stream);
}

extern "C" int repro_spmv_dot_rows_f64(
    const void* cols, const void* vals, const void* z, const void* p,
    const void* beta, void* pn, void* y, void* partials, void* pap,
    int64_t rows, int32_t w, int64_t nblocks, int32_t k, int64_t sr,
    int64_t sl, int32_t grid, int32_t fold, void* launches, void* stream) {
  return launch_rows_any<double>(cols, vals, z, p, beta, pn, y, partials,
                                 pap, rows, w, nblocks, k, sr, sl, grid, fold,
                                 (unsigned long long*)launches, stream);
}
