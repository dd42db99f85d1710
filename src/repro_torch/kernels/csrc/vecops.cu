// cg_update: x' = x + a*p, r' = r - a*ap, z = dinv*r' (or r'),
// rr = dot(r', r'), rz = dot(r', z) -- the one-pass CG vector update.
//
// Replaces the 1-D bodies of the Pallas TPU kernel
// src/repro/kernels/vecops.py:157 (cg_update; bodies :89 with dinv and
// :105 without), the vector half of every PCG iteration.
//
// What bounds it on the H100: memory.  Five vectors in (x, r, p, ap,
// dinv) and three out (x', r', z) -- 64 bytes per element in float64 --
// for about eight flops per element.  At n = 1,048,576 in float64 that is
// 67 MB: about 20 us at 3.35 TB/s.
//
// Design: one pass.  Each thread handles kElems elements strided by the
// block width (coalesced), a reads alpha from device memory (the solver
// never brings it to the host), and each block sums its rr and rz terms in
// a fixed order into per-block partials; a second one-block launch sums
// the partials in index order.  Threads past n do nothing, which is the
// TPU kernel's tail-tile mask.  Without dinv the z stream is skipped
// (z = r', rz = rr), as in the TPU kernel's _nod body.

// cg_update_batched: the same for k right-hand sides in the solver layout:
// x, r, p, ap and the outputs are (k, n) row-major, alpha (k,) (the
// solver's (k, 1)), dinv (n,) shared by the lanes or none; rr and rz
// come back as (k,) each.
//
// Replaces the batched bodies of the same Pallas kernel (vecops.py:157,
// pallas_call :202; _cg_update_kernel_b :124 with dinv, _b_nod :140
// without), the vector half of every batched PCG iteration.
//
// What bounds it: memory.  7k + 1 vectors with dinv (4k in, dinv once,
// 3k out), 6k without: at n = 1,048,576 with k = 8 in float64, 478.2 MB
// and 402.7 MB, about 143 and 120 us at 3.35 TB/s.
//
// Design: cg_update_kernel's element partition (kElems elements a thread,
// strided by the block width), with each element's dinv loaded once and
// applied to the K lanes the thread carries.  Lane j's rr and rz run
// cg_update_kernel's fma chains and block_sum, into (sum, k, nblocks)
// partials summed per lane in index order by a second launch, so lane j's
// outputs do not depend on k and equal cg_update_kernel's bit for bit.

// axpy_dot: z = y + a*x and zz = dot(z, z), one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/vecops.py:49
// (axpy_dot, pallas_call :63), the original two-op fusion.  Bound:
// memory, x and y in and z out (24 bytes per element in float64): at
// n = 1,048,576, 25.2 MB, about 7.5 us at 3.35 TB/s.
//
// Design: cg_update_kernel's element partition and its partials.  a is
// read from device memory (a 0-d tensor the wrapper makes from a number),
// z is rounded product then sum (repro::add_rn/mul_rn), as PyTorch's
// eager y + a * x is, so z is bitwise the plain version's; zz's
// per-block partials are summed in index order by the second launch.
// Any n: threads past n do nothing (the TPU kernel's n % tile == 0 is a
// TPU restriction).

#include "common.cuh"

namespace {

constexpr int kElems = 4;

template <typename T, bool kDinv>
__global__ void __launch_bounds__(repro::kThreads)
cg_update_kernel(const T* __restrict__ alpha_ptr, const T* __restrict__ x,
                 const T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ ap, const T* __restrict__ dinv,
                 T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo,
                 T* __restrict__ partials, int64_t n,
                 unsigned long long* launches) {
  repro::count_launch(launches);
  __shared__ T sh[32];
  const T a = *alpha_ptr;
  T srr = T(0), srz = T(0);
  const int64_t base = (int64_t)blockIdx.x * (blockDim.x * kElems) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int64_t i = base + (int64_t)e * blockDim.x;
    if (i < n) {
      xo[i] = repro::add_rn(x[i], repro::mul_rn(a, p[i]));
      const T rv = repro::sub_rn(r[i], repro::mul_rn(a, ap[i]));
      ro[i] = rv;
      srr = repro::fma_rn(rv, rv, srr);
      if (kDinv) {
        const T zv = repro::mul_rn(rv, dinv[i]);
        zo[i] = zv;
        srz = repro::fma_rn(rv, zv, srz);
      }
    }
  }
  srr = repro::block_sum(srr, sh);
  if (kDinv) srz = repro::block_sum(srz, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = srr;
    if (kDinv) partials[gridDim.x + blockIdx.x] = srz;
  }
}

template <typename T>
int launch(const void* alpha, const void* x, const void* r, const void* p,
           const void* ap, const void* dinv, void* xo, void* ro, void* zo,
           void* partials, void* out, int64_t n, int64_t nblocks,
           unsigned long long* launches, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)repro::kThreads * kElems;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  const bool has_dinv = dinv != nullptr;
  if (has_dinv != (zo != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_dinv)
    cg_update_kernel<T, true><<<(unsigned)blocks, repro::kThreads, 0, s>>>(
        (const T*)alpha, (const T*)x, (const T*)r, (const T*)p, (const T*)ap,
        (const T*)dinv, (T*)xo, (T*)ro, (T*)zo, (T*)partials, n, launches);
  else
    cg_update_kernel<T, false><<<(unsigned)blocks, repro::kThreads, 0, s>>>(
        (const T*)alpha, (const T*)x, (const T*)r, (const T*)p, (const T*)ap,
        nullptr, (T*)xo, (T*)ro, nullptr, (T*)partials, n, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::sum_partials_kernel<T><<<has_dinv ? 2 : 1, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool kDinv, int K>
__global__ void __launch_bounds__(repro::kThreads)
cg_update_b_kernel(const T* __restrict__ alpha_ptr, const T* __restrict__ x,
                   const T* __restrict__ r, const T* __restrict__ p,
                   const T* __restrict__ ap, const T* __restrict__ dinv,
                   T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo,
                   T* __restrict__ partials, int64_t n, int k,
                   unsigned long long* launches) {
  repro::count_launch(launches);
  __shared__ T sh[32 * K];
  const int j0 = blockIdx.y * K;
  T a[K], srr[K], srz[K];
#pragma unroll
  for (int jj = 0; jj < K; ++jj) {
    a[jj] = (j0 + jj < k) ? alpha_ptr[j0 + jj] : T(0);
    srr[jj] = T(0);
    srz[jj] = T(0);
  }
  const int64_t base = (int64_t)blockIdx.x * (blockDim.x * kElems) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int64_t i = base + (int64_t)e * blockDim.x;
    if (i < n) {
      const T d = kDinv ? dinv[i] : T(0);
#pragma unroll
      for (int jj = 0; jj < K; ++jj) {
        if (j0 + jj < k) {
          const int64_t o = (int64_t)(j0 + jj) * n + i;
          xo[o] = repro::add_rn(x[o], repro::mul_rn(a[jj], p[o]));
          const T rv = repro::sub_rn(r[o], repro::mul_rn(a[jj], ap[o]));
          ro[o] = rv;
          srr[jj] = repro::fma_rn(rv, rv, srr[jj]);
          if (kDinv) {
            const T zv = repro::mul_rn(rv, d);
            zo[o] = zv;
            srz[jj] = repro::fma_rn(rv, zv, srz[jj]);
          }
        }
      }
    }
  }
  repro::block_sum_lanes<T, K>(srr, sh);
  if (kDinv) repro::block_sum_lanes<T, K>(srz, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int jj = 0; jj < K; ++jj) {
      if (j0 + jj < k) {
        partials[(int64_t)(j0 + jj) * gridDim.x + blockIdx.x] = srr[jj];
        if (kDinv)
          partials[(int64_t)(k + j0 + jj) * gridDim.x + blockIdx.x] = srz[jj];
      }
    }
  }
}

template <typename T, int K>
int launch_b_chunk(const void* alpha, const void* x, const void* r,
                   const void* p, const void* ap, const void* dinv, void* xo,
                   void* ro, void* zo, void* partials, int64_t n,
                   int64_t blocks, int32_t k, unsigned long long* launches,
                   cudaStream_t s) {
  const dim3 grid((unsigned)blocks, (unsigned)((k + K - 1) / K));
  if (dinv != nullptr)
    cg_update_b_kernel<T, true, K><<<grid, repro::kThreads, 0, s>>>(
        (const T*)alpha, (const T*)x, (const T*)r, (const T*)p, (const T*)ap,
        (const T*)dinv, (T*)xo, (T*)ro, (T*)zo, (T*)partials, n, k,
        launches);
  else
    cg_update_b_kernel<T, false, K><<<grid, repro::kThreads, 0, s>>>(
        (const T*)alpha, (const T*)x, (const T*)r, (const T*)p, (const T*)ap,
        nullptr, (T*)xo, (T*)ro, nullptr, (T*)partials, n, k, launches);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b(const void* alpha, const void* x, const void* r, const void* p,
             const void* ap, const void* dinv, void* xo, void* ro, void* zo,
             void* partials, void* out, int64_t n, int64_t nblocks, int32_t k,
             unsigned long long* launches, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)repro::kThreads * kElems;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  const bool has_dinv = dinv != nullptr;
  if (has_dinv != (zo != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (repro::lane_chunk(k)) {
    case 1: err = launch_b_chunk<T, 1>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, n, blocks, k, launches, s); break;
    case 2: err = launch_b_chunk<T, 2>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, n, blocks, k, launches, s); break;
    case 4: err = launch_b_chunk<T, 4>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, n, blocks, k, launches, s); break;
    default: err = launch_b_chunk<T, 8>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, n, blocks, k, launches, s); break;
  }
  if (err != (int)cudaSuccess) return err;
  const unsigned sums = (unsigned)((has_dinv ? 2 : 1) * k);
  repro::sum_partials_kernel<T><<<sums, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
axpy_dot_kernel(const T* __restrict__ a_ptr, const T* __restrict__ x,
                const T* __restrict__ y, T* __restrict__ z,
                T* __restrict__ partials, int64_t n,
                unsigned long long* launches) {
  repro::count_launch(launches);
  __shared__ T sh[32];
  const T a = *a_ptr;
  T szz = T(0);
  const int64_t base = (int64_t)blockIdx.x * (blockDim.x * kElems) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int64_t i = base + (int64_t)e * blockDim.x;
    if (i < n) {
      const T zv = repro::add_rn(y[i], repro::mul_rn(a, x[i]));
      z[i] = zv;
      szz = repro::fma_rn(zv, zv, szz);
    }
  }
  szz = repro::block_sum(szz, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = szz;
}

template <typename T>
int launch_axpy_dot(const void* a, const void* x, const void* y, void* z,
                    void* partials, void* out, int64_t n, int64_t nblocks,
                    unsigned long long* launches, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)repro::kThreads * kElems;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks != nblocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  axpy_dot_kernel<T><<<(unsigned)blocks, repro::kThreads, 0, s>>>(
      (const T*)a, (const T*)x, (const T*)y, (T*)z, (T*)partials, n, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::sum_partials_kernel<T><<<1, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_cg_update_f32(const void* alpha, const void* x,
                                   const void* r, const void* p,
                                   const void* ap, const void* dinv, void* xo,
                                   void* ro, void* zo, void* partials,
                                   void* out, int64_t n, int64_t nblocks,
                                   void* launches, void* stream) {
  return launch<float>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, out, n,
                       nblocks, (unsigned long long*)launches, stream);
}

extern "C" int repro_cg_update_f64(const void* alpha, const void* x,
                                   const void* r, const void* p,
                                   const void* ap, const void* dinv, void* xo,
                                   void* ro, void* zo, void* partials,
                                   void* out, int64_t n, int64_t nblocks,
                                   void* launches, void* stream) {
  return launch<double>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, out,
                        n, nblocks, (unsigned long long*)launches, stream);
}

extern "C" int repro_cg_update_batched_f32(
    const void* alpha, const void* x, const void* r, const void* p,
    const void* ap, const void* dinv, void* xo, void* ro, void* zo,
    void* partials, void* out, int64_t n, int64_t nblocks, int32_t k,
    void* launches, void* stream) {
  return launch_b<float>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, out,
                         n, nblocks, k, (unsigned long long*)launches,
                         stream);
}

extern "C" int repro_cg_update_batched_f64(
    const void* alpha, const void* x, const void* r, const void* p,
    const void* ap, const void* dinv, void* xo, void* ro, void* zo,
    void* partials, void* out, int64_t n, int64_t nblocks, int32_t k,
    void* launches, void* stream) {
  return launch_b<double>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, out,
                          n, nblocks, k, (unsigned long long*)launches,
                          stream);
}

extern "C" int repro_axpy_dot_f32(const void* a, const void* x, const void* y,
                                  void* z, void* partials, void* out,
                                  int64_t n, int64_t nblocks, void* launches,
                                  void* stream) {
  return launch_axpy_dot<float>(a, x, y, z, partials, out, n, nblocks,
                                (unsigned long long*)launches, stream);
}

extern "C" int repro_axpy_dot_f64(const void* a, const void* x, const void* y,
                                  void* z, void* partials, void* out,
                                  int64_t n, int64_t nblocks, void* launches,
                                  void* stream) {
  return launch_axpy_dot<double>(a, x, y, z, partials, out, n, nblocks,
                                 (unsigned long long*)launches, stream);
}
