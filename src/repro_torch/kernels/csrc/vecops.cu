// cg_update: x' = x + a*p, r' = r - a*ap, z = dinv*r' (or r'),
// rr = dot(r', r'), rz = dot(r', z) -- the one-pass CG vector update.
//
// Replaces the 1-D bodies of the Pallas TPU kernel
// src/repro/kernels/vecops.py:157 (cg_update; bodies :89 with dinv and
// :105 without), the vector half of every PCG iteration.  The batched
// bodies (:124, :140) wait for the batched-RHS slice.
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

#include "common.cuh"

namespace {

constexpr int kElems = 4;

template <typename T, bool kDinv>
__global__ void __launch_bounds__(repro::kThreads)
cg_update_kernel(const T* __restrict__ alpha_ptr, const T* __restrict__ x,
                 const T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ ap, const T* __restrict__ dinv,
                 T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo,
                 T* __restrict__ partials, int64_t n) {
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
           void* stream) {
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
        (const T*)dinv, (T*)xo, (T*)ro, (T*)zo, (T*)partials, n);
  else
    cg_update_kernel<T, false><<<(unsigned)blocks, repro::kThreads, 0, s>>>(
        (const T*)alpha, (const T*)x, (const T*)r, (const T*)p, (const T*)ap,
        nullptr, (T*)xo, (T*)ro, nullptr, (T*)partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::sum_partials_kernel<T><<<has_dinv ? 2 : 1, repro::kFinalThreads, 0, s>>>(
      (const T*)partials, blocks, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_cg_update_f32(const void* alpha, const void* x,
                                   const void* r, const void* p,
                                   const void* ap, const void* dinv, void* xo,
                                   void* ro, void* zo, void* partials,
                                   void* out, int64_t n, int64_t nblocks,
                                   void* stream) {
  return launch<float>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, out, n,
                       nblocks, stream);
}

extern "C" int repro_cg_update_f64(const void* alpha, const void* x,
                                   const void* r, const void* p,
                                   const void* ap, const void* dinv, void* xo,
                                   void* ro, void* zo, void* partials,
                                   void* out, int64_t n, int64_t nblocks,
                                   void* stream) {
  return launch<double>(alpha, x, r, p, ap, dinv, xo, ro, zo, partials, out,
                        n, nblocks, stream);
}
