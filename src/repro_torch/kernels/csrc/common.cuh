// Shared device helpers for the port's kernels.
//
// Reductions are deterministic: warp shuffles in a fixed pattern, then the
// warp sums in warp order, and cross-block sums from per-block partials in
// a second pass that reads them in index order.  No float atomics anywhere,
// so a launch on the same inputs repeats bit for bit.
//
// The elementwise helpers use the _rn intrinsics, which the compiler never
// contracts into an FMA: `z + beta * p` rounds twice, exactly as PyTorch's
// eager `z + beta * p` does, so folded and updated vectors come out equal
// to the plain versions' and only the sums differ, by summation order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// p' = z + beta * p, rounded as PyTorch rounds it (product, then sum).
template <typename T>
__device__ __forceinline__ T fold(T z, T beta, T p) {
  return add_rn(z, mul_rn(beta, p));
}

// Sum over the `group` consecutive lanes that own one row (group is a power
// of two <= 32 and divides 32); every lane of the group gets the sum.  All
// 32 lanes of the warp must call it.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum; the result is valid in thread 0.  `sh` holds 32 slots.
// Every thread of the block must call it; it ends with a barrier so `sh`
// can be reused by the next call.
template <typename T>
__device__ T block_sum(T v, T* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = (threadIdx.x < nwarps) ? sh[threadIdx.x] : T(0);
  if (wid == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

// block_sum for K lanes at once: lane jj's sum runs exactly the additions
// block_sum runs on one value (the same warp trees, the warp sums in warp
// order), so a lane's sum does not depend on how many lanes share the
// block.  Results are valid in thread 0; `sh` holds 32 * K slots.  Every
// thread of the block must call it; it ends with a barrier.
template <typename T, int K>
__device__ void block_sum_lanes(T (&v)[K], T* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int jj = 0; jj < K; ++jj) {
    v[jj] = warp_sum(v[jj]);
    if (lane == 0) sh[jj * 32 + wid] = v[jj];
  }
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < K; ++jj) {
    v[jj] = (threadIdx.x < nwarps) ? sh[jj * 32 + threadIdx.x] : T(0);
    if (wid == 0) v[jj] = warp_sum(v[jj]);
  }
  __syncthreads();
}

// The sum of one padded-ELL row in the lane order of the group kernels.
// A thread holds the whole row (W <= G slots, W a multiple of 4, G a power
// of two): virtual lane g runs its fma chain from 0 over its one slot g,
// lanes g >= W stay 0, and the lanes are folded in the pairs and the order
// of group_sum's xor butterfly (lane 0's view: s[g] + s[g + off], offsets
// G/2 down to 1).  The result is the bits a group of G lanes running
// group_sum leaves in its lane 0.  cols and vals point at the row in
// global memory; they are 16-byte aligned and read with 16-byte streaming
// loads (__ldcs, evict-first).
template <typename T, int G>
__device__ __forceinline__ T row_sum(const int32_t* cols, const T* vals,
                                     const T* __restrict__ x, int w) {
  static_assert(G >= 4 && G <= 16 && (G & (G - 1)) == 0, "G");
  int c[G];
  T v[G];
#pragma unroll
  for (int q = 0; q < G; q += 4) {
    if (q < w) {
      const int4 c4 = __ldcs(reinterpret_cast<const int4*>(cols + q));
      c[q] = c4.x; c[q + 1] = c4.y; c[q + 2] = c4.z; c[q + 3] = c4.w;
      if constexpr (sizeof(T) == 8) {
        const double2 a = __ldcs(reinterpret_cast<const double2*>(vals + q));
        const double2 b = __ldcs(reinterpret_cast<const double2*>(vals + q + 2));
        v[q] = a.x; v[q + 1] = a.y; v[q + 2] = b.x; v[q + 3] = b.y;
      } else {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(vals + q));
        v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) { c[q + i] = 0; v[q + i] = T(0); }
    }
  }
  T s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = g < w ? __ldg(x + c[g]) : T(0);
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = g < w ? fma_rn(v[g], s[g], T(0)) : T(0);
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < off; ++g) s[g] = add_rn(s[g], s[g + off]);
  }
  return s[0];
}

// Per-thread asynchronous copies global -> shared (cp.async, sm_80+): a
// thread's copies complete in the groups it commits, and
// cp_async_wait<N>() waits until at most N of its groups are pending.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 ::"r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Right-hand sides a batched kernel's thread carries in registers: the
// power of two >= k, at most kMaxLanes.  A batch wider than that runs in
// gridDim.y chunks of kMaxLanes lanes, each chunk reading the matrix
// again.  At 16 lanes the float64 p-fold kernel needs 136 registers (one
// block an SM) and the SpMM spills; 8 keeps every kernel at <= 80.
constexpr int kMaxLanes = 8;

inline int lane_chunk(int k) {
  int c = 1;
  while (c < k && c < kMaxLanes) c <<= 1;
  return c;
}

namespace {  // internal linkage: each .cu registers its own copy

// Second pass of every dot: block b sums sequence b of `partials`
// (`count` values each) in a fixed order and writes out[b].
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ partials,
                                    int64_t count, T* __restrict__ out) {
  __shared__ T sh[32];
  const T* seq = partials + (int64_t)blockIdx.x * count;
  T s = T(0);
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) s += seq[i];
  s = block_sum(s, sh);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace

constexpr int kFinalThreads = 1024;

}  // namespace repro
