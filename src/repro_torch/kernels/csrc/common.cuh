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
