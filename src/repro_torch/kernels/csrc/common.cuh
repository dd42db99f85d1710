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

// One padded-ELL row in registers, for the kernels whose thread owns a row
// (W <= G slots, W a multiple of 4, G a power of two): load_row reads its
// cols and vals with 16-byte streaming loads (__ldcs, evict-first, so the
// matrix stream does not push the gathered vectors out of L2); cols and
// vals point at the row and are 16-byte aligned.  Slots g >= W read as
// column 0, value 0.
template <typename T, int G>
__device__ __forceinline__ void load_row(const int32_t* cols, const T* vals,
                                         int w, int (&c)[G], T (&v)[G]) {
  static_assert(G >= 4 && G <= 16 && (G & (G - 1)) == 0, "G");
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
}

// The sum of one row held in registers, in the lane order of the group
// kernels: virtual lane g runs its fma chain from 0 over its one slot g
// with the gathered value gather(c[g]), lanes g >= W stay 0, and the lanes
// are folded in the pairs and the order of group_sum's xor butterfly (lane
// 0's view: s[g] + s[g + off], offsets G/2 down to 1).  The result is the
// bits a group of G lanes running group_sum leaves in its lane 0.  The
// gathers go out in two waves, slots g < G/2 and then the rest, each wave
// before its adds: the butterfly's first stage pairs exactly these, s[g] +
// s[g + G/2], while the gathers in flight need half the registers (more
// blocks share an SM).
template <typename T, int G, typename Gather>
__device__ __forceinline__ T row_dot_halves(const int (&c)[G], const T (&v)[G],
                                            int w, Gather gather) {
  constexpr int H = G / 2;
  T a[H], b[H];
#pragma unroll
  for (int g = 0; g < H; ++g) a[g] = g < w ? gather(c[g]) : T(0);
#pragma unroll
  for (int g = 0; g < H; ++g) a[g] = g < w ? fma_rn(v[g], a[g], T(0)) : T(0);
#pragma unroll
  for (int g = 0; g < H; ++g) b[g] = g + H < w ? gather(c[g + H]) : T(0);
#pragma unroll
  for (int g = 0; g < H; ++g)
    b[g] = g + H < w ? fma_rn(v[g + H], b[g], T(0)) : T(0);
#pragma unroll
  for (int g = 0; g < H; ++g) a[g] = add_rn(a[g], b[g]);
#pragma unroll
  for (int off = H >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < off; ++g) a[g] = add_rn(a[g], a[g + off]);
  }
  return a[0];
}

// 32-row passes a warp of a rows kernel makes at a time, so that it holds
// whole virtual blocks of the group kernels (256 / G rows): two at G = 4.
template <int G>
__host__ __device__ constexpr int row_passes() { return G == 4 ? 2 : 1; }

// block_sum's additions over one "virtual block" of the group kernels, for
// a kernel whose thread owns a row.  A group kernel's block of 256 threads
// holds R = 256 / G rows, row i's value in thread i * G and +0 in the
// others.  block_sum folds each warp with shfl_down, offsets 16 down to 1:
// its M = 32 / G rows in the pairs of a fold over M (offsets M/2 down to
// 1 in rows), then the zero lanes' + 0; then warp 0 folds the 8 warp sums,
// + 0 twice for the empty slots and a fold over 8.  Here lane l of a warp
// holds row base + 32q + l's value in c[q] (q < row_passes<G>(): one
// virtual block a warp at G = 8, two at G = 16, one over two passes at G =
// 4), and the same additions run on the same operands in the same order,
// so the result in lanes l % R == 0 is that block's partial, bit for bit
// (x + 0 + 0 == x + 0, so one + 0 stands for each run of them).  Every lane
// of the warp must call it.
template <typename T, int G>
__device__ __forceinline__ T vblock_sum(const T (&c)[row_passes<G>()]) {
  constexpr int M = 32 / G;
  constexpr int P = row_passes<G>();
  T s[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    s[q] = c[q];
#pragma unroll
    for (int off = M >> 1; off > 0; off >>= 1)
      s[q] = add_rn(s[q], __shfl_down_sync(0xffffffffu, s[q], off));
    s[q] = add_rn(s[q], T(0));
  }
  // the fold over the 8 warp sums (v in lanes v * M of the block's rows):
  // its first pairs (v, v + 4) are the two passes' lanes at G = 4
  T t = s[0];
  if constexpr (P == 2) t = add_rn(s[0], s[1]);
#pragma unroll
  for (int off = (P == 2 ? 2 : 4) * M; off >= M; off >>= 1)
    t = add_rn(t, __shfl_down_sync(0xffffffffu, t, off));
  return t;
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

// A wrapper's launch count on the card (kernels/build.py launch_counter):
// the first thread of the first block adds one as the kernel starts, so a
// launch from a CUDA graph replay counts as one from Python does.  Every
// kernel a wrapper launches first calls it once.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if ((threadIdx.x | threadIdx.y | threadIdx.z | blockIdx.x | blockIdx.y |
       blockIdx.z) == 0)
    atomicAdd(launches, 1ull);
}

inline int lane_chunk(int k) {
  int c = 1;
  while (c < k && c < kMaxLanes) c <<= 1;
  return c;
}

namespace {  // internal linkage: each .cu registers its own copy

// Second pass of every dot: block b sums sequence b of `partials`
// (`count` values each) in a fixed order and writes out[b].  A thread's
// chain loads 8 of its values at a time before adding them in order.
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ partials,
                                    int64_t count, T* __restrict__ out) {
  __shared__ T sh[32];
  const T* seq = partials + (int64_t)blockIdx.x * count;
  const int64_t step = blockDim.x;
  T s = T(0);
  int64_t i = threadIdx.x;
  for (; i + 7 * step < count; i += 8 * step) {
    T v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = seq[i + q * step];
#pragma unroll
    for (int q = 0; q < 8; ++q) s += v[q];
  }
  for (; i < count; i += step) s += seq[i];
  s = block_sum(s, sh);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace

constexpr int kFinalThreads = 1024;

}  // namespace repro
