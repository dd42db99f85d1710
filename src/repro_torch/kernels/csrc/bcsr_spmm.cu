// bcsr_spmm: Y = A X for a block-sparse A of dense (bm, bn) blocks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcsr_spmm.py:45
// (bcsr_spmm, pallas_call at :68), the matvec of every format="bcsr"
// solve.  The TPU kernel walks a (block row, block slot) grid, fetches the
// x block of each slot by scalar prefetch of block_cols and accumulates
// one (bm, bn) @ (bn, R) MXU product a step into a VMEM-resident output
// block.
//
// Operands: block_cols (nbr, w) int32, blocks (nbr, w, bm, bn) float32 or
// float64, row-major; X is (x_rows, R) addressed through its strides (row
// stride sxr, lane stride sxl), so the solver's (k, n) layout passes as
// its transposed view without a copy; rows of X at or past x_valid read
// as 0 (the zero embedding of a padded vector into the block columns).
// Y is (nbr * bm, R), written through its strides (syr, syl).
//
// What bounds it on the H100: memory.  The blocks are read once, 8 bytes
// a stored value in float64, for 2 flops a value and lane: below the
// ~10 flops a byte where float64 arithmetic would begin to matter, up to
// R = 16, so tensor cores buy nothing (and a DMMA tile would change the
// order of the sums).  At lap2d_1024 with 8 x 8 blocks (nbr = 131,072,
// w = 5), the blocks are 335.5 MB (8x the 5.24 M nonzeros: the Laplacian
// fills an 8 x 8 block only on its diagonal band), block_cols 2.6 MB, x
// and y 8.4 MB a lane each: about 355 MB, 106 us at 3.35 TB/s; at R = 8,
// about 472 MB, 141 us.
//
// The sum, which every variant computes to the same bits: a thread owns
// one output row and a chunk of lanes in registers.  For each lane, an
// fma chain from 0 over slot k = 0 .. w-1 in order and, within each block,
// column n = 0 .. bn-1 in order: blocks[i, k, m, n] * x[bc * bn + n, lane]
// (no tensor cores, no TF32).  That order is fixed by the row alone: it
// depends neither on R, nor on the grid, nor on the variant, so lane j of
// an R = 8 call is bitwise the R = 1 call on lane j, and no atomics are
// needed.  Padding slots (block column 0, a zero block) are summed like
// any other, as in the Pallas kernel.
//
// Two variants (bcsr_spmm.py pick_variant, from bm, bn, the dtype, x's
// layout and the operands' alignment, never from a launch):
//   * smem, the TPU kernel's prefetched x block, for bn = 4, 8 or 16
//     (compiled), bm = 4, 8 or 16, 16-byte aligned blocks and lanes-major
//     16-byte aligned x (the solver's layout).  A block of 256 threads
//     holds 256 / bm block rows, a thread a row.  Before slot k's
//     products, the x block columns of slot k + 1 for the block's block
//     rows go into the other of two shared-memory buffers by 16-byte
//     cp.async (the values at or past x_valid as 0, by scalar stores: only
//     the block column that x_valid cuts), and the threads read slot k's
//     as broadcasts; each block row's region is padded to an odd number of
//     16-byte words, so that the block rows of one warp read distinct
//     banks.  A thread reads its block row with 16-byte streaming loads
//     (__ldcs, evict-first, so the block stream does not push x out of
//     L2) and carries up to 16 lanes (R = 16 is one launch).
//   * first, the first slice's design and the path for every other
//     operand: bn is a runtime argument, a thread issues one scalar load
//     for each block value and one predicated scalar x load for each
//     (column, lane), and carries at most 8 lanes (wider batches run in
//     gridDim.y chunks, each reading the blocks again).  At R = 8 the x
//     loads (the 8 threads of a block row load the same values, 4 block
//     rows a warp) set its pace: 45% of its bound.
// A third design, regs (bn compiled, the block row and each lane's x
// block column by 16-byte loads from global memory, registers capped for
// four blocks an SM), lost the A/B to smem at R = 4 to 16 in float64 and
// was removed; its times are in PERF.md.  What holds smem back at R >= 8
// is the warps in flight: in float64 it takes 64 registers a thread at
// K = 8 (four blocks an SM) and 76 at K = 16 with 66.5 KB of buffers
// (three).  Two changes to smem were timed against it and dropped (PERF.md
// has their times):
//   * two rows a thread, each x value read from shared memory once for
//     both, needed 103 registers: it won at float32 R = 8 (by 5%), was
//     within 2% at R <= 4 and lost at R = 16 (by 13% in float32) and at
//     float64 R = 8 (by 12%);
//   * registers capped for five blocks an SM won at float64 R = 4 (by 6%,
//     about the spread of smem's own time between two calls) and at float32
//     R = 2 to 16 (by 2 to 5%), and lost at float64 R = 8 (by 2%) and
//     R = 16 (by 29%).
// The uncapped kernel with one row a thread is kept for every shape: the
// solver runs in float64, and its batched BCSR solve is R = 8.

#include <atomic>

#include "common.cuh"

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(repro::kThreads)
bcsr_spmm_kernel(const int32_t* __restrict__ block_cols,
                 const T* __restrict__ blocks, const T* __restrict__ x,
                 T* __restrict__ y, int64_t rows, int w, int bm, int bn,
                 int lanes, int64_t x_valid, int64_t sxr, int64_t sxl,
                 int64_t syr, int64_t syl, unsigned long long* launches) {
  repro::count_launch(launches);
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int j0 = blockIdx.y * K;
  const int64_t bi = row / bm;
  const int m = (int)(row - bi * bm);
  T acc[K];
#pragma unroll
  for (int jj = 0; jj < K; ++jj) acc[jj] = T(0);
  const int32_t* bc = block_cols + bi * w;
  const T* blk = blocks + (bi * w * bm + m) * (int64_t)bn;
  const int64_t block_size = (int64_t)bm * bn;
  for (int k = 0; k < w; ++k) {
    const int64_t c0 = (int64_t)bc[k] * bn;
    const T* b = blk + k * block_size;
    for (int n = 0; n < bn; ++n) {
      const T a = b[n];
      const int64_t c = c0 + n;
      const T* xc = x + c * sxr + (int64_t)j0 * sxl;
#pragma unroll
      for (int jj = 0; jj < K; ++jj)
        if (j0 + jj < lanes) {
          const T xv = c < x_valid ? __ldg(xc + jj * sxl) : T(0);
          acc[jj] = repro::fma_rn(a, xv, acc[jj]);
        }
    }
  }
#pragma unroll
  for (int jj = 0; jj < K; ++jj)
    if (j0 + jj < lanes) y[row * syr + (int64_t)(j0 + jj) * syl] = acc[jj];
}

template <typename T, int K>
int launch_chunk(const void* block_cols, const void* blocks, const void* x,
                 void* y, int64_t rows, int32_t w, int32_t bm, int32_t bn,
                 int32_t lanes, int64_t x_valid, int64_t sxr, int64_t sxl,
                 int64_t syr, int64_t syl, dim3 grid, unsigned long long* launches,
                 cudaStream_t stream) {
  bcsr_spmm_kernel<T, K><<<grid, repro::kThreads, 0, stream>>>(
      (const int32_t*)block_cols, (const T*)blocks, (const T*)x, (T*)y, rows,
      w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, launches);
  return (int)cudaGetLastError();
}

// The first design with `chunk` lanes a thread on `grid` (bcsr_spmm.py
// launch_grid).
template <typename T>
int launch_first(const void* block_cols, const void* blocks, const void* x,
                 void* y, int64_t rows, int32_t w, int32_t bm, int32_t bn,
                 int32_t lanes, int64_t x_valid, int64_t sxr, int64_t sxl,
                 int64_t syr, int64_t syl, int chunk, dim3 g,
                 unsigned long long* launches, cudaStream_t s) {
  switch (chunk) {
    case 1: return launch_chunk<T, 1>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, g, launches, s);
    case 2: return launch_chunk<T, 2>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, g, launches, s);
    case 4: return launch_chunk<T, 4>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, g, launches, s);
    default: return launch_chunk<T, 8>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, g, launches, s);
  }
}

// Lanes a thread of the smem variant may carry: R = 16 is one launch.
constexpr int kWideLanes = 16;

// N consecutive values from a 16-byte aligned address by 16-byte
// streaming loads (__ldcs, evict-first).
template <typename T, int N>
__device__ __forceinline__ void load_stream(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 8) {
    static_assert(N % 2 == 0, "16-byte loads of doubles");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 d = __ldcs(reinterpret_cast<const double2*>(p + i));
      v[i] = d.x; v[i + 1] = d.y;
    }
  } else {
    static_assert(N % 4 == 0, "16-byte loads of floats");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 d = __ldcs(reinterpret_cast<const float4*>(p + i));
      v[i] = d.x; v[i + 1] = d.y; v[i + 2] = d.z; v[i + 3] = d.w;
    }
  }
}

// N consecutive values from 16-byte aligned shared memory.
template <typename T, int N>
__device__ __forceinline__ void load_shared(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 d = *reinterpret_cast<const double2*>(p + i);
      v[i] = d.x; v[i + 1] = d.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 d = *reinterpret_cast<const float4*>(p + i);
      v[i] = d.x; v[i + 1] = d.y; v[i + 2] = d.z; v[i + 3] = d.w;
    }
  }
}

// Values of one block row's staged region in the smem variant: K lanes of
// BN values, padded to an odd number of 16-byte words, so that the (at
// most 8) block rows of a warp read 16-byte words on distinct banks
// (bcsr_spmm.py smem_layout models it).
template <typename T, int BN, int K>
__host__ __device__ constexpr int smem_row_stride() {
  constexpr int words = K * BN * (int)sizeof(T) / 16;
  return K * BN + (words % 2 == 0 ? 16 / (int)sizeof(T) : 0);
}

template <typename T, int BN, int K>
constexpr size_t smem_bytes(int bm) {
  return 2 * (size_t)(repro::kThreads / bm) * smem_row_stride<T, BN, K>() *
         sizeof(T);
}

// The smem variant: 256 / bm block rows a block, thread t on row t % bm of
// block row t / bm.  Before slot k's products, x's block columns of slot
// k + 1 for the block's block rows and K lanes go into the other buffer
// by 16-byte cp.async (values at or past x_valid as 0, by scalar stores).
template <typename T, int BN, int K>
__global__ void __launch_bounds__(repro::kThreads)
bcsr_spmm_smem_kernel(const int32_t* __restrict__ block_cols,
                      const T* __restrict__ blocks, const T* __restrict__ x,
                      T* __restrict__ y, int64_t nbr, int w, int bm,
                      int lanes, int64_t x_valid, int64_t sxl, int64_t syr,
                      int64_t syl, unsigned long long* launches) {
  repro::count_launch(launches);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  constexpr int kVecT = 16 / (int)sizeof(T);
  constexpr int kPieces = BN / kVecT;
  constexpr int kStride = smem_row_stride<T, BN, K>();
  const int per_block = repro::kThreads / bm;
  const int buf_stride = per_block * kStride;
  const int64_t br0 = (int64_t)blockIdx.x * per_block;
  const int j0 = blockIdx.y * K;
  const int nl = min(K, lanes - j0);
  const int t = threadIdx.x;
  const int lbr = t / bm;
  const int m = t - lbr * bm;
  const int64_t bi = br0 + lbr;
  const bool active = bi < nbr;
  const int chunks = per_block * K * kPieces;

  auto stage = [&](int k, int buf) {
    for (int q = t; q < chunks; q += repro::kThreads) {
      const int piece = q % kPieces;
      const int jj = (q / kPieces) % K;
      const int b = q / (kPieces * K);
      const int64_t bib = br0 + b;
      if (bib < nbr && jj < nl) {
        T* dst = xs + buf * buf_stride + b * kStride + jj * BN + piece * kVecT;
        const int64_t c = (int64_t)__ldg(block_cols + bib * w + k) * BN +
                          piece * kVecT;
        const T* src = x + (int64_t)(j0 + jj) * sxl + c;
        if (c + kVecT <= x_valid) {
          repro::cp_async<16>(dst, src);
        } else {
#pragma unroll
          for (int i = 0; i < kVecT; ++i)
            dst[i] = c + i < x_valid ? __ldg(src + i) : T(0);
        }
      }
    }
    repro::cp_async_commit();
  };

  T acc[K];
#pragma unroll
  for (int jj = 0; jj < K; ++jj) acc[jj] = T(0);
  const T* blk = blocks + (bi * w * bm + m) * (int64_t)BN;
  const int64_t block_size = (int64_t)bm * BN;
  stage(0, 0);
  for (int k = 0; k < w; ++k) {
    if (k + 1 < w) stage(k + 1, (k + 1) & 1);
    else repro::cp_async_commit();            // an empty group: wait<1> below
    T a[BN];
    if (active) load_stream<T, BN>(blk + k * block_size, a);
    repro::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const T* xb = xs + (k & 1) * buf_stride + lbr * kStride;
#pragma unroll
      for (int jj = 0; jj < K; ++jj)
        if (jj < nl) {
          T xv[BN];
          load_shared<T, BN>(xb + jj * BN, xv);
#pragma unroll
          for (int n = 0; n < BN; ++n)
            acc[jj] = repro::fma_rn(a[n], xv[n], acc[jj]);
        }
    }
    __syncthreads();          // buffer k & 1 is staged again at slot k + 2
  }
  if (active) {
    const int64_t row = bi * bm + m;
#pragma unroll
    for (int jj = 0; jj < K; ++jj)
      if (jj < nl) __stcs(y + row * syr + (int64_t)(j0 + jj) * syl, acc[jj]);
  }
}

struct Args {
  const void* block_cols; const void* blocks; const void* x; void* y;
  int64_t nbr; int32_t w, bm, lanes; int64_t x_valid, sxl, syr, syl;
  dim3 grid; unsigned long long* launches; cudaStream_t s;
};

// Dynamic shared memory past 48 KB is an attribute of a kernel on each
// device: each instance raises it once a device, to the most a launch has
// needed there, and not on every launch.
constexpr int kDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<size_t> (&granted)[kDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && granted[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kDevices) granted[dev].store(bytes);
  return err;
}

template <typename T, int BN, int K>
int launch_smem(const Args& a) {
  static std::atomic<size_t> granted[kDevices];
  const size_t bytes = smem_bytes<T, BN, K>(a.bm);
  auto kernel = bcsr_spmm_smem_kernel<T, BN, K>;
  const cudaError_t err = allow_smem(kernel, bytes, granted);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid, repro::kThreads, bytes, a.s>>>(
      (const int32_t*)a.block_cols, (const T*)a.blocks, (const T*)a.x,
      (T*)a.y, a.nbr, a.w, a.bm, a.lanes, a.x_valid, a.sxl, a.syr, a.syl,
      a.launches);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_bn(const Args& a, int chunk) {
  switch (chunk) {
    case 1: return launch_smem<T, BN, 1>(a);
    case 2: return launch_smem<T, BN, 2>(a);
    case 4: return launch_smem<T, BN, 4>(a);
    case 8: return launch_smem<T, BN, 8>(a);
    default: return launch_smem<T, BN, 16>(a);
  }
}

// variant 0: first; 1: smem.  A thread carries `chunk` lanes (a power of
// two, at most 8 for first and 16 for smem) on a (gx, gy) grid, gy lane
// chunks; both come from bcsr_spmm.py launch_grid, and a grid that leaves
// a row or a lane without a thread is refused.
template <typename T>
int launch(const void* block_cols, const void* blocks, const void* x,
           void* y, int64_t nbr, int32_t w, int32_t bm, int32_t bn,
           int32_t lanes, int64_t x_valid, int64_t sxr, int64_t sxl,
           int64_t syr, int64_t syl, int32_t variant, int32_t chunk,
           int32_t gx, int32_t gy, unsigned long long* launches,
           void* stream) {
  if (nbr <= 0 || w <= 0 || bm <= 0 || bm > 16 || bn <= 0 || bn > 128 ||
      lanes <= 0 || x_valid < 0 || sxr <= 0 || sxl <= 0 || syr <= 0 ||
      syl <= 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t rows_a_block = variant == 0 ? repro::kThreads
                                            : repro::kThreads / bm;
  const int64_t need = variant == 0 ? nbr * bm : nbr;
  if (chunk <= 0 || (chunk & (chunk - 1)) ||
      chunk > (variant == 0 ? repro::kMaxLanes : kWideLanes) || gx <= 0 ||
      gy <= 0 || gy > 65535 || (int64_t)gx * rows_a_block < need ||
      (int64_t)gy * chunk < lanes)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (variant == 0)
    return launch_first<T>(block_cols, blocks, x, y, nbr * bm, w, bm, bn,
                           lanes, x_valid, sxr, sxl, syr, syl, chunk, grid,
                           launches, s);
  // what the smem variant takes: a compiled bn and bm, 16-byte aligned
  // blocks, lanes-major x with every lane's column 16-byte aligned
  const bool x_aligned = sxr == 1 && (uintptr_t)x % 16 == 0 &&
                         (lanes == 1 || (sxl * (int64_t)sizeof(T)) % 16 == 0);
  if ((bn != 4 && bn != 8 && bn != 16) || (bm != 4 && bm != 8 && bm != 16) ||
      (uintptr_t)blocks % 16 || !x_aligned)
    return (int)cudaErrorInvalidValue;
  const Args a{block_cols, blocks, x, y, nbr, w, bm, lanes, x_valid, sxl,
               syr, syl, grid, launches, s};
  switch (bn) {
    case 4: return launch_bn<T, 4>(a, chunk);
    case 8: return launch_bn<T, 8>(a, chunk);
    default: return launch_bn<T, 16>(a, chunk);
  }
}

}  // namespace

extern "C" int repro_bcsr_spmm_f32(const void* block_cols, const void* blocks,
                                   const void* x, void* y, int64_t nbr,
                                   int32_t w, int32_t bm, int32_t bn,
                                   int32_t lanes, int64_t x_valid,
                                   int64_t sxr, int64_t sxl, int64_t syr,
                                   int64_t syl, int32_t variant,
                                   int32_t chunk, int32_t gx, int32_t gy,
                                   void* launches, void* stream) {
  return launch<float>(block_cols, blocks, x, y, nbr, w, bm, bn, lanes,
                       x_valid, sxr, sxl, syr, syl, variant, chunk, gx, gy,
                       (unsigned long long*)launches, stream);
}

extern "C" int repro_bcsr_spmm_f64(const void* block_cols, const void* blocks,
                                   const void* x, void* y, int64_t nbr,
                                   int32_t w, int32_t bm, int32_t bn,
                                   int32_t lanes, int64_t x_valid,
                                   int64_t sxr, int64_t sxl, int64_t syr,
                                   int64_t syl, int32_t variant,
                                   int32_t chunk, int32_t gx, int32_t gy,
                                   void* launches, void* stream) {
  return launch<double>(block_cols, blocks, x, y, nbr, w, bm, bn, lanes,
                        x_valid, sxr, sxl, syr, syl, variant, chunk, gx, gy,
                        (unsigned long long*)launches, stream);
}
