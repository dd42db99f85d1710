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
// R = 16.  At lap2d_1024 with 8 x 8 blocks (nbr = 131,072, w = 5), the
// blocks are 335.5 MB (8x the 5.24 M nonzeros: the Laplacian fills an
// 8 x 8 block only on its diagonal band), block_cols 2.6 MB, x and y
// 8.4 MB each: about 355 MB, 106 us at 3.35 TB/s; at R = 8, about 472 MB,
// 141 us.
//
// Design: Hopper blocks run in no order, so the TPU's sequential
// accumulation over the slot axis becomes a loop inside one thread.  A
// thread owns one output row and up to K = 8 lanes in registers (wider
// batches run in gridDim.y chunks).  For each slot k = 0 .. w-1 in order,
// and within its block each column n = 0 .. bn-1 in order, it adds
// blocks[i, k, m, n] * x[bc * bn + n, lane] by one fused multiply-add
// (no tensor cores, no TF32).  That order is fixed by the row alone: it
// depends neither on R, nor on the grid, nor on the launch, so lane j of
// an R = 8 call is bitwise the R = 1 call on lane j, and no atomics are
// needed.  Padding slots (block column 0, a zero block) are summed like
// any other, as in the Pallas kernel.  A warp's 32 rows read their block
// rows with a stride of bn values; the L1 cache serves the next columns
// of each 32-byte sector, so each block byte crosses from memory once.

#include "common.cuh"

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(repro::kThreads)
bcsr_spmm_kernel(const int32_t* __restrict__ block_cols,
                 const T* __restrict__ blocks, const T* __restrict__ x,
                 T* __restrict__ y, int64_t rows, int w, int bm, int bn,
                 int lanes, int64_t x_valid, int64_t sxr, int64_t sxl,
                 int64_t syr, int64_t syl) {
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
                 int64_t syr, int64_t syl, void* stream) {
  const int64_t blocks_x = (rows + repro::kThreads - 1) / repro::kThreads;
  const dim3 grid((unsigned)blocks_x, (unsigned)((lanes + K - 1) / K));
  bcsr_spmm_kernel<T, K><<<grid, repro::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)block_cols, (const T*)blocks, (const T*)x, (T*)y, rows,
      w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* block_cols, const void* blocks, const void* x,
           void* y, int64_t nbr, int32_t w, int32_t bm, int32_t bn,
           int32_t lanes, int64_t x_valid, int64_t sxr, int64_t sxl,
           int64_t syr, int64_t syl, void* stream) {
  if (nbr <= 0 || w <= 0 || bm <= 0 || bm > 16 || bn <= 0 || bn > 128 ||
      lanes <= 0 || x_valid < 0 || sxr <= 0 || sxl <= 0 || syr <= 0 ||
      syl <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = nbr * bm;
  switch (repro::lane_chunk(lanes)) {
    case 1: return launch_chunk<T, 1>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, stream);
    case 2: return launch_chunk<T, 2>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, stream);
    case 4: return launch_chunk<T, 4>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, stream);
    default: return launch_chunk<T, 8>(block_cols, blocks, x, y, rows, w, bm, bn, lanes, x_valid, sxr, sxl, syr, syl, stream);
  }
}

}  // namespace

extern "C" int repro_bcsr_spmm_f32(const void* block_cols, const void* blocks,
                                   const void* x, void* y, int64_t nbr,
                                   int32_t w, int32_t bm, int32_t bn,
                                   int32_t lanes, int64_t x_valid,
                                   int64_t sxr, int64_t sxl, int64_t syr,
                                   int64_t syl, void* stream) {
  return launch<float>(block_cols, blocks, x, y, nbr, w, bm, bn, lanes,
                       x_valid, sxr, sxl, syr, syl, stream);
}

extern "C" int repro_bcsr_spmm_f64(const void* block_cols, const void* blocks,
                                   const void* x, void* y, int64_t nbr,
                                   int32_t w, int32_t bm, int32_t bn,
                                   int32_t lanes, int64_t x_valid,
                                   int64_t sxr, int64_t sxl, int64_t syr,
                                   int64_t syl, void* stream) {
  return launch<double>(block_cols, blocks, x, y, nbr, w, bm, bn, lanes,
                        x_valid, sxr, sxl, syr, syl, stream);
}
