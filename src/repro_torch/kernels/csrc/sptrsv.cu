// sptrsv_solve_dot: the whole level-scheduled lower-triangular solve
// L x = b, plus pp = dot(wdot, x), in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sptrsv.py:132
// (sptrsv_solve_dot, pallas_call at :165), the two triangular solves of
// every block-IC(0) PCG iteration (precond.make_fused_ic0_apply).
//
// For each level in order, and each real row r of the level:
//   x[r] = (b[r] - sum_slots (c != r ? v : 0) * x[c]) * dinv[r]
// Padded rows of x stay 0 (the wrapper allocates x zeroed).  Every variant
// runs this arithmetic: the products, then the sum in slot order, each
// rounded, the diagonal slot skipped, then the multiply by dinv (as the
// plain version's elementwise product and row sum: a row with at most two
// off-diagonal entries comes out bitwise equal to the plain version).
//
// What bounds it on the H100.  Bytes: at lap2d_1024 in float64 the
// factor's padded ELL is 1,048,576 x 8 slots x 12 B = 100.7 MB, b, dinv
// and wdot in and x out 33.6 MB, the level list 4.2 MB: about 138 MB, or
// ~41 us at 3.35 TB/s.  That is not what bounds it.  The chain of levels
// does: 2047 levels at lap2d_1024, each of which needs the x values of
// earlier levels, so each level costs one synchronisation plus the
// dependent round trips to memory that follow it, whatever its width.
//
// Two variants; the wrapper picks one from the schedule's and the
// factor's shape and the alignment of vals (sptrsv.py solve_variant), and
// chip_smoke.py times both.
//   * cluster (the widest level fits one cluster of at most 16 blocks at
//     one row a thread, W is a multiple of 4 up to 16, vals 16-byte
//     aligned, and the pack holds this factor's dependency codes): one
//     thread-block cluster walks the levels with its hardware barrier
//     (barrier.cluster arrive.release / wait.acquire) in place of a
//     grid-wide software barrier, keeps the last levels' x in distributed
//     shared memory, and prefetches each thread's rows with cp.async
//     levels ahead (see sptrsv_cluster_kernel).  The dot: per-thread sums
//     over a fixed slot, block sums, per-block partials summed by block 0
//     in rank order.
//   * cooperative (the first design; wide schedules, and every factor the
//     cluster does not take): one cooperative launch
//     (cudaLaunchCooperativeKernel) with
//     cooperative_groups::this_grid().sync() after each level; the grid
//     is what can be co-resident, cut to the blocks the widest level can
//     use; a grid-stride loop over a level's compact row list gives one
//     thread a row.  The dot: each thread accumulates over its rows in a
//     fixed row-to-thread assignment, each block reduces into
//     partials[block], and block 0 sums the partials in index order.
// A third design, per-row ready flags with no barrier at all (persistent
// blocks taking schedule chunks in ticket order), lost the A/B to both and
// was removed (its times are in PERF.md).
// A refused launch returns its error; the wrapper raises.
//
// x is written and read in the same launch.  L1 is not coherent across
// SMs, so a cached read after a barrier could return a stale line: x is
// read with __ldcg (L2 only) and never through a const __restrict__
// pointer.  Everything else is read-only in the launch.  No variant uses
// float atomics: the same inputs on the same card give the same bits.


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
// every slot (a masked slot adds 0 * x, as the JAX op's does): the
// products, then the sum in slot order from 0, each rounded, then the
// difference and the quotient (sub_rn, div_rn).  Every variant runs this
// arithmetic, so all give the same bits.
//
// What bounds it on the H100: latency.  A level of lap2d_1024's IC(0)
// factor has at most 1024 rows: ~143 KB of ids, factor rows, b, diag, x
// gathers and x stores, 0.043 us at 3.35 TB/s, against a microsecond or
// more to launch and drain a kernel, and the chain of dependent loads a
// row makes.  A whole solve is one launch a level (2047 at lap2d_1024),
// where sptrsv_solve_dot keeps one launch and pays a barrier a level.
//
// Design (the wrapper picks the variant, sptrsv.py level_step_variant):
//   * vec / wave: the width W is compiled (1-8 and 16, as the other
//     gathers).  A thread owns one row: it loads the row's id, then all W
//     cols and vals at once (16-byte loads in "vec", where W % 4 == 0 and
//     cols and vals are 16-byte aligned), b[lr] and diag beside them, then
//     all W x gathers before the first product: three dependent round
//     trips a row (id, row, x) where the first design makes about 2W + 1.
//     Ids are 32-bit (the wrapper sends a factor whose rows_p * W or n + 1
//     passes 2^31 - 1 to "first"); 64 threads a block (a 1024-row level on
//     16 SMs).  The launch is programmatic-dependent
//     (cudaLaunchKernelEx with cudaLaunchAttributeProgrammaticStreamSeriali-
//     zation): each block first lets the next launch begin
//     (griddepcontrol.launch_dependents), then waits for the grids before
//     it (griddepcontrol.wait) BEFORE ITS FIRST READ -- an op earlier on
//     the stream may have written b, diag, level_rows, cols, vals or x, and
//     the wait is the only ordering the kernel has against it -- so no
//     load and no launch count comes before it.  Only a prefetch of the
//     level's ids into L2 does (prefetch.global.L2: it returns no value,
//     and L2 is where every store lands, so it cannot make a read after
//     the wait older); in a chain it takes the first round trip's miss
//     off the chain.  What overlaps is the next level's launch and that
//     prefetch with this level's load chain, not data.  Stream
//     capture keeps the programmatic edge between two such kernels (CUDA
//     12.3+; the wrapper checks it once a device, repro_pdl_capture_check,
//     and raises if not).  The launch count is added by one thread after
//     its row, still once a launch.
//   * first: the first design, any W, 64-bit ids: one thread a row, the
//     slot loop over a runtime w (each slot's x load waits on its cols
//     load), launched plainly.
// Every variant reads x_in and writes x_out.  The wrapper makes x_out a
// copy of x_in, so the op stays functional; x_out may also be x_in itself
// (a solve that updates x level by level).  That is legal: a level's rows
// read only x of earlier levels, never of their own (the masked diagonal
// slot reads x[r] but multiplies it by 0, and x[r] is finite before and
// after), and the sentinel slot is read only through zero-valued
// padding.  So x is read through a plain pointer, not a const
// __restrict__ one: no real row's read depends on a write of the same
// launch.  The one exception is the sentinel slot's own value: a padding
// id past rows_p - 1 (the schedule's sentinel n where rows_p == n) solves
// the clamped row rows_p - 1, whose inputs the same level may write, so in
// place what lands in slot n can depend on the threads' order; no real
// row reads it through a nonzero value.  The new
// design reads x with __ldcg (L2, where the previous level's stores from
// other SMs land).

#include <atomic>
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
                        int w, T* x, T* partials, T* pp,
                        unsigned long long* launches) {
  repro::count_launch(launches);
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

// -- the cluster variant: one thread-block cluster, the next levels prefetched
//
// A thread owns slot s of every level (s = block rank x blockDim + thread):
// the level grid (n_levels, grid_w) gives its row, or -1.  Its rows' data
// (dependency codes, values, b, dinv, wdot) move into a ring of kRing
// shared-memory stages with cp.async, kDepth levels ahead, and the row ids
// 2 x kDepth levels ahead.  The stages are laid out field-major
// ([stage][chunk][thread]), so a warp's reads of one field are contiguous
// and free of bank conflicts.
//
// The x values of the last kWindow levels stay in distributed shared
// memory: the thread of slot s writes x of its level-l row to its own
// block's window[l % kWindow][s % blockDim].  A row reads each column
// through the pack's dependency code (dep, (rows_p, W), built from the
// factor's columns and the schedule): the diagonal slot is skipped
// (kDepSkip); a column not solved before the row's level reads 0, as the
// plain version's x still holds 0 there (kDepZero); a column solved fewer
// than kWindow levels earlier is read from the owner block's window
// (code = (level % kWindow) << kSlotBits | slot); an older one from x in
// global memory (code = -(c + 2)), loaded one level ahead (__ldcg: L2,
// coherent across the SMs) into registers where the pack has such codes.
//
// The barrier is the cluster's hardware barrier, split: the window store,
// arrive (release), then the store to global x of the row solved two
// levels earlier (kept in registers), the next copies and loads, then wait
// (acquire).  So after a barrier only shared-memory reads, the sum and the
// window store remain on the chain.  A global x store is read only kWindow
// levels later, after barriers that order it.
constexpr int kDepth = 3;
constexpr int kRing = kDepth + 1;
constexpr int kWindow = 8;
constexpr int kSlotBits = 12;              // slots a level: 16 x 256 = 4096
constexpr int kDepSkip = -1;
constexpr int kDepZero = INT32_MIN;
constexpr int kClusterThreads = 256;       // the most threads a block

template <typename T>
struct Vec16;                              // the 16-byte vector of T
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

template <typename T, int WMAX>
constexpr size_t cluster_smem(int threads) {
  return (size_t)threads *
         (kRing * (WMAX * 4 + WMAX * sizeof(T) + 3 * sizeof(T) + 8) +
          kWindow * sizeof(T));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <typename T, int WMAX>
__global__ void __launch_bounds__(kClusterThreads)
sptrsv_cluster_kernel(const int* __restrict__ dep, const T* __restrict__ vals,
                      const T* __restrict__ dinv, const T* __restrict__ b,
                      const T* __restrict__ wdot,
                      const int* __restrict__ level_grid, int n_levels,
                      int grid_w, int w, int has_global, T* x, T* partials,
                      T* pp, unsigned long long* launches) {
  repro::count_launch(launches);
  using V = typename Vec16<T>::type;
  constexpr int kDq = WMAX / 4;                        // int4 chunks a row
  constexpr int kPer = 16 / (int)sizeof(T);            // values a V
  constexpr int kVq = WMAX / kPer;                     // V chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sh[32];
  const int tb = blockDim.x, t = threadIdx.x;
  const int tb_log2 = __ffs(tb) - 1;                   // tb is a power of two
  int4* dep_s = reinterpret_cast<int4*>(smem);         // [kRing][kDq][tb]
  V* val_s = reinterpret_cast<V*>(dep_s + kRing * kDq * tb);   // [kRing][kVq][tb]
  T* b_s = reinterpret_cast<T*>(val_s + kRing * kVq * tb);     // [kRing][tb]
  T* d_s = b_s + kRing * tb;
  T* w_s = d_s + kRing * tb;
  T* win = w_s + kRing * tb;                                   // [kWindow][tb]
  int* id_s = reinterpret_cast<int*>(win + kWindow * tb);      // [kRing][tb]
  int* next_s = id_s + kRing * tb;                             // [kRing][tb]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slot = rank * tb + t;
  const bool has_slot = slot < grid_w;

  auto fetch_id = [&](int l) {           // row id of level l, asynchronously
    int* dst = next_s + (l % kRing) * tb + t;
    if (has_slot && l < n_levels)
      repro::cp_async<4>(dst, level_grid + (int64_t)l * grid_w + slot);
    else
      *dst = -1;
  };
  auto fetch_row = [&](int l, int r) {   // row r's data for level l
    const int st = l % kRing;
    id_s[st * tb + t] = r;
    if (r < 0) return;
    const int64_t base = (int64_t)r * w;
    for (int q = 0; q * 4 < w; ++q)
      repro::cp_async<16>(dep_s + (st * kDq + q) * tb + t, dep + base + 4 * q);
    for (int q = 0; q * kPer < w; ++q)
      repro::cp_async<16>(val_s + (st * kVq + q) * tb + t, vals + base + kPer * q);
    repro::cp_async<(int)sizeof(T)>(b_s + st * tb + t, b + r);
    repro::cp_async<(int)sizeof(T)>(d_s + st * tb + t, dinv + r);
    if (wdot != nullptr) repro::cp_async<(int)sizeof(T)>(w_s + st * tb + t, wdot + r);
  };
  auto codes_of = [&](int st, int (&code)[WMAX]) {
#pragma unroll
    for (int q = 0; q < kDq; ++q) {
      const int4 d = q * 4 < w ? dep_s[(st * kDq + q) * tb + t]
                               : make_int4(kDepSkip, kDepSkip, kDepSkip, kDepSkip);
      code[4 * q] = d.x; code[4 * q + 1] = d.y;
      code[4 * q + 2] = d.z; code[4 * q + 3] = d.w;
    }
  };
  auto is_global = [](int c) { return c < kDepSkip && c != kDepZero; };

  T acc = T(0), x_prev[2] = {T(0), T(0)};
  int r_prev[2] = {-1, -1};              // rows solved one and two levels ago
  // one level of the solve; xg holds this level's global x values (loaded
  // a level ago) and the next level's are loaded into xn
  auto level = [&](int l, T (&xg)[WMAX], T (&xn)[WMAX]) {
    repro::cp_async_wait<kDepth - 2>();
    const int st = l % kRing;
    const int r = id_s[st * tb + t];
    T xr = T(0);
    if (r >= 0) {
      int code[WMAX];
      T v[WMAX], xc[WMAX];
      codes_of(st, code);
#pragma unroll
      for (int q = 0; q < kVq; ++q) {
        V a = {};
        if (q * kPer < w) a = val_s[(st * kVq + q) * tb + t];
        const T* av = reinterpret_cast<const T*>(&a);
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[q * kPer + i] = av[i];
      }
#pragma unroll
      for (int k = 0; k < WMAX; ++k) {
        const int c = code[k];
        if (c >= 0) {
          const int sc = c & ((1 << kSlotBits) - 1);
          const T* remote = cluster.map_shared_rank(win, sc >> tb_log2);
          xc[k] = remote[(c >> kSlotBits) * tb + (sc & (tb - 1))];
        } else {
          xc[k] = is_global(c) ? xg[k] : T(0);
        }
      }
      T sum = T(0);
#pragma unroll
      for (int k = 0; k < WMAX; ++k)
        if (code[k] != kDepSkip)
          sum = repro::add_rn(sum, repro::mul_rn(v[k], xc[k]));
      xr = repro::mul_rn(repro::sub_rn(b_s[st * tb + t], sum), d_s[st * tb + t]);
      win[(l % kWindow) * tb + t] = xr;
    }
    cluster_arrive();
    if (r >= 0 && wdot != nullptr)
      acc = repro::add_rn(acc, repro::mul_rn(w_s[st * tb + t], xr));
    if (r_prev[1] >= 0) x[r_prev[1]] = x_prev[1];
    r_prev[1] = r_prev[0]; x_prev[1] = x_prev[0];
    r_prev[0] = r; x_prev[0] = xr;
    const int st1 = (l + 1) % kRing;     // the next level: its data is here
    if (has_global && l + 1 < n_levels && id_s[st1 * tb + t] >= 0) {
      int code[WMAX];
      codes_of(st1, code);
#pragma unroll
      for (int k = 0; k < WMAX; ++k)
        if (is_global(code[k])) xn[k] = __ldcg(x + (-(int64_t)code[k] - 2));
    }
    const int l3 = l + kDepth;
    fetch_row(l3, next_s[(l3 % kRing) * tb + t]);
    fetch_id(l3 + kDepth);
    repro::cp_async_commit();
    cluster_wait();
  };

  for (int l = 0; l < kDepth; ++l) {
    const int r = (has_slot && l < n_levels)
                      ? level_grid[(int64_t)l * grid_w + slot] : -1;
    fetch_row(l, r);
    fetch_id(l + kDepth);
    repro::cp_async_commit();
  }
  T xa[WMAX], xb[WMAX];                  // level 0 reads no global x
#pragma unroll
  for (int k = 0; k < WMAX; ++k) xa[k] = xb[k] = T(0);
  for (int l = 0; l < n_levels; l += 2) {
    level(l, xa, xb);
    if (l + 1 < n_levels) level(l + 1, xb, xa);
  }
  repro::cp_async_wait<0>();
  for (int i = 0; i < 2; ++i)
    if (r_prev[i] >= 0) x[r_prev[i]] = x_prev[i];
  // no block may leave while others can still read its window
  cluster.sync();
  if (wdot == nullptr) {
    if (rank == 0 && t == 0) *pp = T(0);
    return;
  }
  acc = repro::block_sum(acc, sh);
  if (t == 0) partials[rank] = acc;
  cluster.sync();
  if (rank != 0 || t != 0) return;
  T total = T(0);
  for (int i = 0; i < (int)cluster.num_blocks(); ++i)
    total = repro::add_rn(total, __ldcg(partials + i));
  *pp = total;
}

constexpr int kDevices = 64;
constexpr int kThreadShapes = 4;      // 32, 64, 128, 256 threads a block

template <typename T, int WMAX>
int launch_cluster_w(const void* dep, const void* vals, const void* dinv,
                     const void* b, const void* wdot, const void* level_grid,
                     void* x, void* partials, void* pp, int32_t n_levels,
                     int32_t grid_w, int32_t w, int32_t has_global,
                     int32_t cluster, int32_t threads, unsigned long long* launches,
                     cudaStream_t stream) {
  auto kern = sptrsv_cluster_kernel<T, WMAX>;
  const size_t smem = cluster_smem<T, WMAX>(threads);
  // The attributes are set, and the occupancy checked, once per device
  // and shape: a launch captured into a CUDA graph makes neither call.
  static std::atomic<size_t> granted[kDevices];
  static std::atomic<int> fits_known[kDevices][kThreadShapes][17];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool cached = dev < kDevices;
  if (!cached || granted[dev].load() < smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (cached) granted[dev].store(smem);
  }
  int shape = 0;
  while ((32 << shape) < threads) ++shape;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!cached || fits_known[dev][shape][cluster].load() == 0) {
    int fits = 0;
    err = cudaOccupancyMaxActiveClusters(&fits, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fits < 1) return (int)cudaErrorInvalidConfiguration;
    if (cached) fits_known[dev][shape][cluster].store(1);
  }
  err = cudaLaunchKernelEx(&cfg, kern, (const int*)dep, (const T*)vals,
                           (const T*)dinv, (const T*)b, (const T*)wdot,
                           (const int*)level_grid, (int)n_levels, (int)grid_w,
                           (int)w, (int)has_global, (T*)x, (T*)partials,
                           (T*)pp, launches);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cluster(const void* dep, const void* vals, const void* dinv,
                   const void* b, const void* wdot, const void* level_grid,
                   void* x, void* partials, void* pp, int32_t n_levels,
                   int32_t grid_w, int32_t w, int32_t has_global,
                   int32_t cluster, int32_t threads, unsigned long long* launches,
                   void* stream) {
  if (n_levels <= 0 || grid_w <= 0 || grid_w > (1 << kSlotBits) || w <= 0 ||
      w > 16 || w % 4 || cluster < 1 || cluster > 16 || threads < 32 ||
      (threads & (threads - 1)) || threads > kClusterThreads ||
      (int64_t)cluster * threads < grid_w ||
      ((uintptr_t)dep | (uintptr_t)vals) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (w <= 8)
    return launch_cluster_w<T, 8>(dep, vals, dinv, b, wdot, level_grid, x,
                                  partials, pp, n_levels, grid_w, w,
                                  has_global, cluster, threads, launches, s);
  return launch_cluster_w<T, 16>(dep, vals, dinv, b, wdot, level_grid, x,
                                 partials, pp, n_levels, grid_w, w,
                                 has_global, cluster, threads, launches, s);
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
           int32_t n_levels, int32_t w, int32_t blocks, unsigned long long* launches,
           void* stream) {
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
  void* args[] = {&c,  &v,  &d,    &bb,  &wd,  &lp,
                  &lr, &nl, &ww, &xx, &part, &out, &launches};
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
                         T* x_out, int wl, int64_t rows_p, int w, int64_t n,
                         unsigned long long* launches) {
  repro::count_launch(launches);
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
                      int64_t n, unsigned long long* launches, void* stream) {
  if (wl <= 0 || rows_p <= 0 || w <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((wl + repro::kThreads - 1) / repro::kThreads);
  sptrsv_level_step_kernel<T><<<blocks, repro::kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)vals, (const T*)diag, (const T*)b,
      (const int*)level_rows, (const T*)x_in, (T*)x_out, wl, rows_p, w, n,
      launches);
  return (int)cudaGetLastError();
}

// -- the redesign: compiled W, one wave of gathers, programmatic launch

constexpr int kLevelThreads = 64;     // sptrsv.py LEVEL_THREADS

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, int W, bool kVec>
__global__ void __launch_bounds__(kLevelThreads)
sptrsv_level_wave_kernel(const int* __restrict__ cols,
                         const T* __restrict__ vals,
                         const T* __restrict__ diag, const T* __restrict__ b,
                         const int* __restrict__ level_rows, const T* x_in,
                         T* x_out, int wl, int rows_p, int n,
                         unsigned long long* launches) {
  pdl_launch_dependents();
  const int i = blockIdx.x * kLevelThreads + threadIdx.x;
  // the level's ids into L2 while the grid before drains: a prefetch
  // returns no value, and L2 is where every store lands, so it cannot
  // bring back a value older than the wait's
  if (i < wl && (i & 31) == 0)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(level_rows + i));
  pdl_wait();                          // before the first read of anything
  const int id = i < wl ? level_rows[i] : -1;
  if (id >= 0) {                       // schedules hold ids >= 0
    const int lr = min(id, rows_p - 1);
    const int* crow = cols + lr * W;   // rows_p * W < 2^31 (the wrapper)
    const T* vrow = vals + lr * W;
    int c[W];
    T v[W];
    if constexpr (kVec) {
      using V = typename Vec16<T>::type;
      constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int4 c4 = reinterpret_cast<const int4*>(crow)[q];
        c[4 * q] = c4.x; c[4 * q + 1] = c4.y;
        c[4 * q + 2] = c4.z; c[4 * q + 3] = c4.w;
      }
#pragma unroll
      for (int q = 0; q < W / kPer; ++q) {
        const V a = reinterpret_cast<const V*>(vrow)[q];
        const T* av = reinterpret_cast<const T*>(&a);
#pragma unroll
        for (int k = 0; k < kPer; ++k) v[q * kPer + k] = av[k];
      }
    } else {
#pragma unroll
      for (int s = 0; s < W; ++s) { c[s] = crow[s]; v[s] = vrow[s]; }
    }
    const T bl = b[lr];
    const T d = diag[min(id, n - 1)];
    T xc[W];
#pragma unroll
    for (int s = 0; s < W; ++s) xc[s] = __ldcg(x_in + min(c[s], n));
    T sum = T(0);
#pragma unroll
    for (int s = 0; s < W; ++s)
      sum = repro::add_rn(sum, repro::mul_rn(c[s] != lr ? v[s] : T(0), xc[s]));
    const T xr = repro::div_rn(repro::sub_rn(bl, sum), d);
    if (id <= n) x_out[id] = xr;
  }
  if ((blockIdx.x | threadIdx.x) == 0) atomicAdd(launches, 1ull);
}

// The launch attribute that makes a launch programmatic-dependent on the
// kernel before it on the stream; `on` = 0 launches plainly.
struct PdlLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  PdlLaunch(unsigned blocks, unsigned threads, int on, cudaStream_t s) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = on ? 1 : 0;
  }
};

inline int launch_error(cudaError_t err) {
  if (err != cudaSuccess) {
    (void)cudaGetLastError();   // clear it: the wrapper raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_wave_w(const void* cols, const void* vals, const void* diag,
                  const void* b, const void* level_rows, const void* x_in,
                  void* x_out, int wl, int rows_p, int n, int vec, int pdl,
                  unsigned long long* launches, cudaStream_t s) {
  auto kern = vec ? sptrsv_level_wave_kernel<T, W, W % 4 == 0>
                  : sptrsv_level_wave_kernel<T, W, false>;
  PdlLaunch l((unsigned)((wl + kLevelThreads - 1) / kLevelThreads),
              kLevelThreads, pdl, s);
  return launch_error(cudaLaunchKernelEx(
      &l.cfg, kern, (const int*)cols, (const T*)vals, (const T*)diag,
      (const T*)b, (const int*)level_rows, (const T*)x_in, (T*)x_out, wl,
      rows_p, n, launches));
}

template <typename T>
int launch_wave(const void* cols, const void* vals, const void* diag,
                const void* b, const void* level_rows, const void* x_in,
                void* x_out, int32_t wl, int32_t rows_p, int32_t w, int32_t n,
                int32_t vec, int32_t pdl, unsigned long long* launches,
                void* stream) {
  if (wl <= 0 || rows_p <= 0 || w <= 0 || n <= 0 || n == INT32_MAX ||
      (int64_t)rows_p * w > INT32_MAX ||
      (vec && (w % 4 || ((uintptr_t)cols | (uintptr_t)vals) % 16)))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
#define WIDTH(W)                                                              \
  return launch_wave_w<T, W>(cols, vals, diag, b, level_rows, x_in, x_out,    \
                             wl, rows_p, n, vec, pdl, launches, s)
  switch (w) {
    case 1: WIDTH(1);
    case 2: WIDTH(2);
    case 3: WIDTH(3);
    case 4: WIDTH(4);
    case 5: WIDTH(5);
    case 6: WIDTH(6);
    case 7: WIDTH(7);
    case 8: WIDTH(8);
    case 16: WIDTH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WIDTH
}

// A kernel that does no work but the programmatic wait and trigger, and
// adds one to *count (if given): the launch floor of a PDL chain
// (chip_smoke.py 11c) and the capture check below.
__global__ void pdl_noop_kernel(unsigned long long* count) {
  pdl_launch_dependents();
  pdl_wait();
  if (count != nullptr && (blockIdx.x | threadIdx.x) == 0) atomicAdd(count, 1ull);
}

int launch_noop(unsigned long long* count, int pdl, cudaStream_t s) {
  PdlLaunch l(1, 32, pdl, s);
  return launch_error(cudaLaunchKernelEx(&l.cfg, pdl_noop_kernel, count));
}

// Whether stream capture keeps the programmatic edge between two
// programmatic-dependent launches: capture two on a stream of its own,
// read the one edge's type, and instantiate the graph.  0 if it does;
// cudaErrorNotSupported if the edge is a full one or the toolkit cannot
// say (before CUDA 12.3, graphs had no edge types); else the CUDA error.
int pdl_capture_check() {
#if CUDART_VERSION < 12030
  return (int)cudaErrorNotSupported;
#else
  cudaStream_t s = nullptr;
  cudaGraph_t g = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err == cudaSuccess)
    err = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    int e1 = launch_noop(nullptr, 1, s);
    int e2 = launch_noop(nullptr, 1, s);
    err = cudaStreamEndCapture(s, &g);
    if (e1 != 0 || e2 != 0) err = (cudaError_t)(e1 != 0 ? e1 : e2);
  }
  cudaGraphNode_t from[2], to[2];
  cudaGraphEdgeData data[2];
  size_t edges = 2;
  if (err == cudaSuccess)
#if CUDART_VERSION >= 13000
    err = cudaGraphGetEdges(g, from, to, data, &edges);
#else
    err = cudaGraphGetEdges_v2(g, from, to, data, &edges);
#endif
  if (err == cudaSuccess &&
      (edges != 1 || data[0].type != cudaGraphDependencyTypeProgrammatic))
    err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  if (exec != nullptr) (void)cudaGraphExecDestroy(exec);
  if (g != nullptr) (void)cudaGraphDestroy(g);
  if (s != nullptr) (void)cudaStreamDestroy(s);
  (void)cudaGetLastError();
  return (int)err;
#endif
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
    void* launches, void* stream) {
  return launch<float>(cols, vals, dinv, b, wdot, level_ptr, level_rows, x,
                       partials, pp, n_levels, w, blocks, (unsigned long long*)launches, stream);
}

extern "C" int repro_sptrsv_solve_dot_f64(
    const void* cols, const void* vals, const void* dinv, const void* b,
    const void* wdot, const void* level_ptr, const void* level_rows, void* x,
    void* partials, void* pp, int32_t n_levels, int32_t w, int32_t blocks,
    void* launches, void* stream) {
  return launch<double>(cols, vals, dinv, b, wdot, level_ptr, level_rows, x,
                        partials, pp, n_levels, w, blocks, (unsigned long long*)launches, stream);
}

extern "C" int repro_sptrsv_level_step_f32(
    const void* cols, const void* vals, const void* diag, const void* b,
    const void* level_rows, const void* x_in, void* x_out, int32_t wl,
    int64_t rows_p, int32_t w, int64_t n, void* launches, void* stream) {
  return launch_level_step<float>(cols, vals, diag, b, level_rows, x_in, x_out,
                                  wl, rows_p, w, n, (unsigned long long*)launches, stream);
}

extern "C" int repro_sptrsv_level_step_f64(
    const void* cols, const void* vals, const void* diag, const void* b,
    const void* level_rows, const void* x_in, void* x_out, int32_t wl,
    int64_t rows_p, int32_t w, int64_t n, void* launches, void* stream) {
  return launch_level_step<double>(cols, vals, diag, b, level_rows, x_in,
                                   x_out, wl, rows_p, w, n, (unsigned long long*)launches, stream);
}

extern "C" int repro_sptrsv_level_wave_f32(
    const void* cols, const void* vals, const void* diag, const void* b,
    const void* level_rows, const void* x_in, void* x_out, int32_t wl,
    int32_t rows_p, int32_t w, int32_t n, int32_t vec, int32_t pdl,
    void* launches, void* stream) {
  return launch_wave<float>(cols, vals, diag, b, level_rows, x_in, x_out, wl,
                            rows_p, w, n, vec, pdl,
                            (unsigned long long*)launches, stream);
}

extern "C" int repro_sptrsv_level_wave_f64(
    const void* cols, const void* vals, const void* diag, const void* b,
    const void* level_rows, const void* x_in, void* x_out, int32_t wl,
    int32_t rows_p, int32_t w, int32_t n, int32_t vec, int32_t pdl,
    void* launches, void* stream) {
  return launch_wave<double>(cols, vals, diag, b, level_rows, x_in, x_out, wl,
                             rows_p, w, n, vec, pdl,
                             (unsigned long long*)launches, stream);
}

// 0 if stream capture keeps programmatic edges on the current device.
extern "C" int repro_pdl_capture_check() { return pdl_capture_check(); }

// One no-work programmatic-dependent launch (plain with pdl = 0) that adds
// one to *count.
extern "C" int repro_pdl_noop(void* count, int32_t pdl, void* stream) {
  return launch_noop((unsigned long long*)count, pdl, (cudaStream_t)stream);
}

extern "C" int repro_sptrsv_cluster_f32(
    const void* dep, const void* vals, const void* dinv, const void* b,
    const void* wdot, const void* level_grid, void* x, void* partials,
    void* pp, int32_t n_levels, int32_t grid_w, int32_t w, int32_t has_global,
    int32_t cluster, int32_t threads, void* launches, void* stream) {
  return launch_cluster<float>(dep, vals, dinv, b, wdot, level_grid, x, partials,
                               pp, n_levels, grid_w, w, has_global, cluster,
                               threads, (unsigned long long*)launches, stream);
}

extern "C" int repro_sptrsv_cluster_f64(
    const void* dep, const void* vals, const void* dinv, const void* b,
    const void* wdot, const void* level_grid, void* x, void* partials,
    void* pp, int32_t n_levels, int32_t grid_w, int32_t w, int32_t has_global,
    int32_t cluster, int32_t threads, void* launches, void* stream) {
  return launch_cluster<double>(dep, vals, dinv, b, wdot, level_grid, x, partials,
                               pp, n_levels, grid_w, w, has_global, cluster,
                               threads, (unsigned long long*)launches, stream);
}
