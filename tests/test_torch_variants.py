"""The pure-Python parts of the redesigned ``ell_spmv``,
``sptrsv_solve_dot`` and ``spmv_dot`` kernels, on the CPU.

Each kernel has two variants that the wrapper picks from the operands'
shape and alignment alone: ``ell_spmv.spmv_variant`` (the ELL width) and
``sptrsv.solve_variant`` with ``sptrsv.cluster_geometry`` (the schedule's
levels and widest level, the factor's width).  The tests hold those choices
to their rules: a function of the shape only, a misaligned operand sent to
the variant that takes any pointer, every row covered, a cluster of at most
16 blocks.  ``sptrsv.solve_pack`` now also builds the level grid and the
dependency codes that the cluster variant reads; both are held against
``core/levels.py``'s schedule (and the JAX package's) on the lap2d and
random cases, the codes are bound to the cols tensor they came from, and
the engine's device footprint counts them.

The row variants of ``ell_spmv`` fold a row's virtual lanes in registers
where the group variant shuffles between lanes; a numpy model of both sums
shows they are the same bits, which the card tests then check on the
kernels themselves (``tests/test_torch_cuda.py``).

The four ``spmv_dot`` wrappers pick their variant with ``ell_spmv``'s rule
(``pick_variant``) and launch the rows kernel on ``spmv_dot.rows_grid``.
Their pap sums each lane's rows in the first design's thread blocks; a
numpy model of that design's ``block_sum`` and of the rows kernel's
``vblock_sum`` (shuffles within a warp that owns whole blocks) shows the
two give the same partials bit for bit.

``sptrsv_level_step`` picks its redesign ("vec", "wave") or its first
design from the ELL width, the dtype, the alignment and the index range
(``sptrsv.level_step_variant``); a numpy model of the new kernel's
thread-to-row map shows every id of a ragged level solved exactly once.

``ell_spmm`` takes the same rule and the same rows grid.  ``bcsr_spmm``
picks its smem variant from (bm, bn, dtype, x's layout, alignment)
alone; its grids cover every (row, lane), and a numpy model of the smem
variant's staging buffers shows them disjoint, complete, and read by the
block rows of one warp on distinct banks.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.levels import build_schedule as jax_build_schedule
from repro_torch.core.engine import AzulEngine
from repro_torch.core.formats import csr_from_scipy
from repro_torch.core.levels import build_schedule
from repro_torch.core.precond import ic0
from repro_torch.data.matrices import laplacian_2d
from repro_torch.kernels import autotune, bcsr_spmm, ell_spmv, ops, spmv_dot, sptrsv
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    # ell_spmv.pick_variant takes a recorded winner before the shape rule:
    # these tests hold the rule, so no winner is recorded
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.clear_memo()
    yield
    autotune.clear_memo()


def _lower(n, density, seed):
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    low = sp.tril(a, -1).tocsr()
    return csr_from_scipy(low + sp.diags(np.asarray(abs(low).sum(1)).ravel() + 1))


def _schedules():
    f = ic0(laplacian_2d(16), dtype=np.float64, device="cpu")
    out = {"lap2d_16 L": (f.sched_l, f.ell_l.rows_padded),
           "lap2d_16 reversed U": (f.sched_u_rev, f.ell_u_rev.rows_padded)}
    for n, dens in ((300, 0.02), (1000, 0.005)):
        m = _lower(n, dens, n)
        out[f"random {n}"] = (build_schedule(m), -(-n // 8) * 8)
    return out


SCHEDULES = ["lap2d_16 L", "lap2d_16 reversed U", "random 300", "random 1000"]


# -- ell_spmv -------------------------------------------------------------


@pytest.mark.parametrize("width", list(range(1, 41)) + [64, 100, 264])
def test_spmv_variant_is_a_function_of_the_width(width):
    got = ell_spmv.spmv_variant(width)
    assert got in ell_spmv.SPMV_VARIANTS
    assert got == ell_spmv.spmv_variant(width)
    rows = width % 4 == 0 and width <= 16
    assert got == ("rows" if rows else "group")
    if rows:
        # a thread holds the row's group of virtual lanes: W <= G <= 16
        assert width <= ell_spmv.group_size(width) <= 16
    # operands off a 16-byte boundary go to the group kernel, which takes
    # any pointer
    assert ell_spmv.spmv_variant(width, aligned=False) == "group"


def _butterfly(lanes):
    """The group kernel's sum: every lane adds the xor partner's value,
    offsets G/2 down to 1 (repro::group_sum); lane 0's result."""
    v = list(lanes)
    off = len(v) // 2
    while off:
        v = [v[g] + v[g ^ off] for g in range(len(v))]
        off //= 2
    return v[0]


def _folded(lanes):
    """The row kernels' sum: virtual lanes folded in registers,
    s[g] = s[g] + s[g + off] for g < off (common.cuh row_dot_halves)."""
    s = list(lanes)
    off = len(s) // 2
    while off:
        for g in range(off):
            s[g] = s[g] + s[g + off]
        off //= 2
    return s[0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("width", [4, 8, 12, 16])
def test_register_fold_is_the_butterfly(width, dtype):
    rng = np.random.default_rng(width)
    g = ell_spmv.group_size(width)
    for _ in range(200):
        prods = (rng.standard_normal(width) * 10.0 ** rng.integers(-8, 8, width))
        lanes = [dtype(p) for p in prods.astype(dtype)] + [dtype(0)] * (g - width)
        a, b = _butterfly(lanes), _folded(lanes)
        assert a.tobytes() == b.tobytes()


def _halves(lanes):
    """row_dot_halves: the first half's and the second half's products
    added pairwise, then the fold over the first half (common.cuh)."""
    h = len(lanes) // 2
    return _folded([a + b for a, b in zip(lanes[:h], lanes[h:])])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("width", [4, 8, 12, 16])
def test_halves_fold_is_the_butterfly(width, dtype):
    rng = np.random.default_rng(100 + width)
    g = ell_spmv.group_size(width)
    for _ in range(200):
        prods = (rng.standard_normal(width) * 10.0 ** rng.integers(-8, 8, width))
        lanes = [dtype(p) for p in prods.astype(dtype)] + [dtype(0)] * (g - width)
        assert _butterfly(lanes).tobytes() == _halves(lanes).tobytes()


# -- spmv_dot -------------------------------------------------------------

SPMV_DOT = ["ell_spmv_pfold_dot", "ell_spmm_pfold_dot", "ell_spmv_dot",
            "ell_spmm_dot"]


@pytest.mark.parametrize("name", SPMV_DOT)
@pytest.mark.parametrize("width", [4, 8, 12, 16, 24, 264])
def test_spmv_dot_variant_follows_the_ell_spmv_rule(width, name):
    """The spmv_dot wrappers take ell_spmv's rule: rows for W a multiple of
    4 up to 16 with 16-byte aligned cols and vals, else group; a forced
    variant is honoured where the operands admit it and raises where they
    do not."""
    cols = torch.zeros(64, width, dtype=torch.int32)
    vals = torch.zeros(64, width, dtype=torch.float64)
    moved = torch.zeros(64 * width + 1, dtype=torch.float64)[1:].view(64, width)
    assert (cols.data_ptr() | vals.data_ptr()) % 16 == 0
    rows_ok = width % 4 == 0 and width <= 16
    want = "rows" if rows_ok else "group"
    assert ell_spmv.pick_variant(name, cols, vals, None) == want
    assert want == ell_spmv.spmv_variant(width)
    assert ell_spmv.pick_variant(name, cols, vals, "group") == "group"
    assert ell_spmv.pick_variant(name, cols, moved, None) == "group"
    if rows_ok:
        assert ell_spmv.pick_variant(name, cols, vals, "rows") == "rows"
    else:
        with pytest.raises(ValueError, match=f"{name}: the rows variant"):
            ell_spmv.pick_variant(name, cols, vals, "rows")
    with pytest.raises(ValueError, match="aligned"):
        ell_spmv.pick_variant(name, cols, moved, "rows")
    with pytest.raises(ValueError, match="not in"):
        ell_spmv.pick_variant(name, cols, vals, "bulk")


@pytest.mark.parametrize("width", [4, 8, 12, 16])
@pytest.mark.parametrize("rows", [1, 255, 256, 257, 511, 513, 5000, 1 << 20])
def test_spmv_dot_rows_grid_covers_every_row(rows, width):
    """The rows kernel's warps stride over units of 32 rows (64 at W = 4,
    a whole block of the first design): the grid is the blocks every SM
    holds (5 at W <= 8, 3 at W = 16), never more than the rows need, and
    every unit has a warp."""
    g = ell_spmv.group_size(width)
    unit = 64 if g == 4 else 32
    units = -(-rows // unit)
    for sms in (1, 7, 132):
        grid = spmv_dot.rows_grid(rows, width, sms)
        assert 1 <= grid <= {4: 5, 8: 5, 16: 3}[g] * sms
        assert grid <= max(-(-units // 8), 1)
        assert grid == spmv_dot.rows_grid(rows, width, sms)
        if rows <= 5000:
            warps = grid * 8
            assert {u % warps for u in range(units)} <= set(range(warps))
            assert all(u < units for u in range(min(warps, units)))
    assert spmv_dot.rows_grid(1 << 20, width) == {4: 5, 8: 5, 16: 3}[g] * 132
    # the partials do not depend on the variant: the first design's blocks
    assert spmv_dot.pap_blocks(rows, width) == -(-rows // (256 // g))


def _shfl_down(v, off):
    """__shfl_down_sync over a warp: lane l reads lane l + off, or keeps its
    own value where l + off is past the warp."""
    out = v.copy()
    out[: 32 - off] = v[off:]
    return out


def _warp_sum(v):
    for off in (16, 8, 4, 2, 1):
        v = v + _shfl_down(v, off)
    return v[0]


def _first_design_partials(contrib, g):
    """repro::block_sum over the first design's blocks of 256 threads:
    block b's row i in thread i * g (+0 in the others and past the rows),
    each warp's shfl_down tree, then the 8 warp sums in warp order."""
    r = 256 // g
    nblocks = -(-len(contrib) // r)
    out = np.empty(nblocks)
    for b in range(nblocks):
        threads = np.zeros(256)
        rows = contrib[b * r:(b + 1) * r]
        threads[np.arange(len(rows)) * g] = rows
        sh = np.zeros(32)
        sh[:8] = [_warp_sum(threads[32 * w:32 * w + 32]) for w in range(8)]
        out[b] = _warp_sum(sh)
    return out


def _rows_design_partials(contrib, g):
    """repro::vblock_sum: a warp owns 32 rows a pass (two passes at G = 4),
    lane l row base + 32q + l (+0 past the rows): each pass folds its
    virtual warps of M = 32 / G rows (shfl_down M/2 .. 1) and adds +0,
    then the 8 virtual-warp sums fold in lanes M apart (the two passes
    first at G = 4); lanes l % R == 0 hold the partials."""
    m, passes, r = 32 // g, (2 if g == 4 else 1), 256 // g
    unit = 32 * passes
    nblocks = -(-len(contrib) // r)
    padded = np.zeros(-(-len(contrib) // unit) * unit)
    padded[: len(contrib)] = contrib
    out = np.full(nblocks, np.nan)
    for base in range(0, len(padded), unit):
        s = []
        for q in range(passes):
            v = padded[base + 32 * q: base + 32 * q + 32].copy()
            off = m // 2
            while off:
                v = v + _shfl_down(v, off)
                off //= 2
            s.append(v + 0.0)
        t = s[0] + s[1] if passes == 2 else s[0]
        off = (2 if passes == 2 else 4) * m
        while off >= m:
            t = t + _shfl_down(t, off)
            off //= 2
        for lane in range(0, 32, min(r, 32)):
            b = (base + lane) // r
            if b < nblocks:
                out[b] = t[lane]
    return out


@pytest.mark.parametrize("g", [4, 8, 16])
@pytest.mark.parametrize("rows", [1, 15, 16, 31, 33, 64, 100, 257, 1000])
def test_pap_partials_equal_the_first_design(rows, g):
    """The rows kernel's pap partials are the first design's bit for bit,
    over random float64 contributions of mixed magnitudes, signed zeros
    and ragged row counts."""
    rng = np.random.default_rng(rows * 17 + g)
    for trial in range(20):
        c = rng.standard_normal(rows) * 10.0 ** rng.integers(-12, 12, rows)
        if trial % 4 == 1:
            c[rng.random(rows) < 0.3] = -0.0
        if trial % 4 == 2:
            c[:] = -0.0
        want = _first_design_partials(c, g)
        got = _rows_design_partials(c, g)
        assert want.tobytes() == got.tobytes()


# -- ell_spmm ---------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 4, 5, 8, 12, 16, 20, 33, 264])
def test_ell_spmm_variant_follows_spmv_variant(width):
    """ell_spmm takes ell_spmv's rule: the rows kernel (spmv_dot.cu's, the
    dot compiled out) for W a multiple of 4 up to 16 with 16-byte aligned
    cols and vals, the row groups otherwise; a forced rows variant on
    operands it does not take raises, naming ell_spmm."""
    cols = torch.zeros(64, width, dtype=torch.int32)
    vals = torch.zeros(64, width, dtype=torch.float32)
    moved = torch.zeros(64 * width + 1, dtype=torch.float32)[1:].view(64, width)
    for v, aligned in ((vals, True), (moved, False)):
        assert (ell_spmv.pick_variant("ell_spmm", cols, v, None)
                == ell_spmv.spmv_variant(width, aligned))
        assert ell_spmv.pick_variant("ell_spmm", cols, v, "group") == "group"
    if ell_spmv.spmv_variant(width) == "rows":
        assert ell_spmv.pick_variant("ell_spmm", cols, vals, "rows") == "rows"
    else:
        with pytest.raises(ValueError, match="ell_spmm: the rows variant"):
            ell_spmv.pick_variant("ell_spmm", cols, vals, "rows")
    with pytest.raises(ValueError, match="ell_spmm: the rows variant"):
        ell_spmv.pick_variant("ell_spmm", cols, moved, "rows")


def test_ell_spmm_rows_grid_is_the_spmv_dot_grid():
    """ell_spmv and ell_spmm run spmv_dot.cu's rows kernel (the dot compiled
    out) on the grid the spmv_dot wrappers launch it on: one function,
    shared by both modules."""
    assert spmv_dot.rows_grid is ell_spmv.rows_grid
    for w in (4, 8, 12, 16):
        assert ell_spmv.rows_grid(1 << 20, w) == {4: 5, 8: 5, 16: 3}[
            ell_spmv.group_size(w)] * 132


# -- bcsr_spmm ---------------------------------------------------------------

BCSR_BM = list(range(1, 17))
BCSR_BN = [1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 64, 128]


def _bcsr_rule(bm, bn, itemsize, x_vec, aligned):
    """csrc/bcsr_spmm.cu's admission rule, written out: smem takes bn = 4,
    8 or 16, bm = 4, 8 or 16, 16-byte aligned blocks, lanes-major aligned
    x and its two buffers of 16 lanes within 227 KB; first takes all."""
    admits = {"first"}
    if (bn in (4, 8, 16) and bm in (4, 8, 16) and aligned and x_vec
            and bcsr_spmm.smem_layout(bm, bn, 16, itemsize)["bytes"]
            <= 232448):
        admits.add("smem")
    return admits


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("bn", BCSR_BN)
def test_bcsr_pick_variant_is_a_function_of_the_shape(bn, dtype):
    """pick_variant depends on (bm, bn, dtype, x's layout, alignment) and
    nothing else: the same answer twice, smem where it applies, the first
    design for every bn that is not compiled; a forced variant is
    honoured where the operands admit it and raises where they do not."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for bm in BCSR_BM:
        for x_vec in (True, False):
            for aligned in (True, False):
                args = (bm, bn, dtype, x_vec, aligned)
                admits = _bcsr_rule(bm, bn, itemsize, x_vec, aligned)
                got = bcsr_spmm.pick_variant(*args)
                assert got == bcsr_spmm.pick_variant(*args)
                want = "smem" if "smem" in admits else "first"
                assert got == want, (args, admits)
                if bn not in bcsr_spmm.COMPILED_BN:
                    assert got == "first"
                for v in bcsr_spmm.BCSR_VARIANTS:
                    if v in admits:
                        assert bcsr_spmm.pick_variant(*args, variant=v) == v
                    else:
                        with pytest.raises(ValueError, match=f"the {v} variant"):
                            bcsr_spmm.pick_variant(*args, variant=v)
    with pytest.raises(ValueError, match="not in"):
        bcsr_spmm.pick_variant(8, 8, dtype, True, True, variant="mma")


def test_bcsr_x_vectorized_follows_layout_and_alignment():
    """x's 16-byte path: lanes-major (or one lane) with every lane's column
    on a 16-byte boundary; the JAX layout (row-major, R > 1), a view one
    element in, and an odd float64 lane stride take the scalar path."""
    v = torch.zeros(4, 64, dtype=torch.float64)
    assert bcsr_spmm.x_vectorized(v.T)                   # the solver layout
    assert bcsr_spmm.x_vectorized(v[0][:, None])         # one RHS
    assert bcsr_spmm.x_vectorized(v.T[:, 1:2])           # one lane of a batch
    assert not bcsr_spmm.x_vectorized(v.T.contiguous())  # row-major, R = 4
    assert not bcsr_spmm.x_vectorized(v.T.contiguous()[:, :1])  # row stride 4
    moved = torch.zeros(4 * 64 + 1, dtype=torch.float64)[1:].view(4, 64)
    assert not bcsr_spmm.x_vectorized(moved.T)
    odd = torch.zeros(4, 65, dtype=torch.float64)[:, :64]
    assert not bcsr_spmm.x_vectorized(odd.T)
    assert bcsr_spmm.x_vectorized(torch.zeros(4, 68, dtype=torch.float32)[:, :64].T)


@pytest.mark.parametrize("variant", ["smem", "first"])
@pytest.mark.parametrize("r", [1, 2, 3, 8, 9, 16, 17, 33])
def test_bcsr_grids_cover_every_row(r, variant):
    """Every (row, lane) has a thread: a row a thread over blocks of 256
    (256 / bm block rows a block for smem), and lane chunks of at most 16
    lanes (8 for the first design), the power of two >= R, so R = 16 is
    one launch of smem."""
    chunk = bcsr_spmm.lane_chunk(r, variant)
    assert chunk & (chunk - 1) == 0
    assert chunk == min(8 if variant == "first" else 16,
                        1 << (r - 1).bit_length())
    for bm in (4, 8, 16) if variant == "smem" else (1, 3, 8, 16):
        for nbr in (1, 31, 32, 33, 131072):
            gx, gy = bcsr_spmm.launch_grid(variant, nbr, bm, r)
            if variant == "smem":
                assert (gx - 1) * (256 // bm) < nbr <= gx * (256 // bm)
            else:
                assert (gx - 1) * 256 < nbr * bm <= gx * 256
            assert (gy - 1) * chunk < r <= gy * chunk
    assert bcsr_spmm.launch_grid(variant, 131072, 8, 16)[1] == (
        2 if variant == "first" else 1)


def _smem_staging(bm, bn, k, itemsize, buf):
    """The smem kernel's staging loop (csrc/bcsr_spmm.cu stage): chunk q of
    the block's 256 / bm block rows x K lanes x bn / (16 / itemsize)
    16-byte pieces -> the (block row, lane, first value) it copies and its
    byte offset in the buffer ``buf``."""
    vec = 16 // itemsize
    pieces = bn // vec
    per_block = 256 // bm
    lay = bcsr_spmm.smem_layout(bm, bn, k, itemsize)
    stride = lay["row_stride"] // itemsize
    for q in range(per_block * k * pieces):
        piece, jj, b = q % pieces, (q // pieces) % k, q // (pieces * k)
        dst = buf * per_block * stride + b * stride + jj * bn + piece * vec
        yield (b, jj, piece * vec), dst * itemsize


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("bn", [4, 8, 16])
@pytest.mark.parametrize("bm", [4, 8, 16])
def test_bcsr_smem_layout(bm, bn, k, itemsize):
    """A numpy model of the smem variant's shared memory: the 16-byte
    pieces of both buffers are disjoint and inside the allocation, every x
    value a slot needs (block row, lane, column) is staged once, and the
    block rows of one warp read each 16-byte word from distinct banks."""
    lay = bcsr_spmm.smem_layout(bm, bn, k, itemsize)
    if (bcsr_spmm.smem_layout(bm, bn, 16, itemsize)["bytes"] > 232448):
        assert "smem" not in _bcsr_rule(bm, bn, itemsize, True, True)
        return
    spans, covered = [], set()
    for buf in (0, 1):
        for (b, jj, n0), off in _smem_staging(bm, bn, k, itemsize, buf):
            assert off % 16 == 0 and off + 16 <= lay["bytes"]
            spans.append((off, off + 16))
            if buf == 0:
                covered |= {(b, jj, n0 + i) for i in range(16 // itemsize)}
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert covered == {(b, jj, n) for b in range(256 // bm)
                       for jj in range(k) for n in range(bn)}
    # a warp's threads cover 32 / bm block rows, all reading the same
    # (lane, column) word of their own row at once
    stride = lay["row_stride"]
    for b0 in range(0, 256 // bm, 32 // bm):
        banks = [{(b * stride + w) // 4 % 32 for w in range(0, 16, 4)}
                 for b in range(b0, b0 + 32 // bm)]
        assert all(not (x & y) for i, x in enumerate(banks)
                   for y in banks[i + 1:])


# -- sptrsv_level_step ---------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("width", list(range(1, 18)))
def test_level_step_variant_is_a_function_of_the_shape(width, dtype, aligned):
    """The redesign where its width is compiled (1-8 and 16), with 16-byte
    row loads only where a row is whole vectors of cols and of values and
    the operands are aligned; the first design elsewhere and wherever the
    ids do not fit 32 bits."""
    got = sptrsv.level_step_variant(width, dtype, aligned)
    assert got in sptrsv.LEVEL_VARIANTS
    assert got == sptrsv.level_step_variant(width, dtype, aligned)
    compiled = width <= 8 or width == 16
    want = ("first" if not compiled
            else "vec" if aligned and width % 4 == 0 else "wave")
    assert got == want
    assert sptrsv.level_step_variant(width, dtype, aligned,
                                     index32=False) == "first"
    assert (width in sptrsv.LEVEL_WIDTHS) == compiled


def test_level_step_variant_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or float64"):
        sptrsv.level_step_variant(8, torch.float16)


def _level_kernel_writes(level_rows: np.ndarray, n: int) -> np.ndarray:
    """A numpy model of sptrsv_level_wave_kernel's thread-to-row map
    (csrc/sptrsv.cu launch_wave_w): ceil(W / LEVEL_THREADS) blocks, thread
    t of block k takes entry i = k * LEVEL_THREADS + t where i < W, and
    writes x[id] for an id >= 0 that is <= n.  Returns how many times each
    slot of x (n + 1) is written."""
    wl = level_rows.shape[0]
    threads = sptrsv.LEVEL_THREADS
    blocks = -(-wl // threads)
    i = (np.arange(blocks)[:, None] * threads + np.arange(threads)[None, :]).ravel()
    ids = np.where(i < wl, level_rows[np.minimum(i, wl - 1)], -1)
    return np.bincount(ids[(ids >= 0) & (ids <= n)], minlength=n + 1)


@pytest.mark.parametrize("wl", [1, 255, 256, 257, 1024, 4095])
def test_level_step_grid_solves_every_id_once(wl):
    """Every real id of a ragged level is solved exactly once, ids past n
    (the schedule's padding) never."""
    n = 5000
    rng = np.random.default_rng(wl)
    real = max(wl - wl // 7, 1)
    ids = np.concatenate([rng.choice(n, size=real, replace=False),
                          np.full(wl - real, n + 3)]).astype(np.int32)
    rng.shuffle(ids)
    writes = _level_kernel_writes(ids, n)
    want = np.zeros(n + 1, np.int64)
    want[ids[ids <= n]] = 1
    assert np.array_equal(writes, want)
    assert sptrsv.LEVEL_THREADS % 32 == 0             # whole warps


# -- sptrsv_solve_dot --------------------------------------------------------


@pytest.mark.parametrize("width", [4, 8, 12, 16])
@pytest.mark.parametrize("max_width", [1, 31, 127, 128, 129, 1000, 1024, 2047,
                                       2048, 2049, 4095, 4096])
def test_cluster_geometry_covers_the_widest_level(max_width, width):
    cap = sptrsv.cluster_max_threads(width)
    assert cap == (256 if width <= 8 else 128)
    if max_width > 16 * cap:
        with pytest.raises(ValueError, match="does not fit"):
            sptrsv.cluster_geometry(max_width, width=width)
        return
    blocks, threads = sptrsv.cluster_geometry(max_width, width=width)
    assert 1 <= blocks <= 16 and 32 <= threads <= cap
    assert threads & (threads - 1) == 0 and blocks * threads >= max_width
    # as many blocks as whole warps allow, the fewest threads that fit
    assert blocks == 16 or threads == 32
    assert threads == 32 or blocks * threads // 2 < max_width
    assert (blocks, threads) == sptrsv.cluster_geometry(max_width, width)


def test_cluster_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        sptrsv.cluster_geometry(16 * 256 + 1)
    with pytest.raises(ValueError, match="does not fit"):
        sptrsv.cluster_geometry(16 * 128 + 1, width=16)


@pytest.mark.parametrize("width", [1, 3, 4, 8, 12, 16, 24])
def test_solve_variant_is_a_function_of_the_shape(width):
    for n_levels, max_width in ((1, 1), (2047, 1024), (7, 2048), (7, 2049),
                                (7, 4096), (7, 4097), (3, 100_000)):
        got = sptrsv.solve_variant(n_levels, max_width, width)
        assert got in sptrsv.SOLVE_VARIANTS
        assert got == sptrsv.solve_variant(n_levels, max_width, width)
        cluster = (width % 4 == 0 and width <= 16 and max_width
                   <= 16 * sptrsv.cluster_max_threads(width))
        assert got == ("cluster" if cluster else "cooperative")
        if got == "cluster":
            blocks, threads = sptrsv.cluster_geometry(max_width, width=width)
            assert blocks <= 16 and blocks * threads >= max_width
        # misaligned values go to the cooperative kernel
        assert sptrsv.solve_variant(n_levels, max_width, width,
                                    aligned=False) == "cooperative"


@pytest.mark.parametrize("name", SCHEDULES)
def test_pack_arrays_follow_the_schedule(name):
    sched, rows_p = _schedules()[name]
    rows = np.asarray(sched.rows)
    n = sched.n
    pack = sptrsv.solve_pack(rows, n, rows_p, "cpu")
    counts = np.asarray(sched.counts)
    assert pack.n_levels == sched.n_levels and pack.max_width == counts.max()
    np.testing.assert_array_equal(np.diff(pack.level_ptr.numpy()), counts)
    grid = pack.level_grid.numpy()
    assert grid.shape == (sched.n_levels, counts.max()) and grid.dtype == np.int32
    for lv in range(sched.n_levels):
        c = counts[lv]
        np.testing.assert_array_equal(grid[lv, :c], rows[lv, :c])
        assert (grid[lv, c:] == -1).all()
        np.testing.assert_array_equal(
            pack.level_rows.numpy()[pack.level_ptr[lv]: pack.level_ptr[lv + 1]],
            rows[lv, :c])
    # every row exactly once, in the level the schedule gives it
    real = grid[grid >= 0]
    assert sorted(real.tolist()) == list(range(n))
    lv_of = np.repeat(np.arange(sched.n_levels), counts)
    np.testing.assert_array_equal(np.asarray(sched.level_of)[real], lv_of)
    # built without the factor's columns: no codes, bound to no tensor
    assert pack.dep is None and pack.cols_key is None
    assert not pack.built_from(torch.zeros(rows_p, 8, dtype=torch.int32))


@pytest.mark.parametrize("name", SCHEDULES)
def test_cluster_slots_cover_each_level(name):
    """The cluster kernel's thread (rank, t) owns slot rank * threads + t
    of every level: under the chosen geometry every listed row has a slot,
    and a level's rows only ever read rows of earlier levels."""
    sched, rows_p = _schedules()[name]
    pack = sptrsv.solve_pack(np.asarray(sched.rows), sched.n, rows_p, "cpu")
    blocks, threads = sptrsv.cluster_geometry(pack.max_width, width=8)
    grid = pack.level_grid.numpy()
    slots = np.arange(blocks * threads)
    owned = [grid[lv, slots[slots < grid.shape[1]]]
             for lv in range(pack.n_levels)]
    got = np.concatenate([o[o >= 0] for o in owned])
    assert sorted(got.tolist()) == list(range(sched.n))


@pytest.mark.parametrize("n,density", [(300, 0.02), (1000, 0.005)])
def test_pack_grid_equals_the_jax_schedule(n, density):
    """The level grid is the JAX package's schedule with its sentinel
    replaced by -1 and its width cut to the widest level."""
    m = _lower(n, density, n)
    from repro.core.formats import CSR as JCSR

    jm = JCSR(m.indptr, m.indices, m.data, m.shape)
    js = jax_build_schedule(jm)
    jrows = np.asarray(js.rows)
    pack = sptrsv.solve_pack(jrows, n, -(-n // 8) * 8, "cpu")
    want = np.where(jrows < n, jrows, -1)[:, : pack.max_width]
    np.testing.assert_array_equal(pack.level_grid.numpy(), want)


@pytest.mark.parametrize("name", SCHEDULES)
def test_dependency_codes_follow_the_schedule(name):
    """The cluster kernel's code of every slot, row by row against the
    schedule's levels: the diagonal skipped, a column solved fewer than
    DEP_WINDOW levels earlier read from its level's window slot, an older
    one from global x, anything not solved before the row's level as 0."""
    f = ic0(laplacian_2d(16), dtype=np.float64, device="cpu")
    sched, rows_p = _schedules()[name]
    if name.startswith("lap2d"):
        ell = f.ell_l if name.endswith(" L") else f.ell_u_rev
    else:
        n = int(name.split()[1])
        from repro_torch.core.formats import ell_from_csr
        ell = ell_from_csr(_lower(n, 0.02 if n == 300 else 0.005, n),
                           row_pad=8, width_pad=8, device="cpu")
    cols = ell.cols.numpy()
    pack = sptrsv.solve_pack(np.asarray(sched.rows), sched.n, rows_p, "cpu",
                             cols=ell.cols)
    dep = pack.dep.numpy()
    assert dep.shape == cols.shape and dep.dtype == np.int32
    level_of = np.asarray(sched.level_of)
    slot = {}
    for lv in range(sched.n_levels):
        for s, r in enumerate(pack.level_grid.numpy()[lv]):
            if r >= 0:
                slot[int(r)] = s
    win, bits = sptrsv.DEP_WINDOW, sptrsv.DEP_SLOT_BITS
    kinds = set()
    for r in range(rows_p):
        for k, c in enumerate(cols[r]):
            code = int(dep[r, k])
            if r >= sched.n or c == r:
                assert code == sptrsv.DEP_SKIP
                continue
            lr, lc = level_of[r], (level_of[c] if c < sched.n else -1)
            if lc < 0 or lc >= lr:
                assert code == sptrsv.DEP_ZERO, (r, k)
                kinds.add("zero")
            elif lr - lc < win:
                assert code == (lc % win) << bits | slot[int(c)], (r, k)
                kinds.add("window")
            else:
                assert code == -(int(c) + 2), (r, k)
                kinds.add("global")
    assert "window" in kinds
    assert pack.dep_global == ("global" in kinds)


def test_pack_is_bound_to_its_cols():
    """The cluster variant reads the pack's dependency codes in place of
    cols, so a pack holds for the cols tensor it was built from, unmodified,
    and for no other: not an equal copy, not another factor of the same
    shape and schedule, not the same tensor after an in-place write."""
    f = ic0(laplacian_2d(16), dtype=np.float64, device="cpu")
    cols = f.ell_l.cols.clone()
    pack = ops.sptrsv_solve_pack(cols, f.sched_l.rows, f.n)
    assert pack.built_from(cols)
    assert not pack.built_from(cols.clone())
    assert not pack.built_from(f.ell_u_rev.cols)
    cols[0, 0] = cols[0, 0]
    assert not pack.built_from(cols)
    # numpy columns give codes bound to no tensor
    loose = sptrsv.solve_pack(f.sched_l.rows, f.n, cols.shape[0], "cpu",
                              cols=cols.numpy())
    assert loose.dep is not None and not loose.built_from(cols)


def test_device_bytes_counts_every_pack_tensor():
    """A block-IC(0) engine's footprint counts both solve packs whole: the
    level lists, the level grid and the dependency codes."""
    m = laplacian_2d(16)
    eng = AzulEngine(m, precond="block_ic0", dtype=np.float64, device="cpu")
    f = eng._ic0
    packs = [ops.sptrsv_solve_pack(f.ell_l.cols, f.sched_l.rows, f.n),
             ops.sptrsv_solve_pack(f.ell_u_rev.cols, f.sched_u_rev.rows, f.n)]
    pack_bytes = sum(t.numel() * t.element_size() for p in packs for t in p
                     if isinstance(t, torch.Tensor))
    assert all(p.dep is not None and p.dep.shape == e.cols.shape
               for p, e in zip(packs, (f.ell_l, f.ell_u_rev)))
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    want = (nbytes(eng._dinv_pad, eng.ell.cols, eng.ell.vals)
            + nbytes(f.ell_l.cols, f.ell_l.vals, f.sched_l.rows,
                     f.ell_u_rev.cols, f.ell_u_rev.vals, f.sched_u_rev.rows)
            + nbytes(f.ell_l.vals[:, 0], f.ell_u_rev.vals[:, 0])   # dinv
            + pack_bytes)
    assert eng.device_bytes() == want
