"""AzulEngine: the public solve API of the port.

Port of ``repro.core.engine``.  Given a square sparse matrix (or a
matrix-free ``Stencil``), a local engine (``mesh=None``)

  1. runs the host-side "task compiler": padded-ELL packing (row_pad and
     width_pad 8), the Jacobi inverse diagonal, and the per-matrix storage
     format choice (``format="auto"``: the JAX package's rule over modeled
     matrix-stream words, cached on disk by ``kernels.autotune``);
  2. pins the packed operator on the device once (``device="cuda"`` by
     default; ``device="cpu"`` runs the kernels' plain versions), and
     builds a SELL, HYB or BCSR container on the first plan that streams
     it;
  3. lowers ``SolveSpec``s into cached ``SolvePlan``s
     (``engine.plan(spec)(b)``) whose fused substrate runs the hand-written
     kernels.  On padded ELL: ``ell_spmv`` for the initial residual, then
     ``ell_spmv_pfold_dot`` and ``cg_update`` once per iteration; for a
     batched plan (``SolveSpec(batch=k)``, ``plan(B)`` with B (k, n))
     their multi-RHS twins ``ell_spmm``, ``ell_spmm_pfold_dot`` and the
     batched ``cg_update``.  On BCSR every matvec is a ``bcsr_spmm``
     launch; SELL, HYB and the stencil stream the operator through plain
     PyTorch matvecs (``spops``, ``stencil``); ``cg_update`` runs for
     every format.  With ``precond="block_ic0"`` the engine also factors A
     on the host (IC(0) and both level schedules) and pins the factors on
     the device; the fused IC(0) substrate then runs two
     ``sptrsv_solve_dot`` launches per iteration (per lane of a batch) in
     place of the Jacobi scaling, with any stored format.  The other
     registered methods lower through the same plans: ``cg`` on the fused
     substrate with no preconditioner; ``pcg_pipelined``/``_tol`` with
     the format's matvec (``ell_spmv`` a step on ELL) and the engine's
     preconditioner (two ``sptrsv_solve_dot`` a step under block_ic0),
     the pipelined update and its stacked reduction in plain PyTorch; the
     ``jacobi`` smoother in plain PyTorch over the reference matvec.
     Each plan owns a ``loop.ProgramCell``: on the card its first call
     captures the solver's loop as one CUDA graph, and every later call
     replays it (``plan.traces`` counts the builds).

``SolveSpec(injectable=True)`` lowers a plan that reads the packed ELL
values from a buffer of its own (``plan.vals``) and copies each call's
``vals`` operand into it (``SolvePlan.__call__``): the fault-injection
surface of ``repro_torch.ft``.  ``vals_template`` / ``cols_template``
give the host layout of that operand; the engine's own values, which
``spmv`` reads, stay clean.

``reorder="rcm"`` packs the reverse Cuthill-McKee permuted matrix (ELL,
the format containers, the IC(0) factors and ``device_bytes`` all see it)
and permutes every vector on the way in and back on the way out
(``to_device_vec`` / ``from_device_vec``), so callers speak the original
ordering.

The tile grid (``mesh=make_mesh((pr, pc), ("data", "model"))``, a
``launch.mesh.TileMesh``): Azul's tiles, every one of them on the mesh's
one device.  ``mode="2d"`` partitions A into (pr x pc) blocks, tile (i, j)
owning block A[I=i, J=j] (``partition.plan_2d``, nnz-balanced row blocks
with ``balance="nnz"``); ``mode="1d"`` into P row blocks.  Vectors are the
padded global vector in the JAX package's L_row order: tile (i, j) holds
segment ``q = i*pc + j`` of length u, so ``x.view(..., P, u)`` is the
tile stack.  SpMV runs the JAX package's per-tile program over every tile
at once: the NoC gathers x into a (P, m) tile-stacked buffer
(``core.noc``: 2d dense = mesh transpose + all-gather along the rows, m =
bc; 1d dense = all-gather, m = n_pad; ``layout="halo"`` the compiled pull
schedule of ``core.commplan``, m = (1+H) u), one ``ell_spmv`` launch (or
``ell_spmm`` for a (k, n) batch) applies every tile's block to its own
buffer -- the stacked (P*rows_p, w) blocks with columns offset by t*m --
and 2d reduce-scatters the partials along the columns.  Dots are tile
partials added in tile order (the psum); the shard substrates run
``cg_update`` over the whole stack.  Block-IC(0) factors every tile's
diagonal block (the JAX package's per-tile block-Jacobi IC(0)); the
tiles' blocks form one block-diagonal triangular matrix, so each
triangular solve is one ``sptrsv_solve_dot`` over the merged level
schedule.  On a halo layout the pipelined methods split the matvec into
interior and frontier passes (``matvec_start`` / ``matvec_finish``).
``build_sptrsv`` compiles the block-staged distributed lower solve.

The same engine runs one tile a process on a process grid
(``mesh=rank.mesh(...)``, a ``launch.mesh.ProcessMesh``; ``launch.procs``
spawns the ranks).  Every rank runs the same deterministic host build --
the partition, the comm plan, the factors -- and uploads only its own
tile's ELL block, Jacobi diagonal and block-IC(0) factors; its vectors
are its (u,) / (k, u) shard of the padded global vector, its tile stack
(1, u).  The NoC calls become messages between the ranks (``core.noc``),
the dots gather the ranks' partials and add them in tile order, and the
shard substrates add the ranks' [rr, rz] in rank order.  ``plan(b)``
takes the same global ``b`` on every rank and returns the same global
``x`` and info on every rank (one all_gather of the shards at the end).
Its loop runs eagerly (``loop.ProgramCell(capture=False)``,
``info["loop"] == "eager"``): the host-side collectives cannot sit in a
CUDA graph.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import commplan, noc, registry
from ..device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..kernels.autotune import choose_format, modeled_format_words
from ..obs import REGISTRY as _OBS
from .formats import (CSR, ELL, bcsr_from_csr, ell_arrays_from_csr,
                      hyb_from_csr, pad_to, sell_from_csr)
from .levels import build_schedule
from .loop import ProgramCell
from .partition import (padded_layout_1d, permute_csr, plan_1d, plan_2d,
                        rcm_permutation, tile_csr)
from .plan import (PlanCache, SolvePlan, SolveSpec, canonicalize,
                   warn_deprecated)
from .precond import ic0, make_fused_ic0_apply
from .solvers import ensure_status
from .spops import spmm_ell_padded, spmv_ell_padded
from .stencil import Stencil, stencil_diag, stencil_matvec
from .substrate import (format_stream_ops, fused_ic0_local_substrate,
                        fused_local_substrate, fused_shard_ic0_substrate,
                        fused_shard_substrate)

_FORMAT_KNOBS = ("auto", "ell", "sell", "hyb", "bcsr", "stencil")

__all__ = ["AzulEngine"]


def _host_diag(m: CSR, r0: int, r1: int) -> np.ndarray:
    """Diagonal entries of rows [r0, r1) (0.0 where absent), host side,
    by one vectorised compare over the rows' nnz slice."""
    indptr = np.asarray(m.indptr)
    lo, hi = int(indptr[r0]), int(indptr[r1])
    rows = np.repeat(np.arange(r0, r1), np.diff(indptr[r0 : r1 + 1]))
    idx = np.asarray(m.indices)[lo:hi]
    sel = idx == rows
    d = np.zeros(r1 - r0, dtype=np.float64)
    d[rows[sel] - r0] = np.asarray(m.data)[lo:hi][sel]
    return d


def _matvec(cols, vals, x: torch.Tensor) -> torch.Tensor:
    """The plain padded-ELL matvec for (n_pad,) or (k, n_pad) vectors."""
    if x.dim() == 2:
        return spmm_ell_padded(cols, vals, x)
    return spmv_ell_padded(cols, vals, x)


def _csr_fingerprint(m: CSR) -> tuple:
    """Content key of a host CSR matrix (``id()`` keys could hit a stale
    entry once CPython reuses an address)."""
    h = hashlib.sha1()
    for a in (m.indptr, m.indices, m.data):
        h.update(np.ascontiguousarray(a).tobytes())
    return (tuple(m.shape), h.hexdigest())


_INT32_MAX = 2 ** 31 - 1


def _block_apply(cols: torch.Tensor, vals: torch.Tensor,
                 xbuf: torch.Tensor) -> torch.Tensor:
    """Every tile's ELL block against its own x buffer in one launch:
    ``cols``/``vals`` (P*rows_p, w) with tile t's columns offset by t*m,
    ``xbuf`` the (..., P, m) tile-stacked buffer.  Returns the
    (..., P*rows_p) partials: ``ell_spmv`` for (P, m), ``ell_spmm`` for a
    (k, P, m) batch (its plain versions on the CPU)."""
    from ..kernels import ops

    x = xbuf.reshape(xbuf.shape[:-2] + (-1,))
    if x.dim() == 2:
        return ops.ell_spmm(cols, vals, x)
    return ops.ell_spmv(cols, vals, x)


def _offset_cols(cols: np.ndarray, m: int) -> np.ndarray:
    """(P, rows_p, w) tile-local columns -> (P*rows_p, w) int32 columns
    into the flat (P*m) tile-stacked buffer (tile t's offset t*m)."""
    p = cols.shape[0]
    if p * m > _INT32_MAX:
        raise ValueError(
            f"the tile-stacked x buffer holds {p} x {m} = {p * m} words, past "
            "the int32 column range of the ELL kernels")
    off = (np.arange(p, dtype=np.int64) * m)[:, None, None]
    return (cols.astype(np.int64) + off).reshape(-1, cols.shape[2]) \
        .astype(np.int32)


class _BlockIC0:
    """The tile grid's block-IC(0) application: each tile's two
    triangular solves with its own diagonal block's factors (the JAX
    package's ``local_sptrsv`` pair per tile, its ``flip_k`` between).
    The tiles' blocks form one block-diagonal triangular matrix -- tile t's
    rows at offset t*rows_p, its level l merged into level l of the whole
    -- so each solve is one ``sptrsv_solve_dot`` over every tile (the
    kernel on the card, its plain version on the CPU), row by row the same
    arithmetic as the per-tile scans.

    ``l_pack``/``u_pack``: the stacked (cols, vals, dinv, rows) factor
    planes of ``_prep_precond_blocks``; ``ks``: each tile's block size."""

    def __init__(self, rows_p, l_pack, u_pack, ks, u: int, device, dtype):
        from ..kernels import ops

        p = len(ks)
        self.p, self.rows_p, self.u = p, rows_p, u
        n_all = p * rows_p
        self.n_all = n_all
        self.dtype = dtype
        self.factors = []
        for cols, vals, dinv, rows in (l_pack, u_pack):
            t = np.arange(p)[:, None, None]
            sched = np.where(rows < rows_p, rows + t * rows_p, n_all)
            sched = sched.transpose(1, 0, 2).reshape(rows.shape[1], -1)
            c = torch.tensor(_offset_cols(cols, rows_p), device=device)
            v = torch.tensor(vals.reshape(n_all, -1), device=device)
            d = torch.tensor(dinv.reshape(-1), device=device)
            sr = torch.tensor(sched.astype(np.int32), device=device)
            self.factors.append((c, v, d, sr,
                                 ops.sptrsv_solve_pack(c, sr, n_all)))
        # flip_k as one gather into the solution with a zero slot appended:
        # tile t's entry i < k_t reads entry k_t - 1 - i, the rest read 0
        i = np.arange(rows_p)[None, :]
        k = np.asarray(ks, np.int64)[:, None]
        src = np.where(i < k, np.arange(p)[:, None] * rows_p + k - 1 - i,
                       n_all)
        self.flip = torch.tensor(src.reshape(-1), device=device)

    def _solve(self, which: int, b: torch.Tensor) -> torch.Tensor:
        from ..kernels import ops

        c, v, d, sr, pack = self.factors[which]
        x, _ = ops.sptrsv_solve_dot(c, v, d, b, sr, None, n_rows=self.n_all,
                                    pack=pack)
        return x

    def _flip_k(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros(1)]).index_select(0, self.flip)

    def apply1(self, r: torch.Tensor) -> torch.Tensor:
        """z = M^-1 r for one padded global (n_pad,) vector."""
        p, rp, u = self.p, self.rows_p, self.u
        w = min(u, rp)
        bb = r.new_zeros(p, rp)
        bb[:, :w] = r.view(p, u)[:, :w]
        zp = self._solve(0, bb.view(-1))
        z = self._flip_k(self._solve(1, self._flip_k(zp))).view(p, rp)
        out = r.new_zeros(p, u)
        out[:, :w] = z[:, :w]
        return out.view(-1)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if r.dim() == 2:
            return torch.stack([self.apply1(v) for v in r])
        return self.apply1(r)


class AzulEngine:
    """Sparse iterative-solver engine (module docstring).

    Parameters
    ----------
    a : CSR | Stencil       square sparse matrix (host side), or a
                            matrix-free stencil operator
    mesh : TileMesh | ProcessMesh | None  None: one device, no NoC.  A
                            ``launch.mesh.make_mesh`` grid: the tile grid
                            on the mesh's device; a ``ProcessMesh``: this
                            rank's tile of a process grid (module
                            docstring)
    mode : "2d" | "1d"      tile-grid partition (2d = Azul's NoC pattern)
    row_axes / col_axes :   mesh axis names of the grid's rows and columns
                            (default ("data",) x ("model",); a multipod
                            grid passes row_axes=("pod", "data")); together
                            they name every mesh axis, in the mesh's order
    precond : "jacobi" | "block_ic0" | "none"  (a stencil takes "jacobi"
                            or "none": block_ic0 needs stored nonzeros)
    balance : "nnz" | "rows"  tile-grid row-block split (prefix-sum nnz
                            or equal rows)
    dtype : float32 | float64 (numpy or torch spelling); default float32
    row_pad / width_pad :   ELL padding multiples (8, as the JAX engine);
                            row_pad is also the SELL slice height and the
                            BCSR block size
    fused : "auto" | True | False
        Fused-kernel substrate wherever the method/preconditioner pair
        supports it ("auto"/True); False runs the reference substrate --
        plain PyTorch, one op per solver line -- on the same device.
        For block_ic0, "auto" takes the fused IC(0) substrate on a CUDA
        device only, where its kernel launches (True forces it).
    layout : "auto" | "halo" | "dense"
        Tile-grid communication layout: "auto" runs the compiled halo
        pull schedule wherever it moves fewer bytes than the dense
        collectives; a local engine lowers "dense" and rejects "halo".
    reorder : "none" | "rcm"
        Bandwidth-reducing row/column reordering applied at build (module
        docstring); vectors round-trip it transparently.
    format : "auto" | "ell" | "sell" | "hyb" | "bcsr" | "stencil"
        Operator storage format.  "auto" runs the per-matrix format rule
        (``kernels.autotune.choose_format``): uniform rows stay on padded
        ELL, skewed rows take SELL or HYB.  Explicit names pin the format;
        "bcsr" is explicit only.  A ``Stencil`` operator is "stencil".
        Per-plan override via ``SolveSpec(format=...)``.  The padded ELL
        always builds for a stored matrix (it backs ``spmv`` and IC(0)).
        A tile grid streams padded ELL blocks ("auto" or "ell").
    device : "cuda" (default) | "cpu"; a tile grid runs on its mesh's
        device (a ``device`` naming another raises)
    """

    def __init__(self, a: CSR | Stencil, mesh=None, mode: str = "2d",
                 row_axes=("data",), col_axes=("model",),
                 precond: str = "jacobi", balance: str = "nnz",
                 dtype=np.float32, row_pad: int = 8, width_pad: int = 8,
                 fused="auto", layout: str = "auto", reorder: str = "none",
                 format: str = "auto", device=DEFAULT_DEVICE):
        if mesh is not None:
            from ..launch.mesh import ProcessMesh, TileMesh

            if not isinstance(mesh, (TileMesh, ProcessMesh)):
                raise TypeError(
                    "mesh must be a repro_torch.launch.mesh.TileMesh "
                    "(make_mesh) or ProcessMesh (make_process_mesh), got "
                    f"{type(mesh).__name__}")
            if (device != DEFAULT_DEVICE
                    and torch.device(device) != mesh.device):
                raise ValueError(f"device {device!r} differs from the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        if a.shape[0] != a.shape[1]:
            raise ValueError("engine expects a square matrix")
        if layout not in ("auto", "halo", "dense"):
            raise ValueError(
                f"layout must be 'auto', 'halo' or 'dense', got {layout!r}")
        if reorder not in ("none", "rcm"):
            raise ValueError(f"reorder must be 'none' or 'rcm', got {reorder!r}")
        if layout == "halo" and mesh is None:
            raise ValueError("layout='halo' needs a mesh (no NoC locally)")
        if format not in _FORMAT_KNOBS:
            raise ValueError(
                "format must be 'auto', 'ell', 'sell', 'hyb', 'bcsr' or "
                f"'stencil', got {format!r}")
        self._configure(precond, fused, dtype, device)
        self.layout = layout
        is_stencil = isinstance(a, Stencil)
        if is_stencil:
            if mesh is not None:
                raise ValueError(
                    "matrix-free stencil operators are local-only (the "
                    "distributed partition shards stored nonzeros)")
            if reorder != "none":
                raise ValueError(
                    "reorder needs a stored matrix; stencil operators have "
                    "a fixed grid ordering")
            if registry.get_precond(precond).factorized:
                raise ValueError(
                    f"precond {precond!r} needs stored nonzeros to factor; "
                    "stencil engines support 'jacobi' or 'identity'")
            if format not in ("auto", "stencil"):
                raise ValueError(
                    f"format={format!r} conflicts with a matrix-free "
                    "stencil operator")
        elif format == "stencil":
            raise ValueError("format='stencil' needs a Stencil operator")
        if mesh is not None and format not in ("auto", "ell"):
            raise ValueError(
                f"format={format!r} is not supported in distributed mode "
                "(sharding and halo remap are phrased over padded ELL)")
        self.reorder = reorder
        if reorder == "rcm":
            self._row_perm = rcm_permutation(a)
            self._row_iperm = np.empty_like(self._row_perm)
            self._row_iperm[self._row_perm] = np.arange(a.shape[0])
            a = permute_csr(a, self._row_perm)
        self.a = a                     # the working (reordered) matrix
        self.stencil = a if is_stencil else None
        self.format = format
        self._row_pad = row_pad
        self._width_pad = width_pad
        n = a.shape[0]
        if mesh is not None:
            self.n = n
            self._build_dist(mesh, mode, row_axes, col_axes, balance)
            return
        if is_stencil:
            # matrix-free: no stored nonzeros, no ELL; device state is the
            # padded inverse diagonal (the stencil's diagonal is constant)
            self.format_choice, self.format_words = "stencil", None
            di = np.zeros(pad_to(max(n, 1), row_pad), self.dtype)
            di[:n] = 1.0 / stencil_diag(a)
            self._set_operator(None, None, di, n)
            return
        if format == "auto":
            choice, words = choose_format(a, dtype=self.dtype,
                                          slice_height=row_pad,
                                          row_pad=row_pad)
        else:
            choice = format
            words = modeled_format_words(a, slice_height=row_pad,
                                         row_pad=row_pad)
        self.format_choice, self.format_words = choice, words
        cols, vals = ell_arrays_from_csr(a, row_pad=row_pad,
                                         width_pad=width_pad, dtype=self.dtype)
        dg = _host_diag(a, 0, n)
        dg[dg == 0] = 1.0
        di = np.zeros(cols.shape[0], self.dtype)
        di[:n] = 1.0 / dg
        self._set_operator(cols, vals, di, n)
        if precond == "block_ic0":
            self._set_ic0(ic0(a, dtype=self.dtype, device=self.device))

    @classmethod
    def from_state(cls, cols: np.ndarray, vals: np.ndarray, dinv: np.ndarray,
                   n: int, precond: str = "jacobi", fused="auto",
                   device=DEFAULT_DEVICE, ic0_factors=None,
                   fmt_objs: dict | None = None) -> "AzulEngine":
        """An engine over an already packed operator: (n_pad, w) ELL
        ``cols``/``vals`` and the (n_pad,) inverse diagonal, as host
        arrays, and for ``precond="block_ic0"`` its ``IC0Factors`` on the
        engine's device (see ``repro_torch.convert``).  ``fmt_objs`` maps
        "sell" / "hyb" / "bcsr" to containers of the same operator on the
        engine's device, for plans with ``SolveSpec(format=...)``; the
        engine has no host matrix to pack others from."""
        eng = cls.__new__(cls)
        eng._configure(precond, fused, vals.dtype, device)
        eng.layout, eng.reorder = "auto", "none"
        eng.format, eng.format_choice, eng.format_words = "ell", "ell", None
        eng.a = eng.stencil = None
        eng._set_operator(cols, vals, dinv, n)
        for fmt, obj in (fmt_objs or {}).items():
            if fmt not in ("sell", "hyb", "bcsr"):
                raise ValueError(f"no format container for {fmt!r}")
            eng._fmt_objs[fmt] = obj
        if (ic0_factors is not None) != (precond == "block_ic0"):
            raise ValueError("ic0_factors go with precond='block_ic0', and "
                             "only with it")
        if ic0_factors is not None:
            eng._set_ic0(ic0_factors)
        return eng

    @classmethod
    def from_dist_state(cls, mesh, state: dict, precond: str = "jacobi",
                        fused="auto", layout: str = "auto") -> "AzulEngine":
        """A tile-grid engine over an already partitioned operator on
        ``mesh`` (a ``TileMesh``, or a ``ProcessMesh``, whose rank takes
        its own tile of every array): ``state`` holds the host arrays of a
        distributed engine -- ``mode``, ``row_axes``/``col_axes``, ``n``,
        ``n_pad``, ``u``, ``br``, ``bc``, the stacked ``cols``/``vals``,
        ``dinv``, ``pad2g`` (or None), the comm plan's fields under
        ``comm_plan`` and, for ``precond="block_ic0"``, the per-tile
        factor planes under ``block_ic0`` (see
        ``repro_torch.convert.dist_engine_state_to_numpy``).  The engine
        has no host matrix: ``build_sptrsv`` needs one and raises."""
        eng = cls.__new__(cls)
        vals = np.asarray(state["vals"])
        eng._configure(precond, fused, vals.dtype, mesh.device)
        eng.layout, eng.reorder, eng.format = layout, "none", "ell"
        eng.a = eng.stencil = None
        eng._row_pad = eng._width_pad = 8
        eng.n = int(state["n"])
        eng._build_dist(mesh, state["mode"], tuple(state["row_axes"]),
                        tuple(state["col_axes"]), None, build=False)
        eng.n_pad, eng.u = int(state["n_pad"]), int(state["u"])
        eng.br, eng.bc = int(state["br"]), int(state["bc"])
        if eng.tiles * eng.u != eng.n_pad or vals.shape[:2] != (eng.tiles,
                                                                eng.br):
            raise ValueError(f"state of {vals.shape[0]} tiles x {vals.shape[1]}"
                             f" rows does not fit the {eng.tiles}-tile mesh "
                             f"(n_pad {eng.n_pad}, u {eng.u}, br {eng.br})")
        pad2g = state.get("pad2g")
        eng._pad2g = None if pad2g is None else np.asarray(pad2g, np.int64)
        cp = dict(state["comm_plan"])
        cp["deltas"] = tuple(int(d) for d in cp["deltas"])
        eng.comm_plan = commplan.CommPlan(**cp)
        eng.partition_plan = None
        eng._set_blocks(np.asarray(state["cols"]), vals)
        eng._dinv_pad = torch.tensor(
            np.asarray(state["dinv"], vals.dtype)[eng._shard()],
            device=eng.device)
        blk = state.get("block_ic0")
        if (blk is not None) != (precond == "block_ic0"):
            raise ValueError("block_ic0 planes go with precond='block_ic0', "
                             "and only with it")
        if blk is not None:
            eng._set_block_ic0(int(blk["rows_p"]),
                               tuple(np.asarray(blk[f"l_{k}"])
                                     for k in ("cols", "vals", "dinv",
                                               "rows")),
                               tuple(np.asarray(blk[f"u_{k}"])
                                     for k in ("cols", "vals", "dinv",
                                               "rows")),
                               np.asarray(blk["ks"]))
        return eng

    def _configure(self, precond, fused, dtype, device) -> None:
        if fused not in ("auto", True, False):
            raise ValueError(f"fused must be 'auto', True or False, got {fused!r}")
        registry.get_precond(precond)      # fail fast on unknown names
        self.precond = precond
        self.fused = fused
        self.dtype, self.torch_dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.mode = "local"
        self.mesh = None
        self.comm_plan = None
        self._pad2g = None
        self._row_perm = self._row_iperm = None
        self.plans = PlanCache()
        self.last_solve_info: dict = {}
        self._fmt_objs: dict = {}

    def _set_operator(self, cols, vals, dinv, n: int) -> None:
        """Pin the padded ELL (None for a stencil) and the inverse
        diagonal; torch.tensor copies, so the engine never aliases a
        caller's array."""
        dev, dt = self.device, self.torch_dtype
        self.ell = None
        if cols is not None:
            self.ell = ELL(torch.tensor(cols, dtype=torch.int32, device=dev),
                           torch.tensor(vals, dtype=dt, device=dev), n, n)
        self.n = n
        self.n_pad = len(dinv)
        self._dinv_pad = torch.tensor(dinv, dtype=dt, device=dev)
        self._ic0 = self._ic0_apply = None

    def _set_ic0(self, factors) -> None:
        """Pin the IC(0) factors and, once, the fused application's inverse
        diagonals and level lists."""
        self._ic0 = factors
        self._ic0_apply = make_fused_ic0_apply(factors, self.n, self.n_pad,
                                               self.torch_dtype)

    def _format_obj(self, fmt: str):
        """The device container of a non-ELL stored format, built on first
        use and cached: plans that stay on ELL never pay the second
        packing."""
        obj = self._fmt_objs.get(fmt)
        if obj is not None:
            return obj
        if not isinstance(self.a, CSR):
            raise ValueError(f"format {fmt!r}: this engine has no host matrix "
                             "to pack (pass the container to from_state)")
        rp, dt, dev = self._row_pad, self.dtype, self.device
        if fmt == "sell":
            obj = sell_from_csr(self.a, slice_height=rp, row_pad=rp, dtype=dt,
                                device=dev)
            assert obj.rows_padded == self.n_pad
        elif fmt == "hyb":
            obj = hyb_from_csr(self.a, row_pad=rp, dtype=dt, device=dev)
            assert obj.rows_padded == self.n_pad
        elif fmt == "bcsr":
            obj = bcsr_from_csr(self.a, bm=rp, bn=rp, dtype=dt, device=dev)
        else:
            raise ValueError(f"no format container for {fmt!r}")
        self._fmt_objs[fmt] = obj
        return obj

    # -- vector embedding ---------------------------------------------------

    def _shard(self) -> slice:
        """The slice of a padded global vector this process holds: all of
        it, but a process grid's rank its own tile's u-shard."""
        mesh = self.mesh
        if mesh is None or not mesh.per_process:
            return slice(None)
        return slice(mesh.local.start * self.u, mesh.local.stop * self.u)

    def to_device_vec(self, v: np.ndarray) -> torch.Tensor:
        """Embed a global (n,) vector, or a (k, n) batch, into the padded
        (n_pad,) / (k, n_pad) device layout (zeros past n; on an
        nnz-balanced or 1d tile grid through ``pad2g``).  With
        ``reorder`` active the engine's row permutation applies here (and
        inverts in :meth:`from_device_vec`), so callers always speak the
        original ordering.  A process grid's rank keeps its own shard."""
        v = np.asarray(v)
        if self._row_perm is not None:
            v = v[..., self._row_perm]
        out = np.zeros(v.shape[:-1] + (self.n_pad,), self.dtype)
        if self._pad2g is not None:
            valid = self._pad2g < self.n
            out[..., valid] = v[..., self._pad2g[valid]]
        else:
            out[..., : self.n] = v
        out = np.ascontiguousarray(out[..., self._shard()])
        return torch.from_numpy(out).to(self.device)

    def from_device_vec(self, v: torch.Tensor) -> np.ndarray:
        """Extract the global (n,) / (k, n) vectors from the padded
        layout (waits for the device: the copy to the host).  A process
        grid's ranks gather their shards first (a collective: every rank
        calls it)."""
        if self.mesh is not None and self.mesh.per_process:
            g = self.mesh.gather(v.unsqueeze(-2), self.mesh.axis_names,
                                 "from_device_vec")
            v = g.reshape(v.shape[:-1] + (self.n_pad,))
        if self._pad2g is not None:
            vh = v.cpu().numpy()
            out = np.zeros(vh.shape[:-1] + (self.n,), vh.dtype)
            valid = self._pad2g < self.n
            out[..., self._pad2g[valid]] = vh[..., valid]
        else:
            out = v[..., : self.n].cpu().numpy()
        if self._row_iperm is not None:
            out = out[..., self._row_iperm]
        return out

    # -- fault-injection surface --------------------------------------------

    def _value_buffer(self) -> torch.Tensor:
        """The engine's packed value buffer on its device: the (n_pad, w)
        ELL locally, the (tiles, rows_p, w) stacked blocks on a grid."""
        return self.ell.vals if self.mode == "local" else self.vals

    def vals_template(self) -> np.ndarray:
        """Host copy of the packed value buffer in the layout the plans
        read -- (n_pad, w) local ELL or (tiles, rows_p, w) stacked tile
        blocks -- the layout an injectable plan's ``vals`` operand takes.
        Corrupt a copy (see ``repro_torch.ft.inject``) and pass it:
        ``plan(b, vals=bad)``."""
        if self.stencil is not None:
            raise ValueError("matrix-free stencil engines store no values "
                             "(coefficients are generated in-kernel)")
        return self._value_buffer().cpu().numpy().copy()

    def cols_template(self) -> np.ndarray:
        """Host copy of the packed ELL column indices matching
        :meth:`vals_template` (padded-global ids locally and in 1d mode,
        ids local to the column block in 2d mode)."""
        if self.stencil is not None:
            raise ValueError("matrix-free stencil engines store no columns "
                             "(structure is implicit in the grid)")
        if self.mode == "local":
            return self.ell.cols.cpu().numpy().copy()
        return self._cols_host.copy()

    def halo_entry_mask(self) -> np.ndarray:
        """Boolean mask over :meth:`vals_template` marking the stored
        entries whose contribution depends on REMOTE vector shards -- the
        words a dropped or corrupted halo exchange poisons.  1d mode
        classifies each entry (its column outside the tile's own
        u-shard); 2d mode takes the comm plan's frontier rows (every
        stored entry of a row that references a remote shard).  A local
        engine has no exchange, so this raises, as in the JAX package."""
        if self.mode == "local":
            raise ValueError("halo faults need a distributed engine "
                             "(single-device engines have no exchange)")
        return self._halo_mask(self.mesh.local)

    def grid_vals_template(self) -> np.ndarray:
        """:meth:`vals_template` over every tile of the grid, (tiles,
        rows_p, w), whichever tiles this process holds (on a process grid
        a rank holds one; the host build that every rank runs keeps them
        all): the layout ``ft.FaultInjector`` draws its entries over, so a
        rank corrupts its share of the one-process grid's draws.  A local
        engine's and a ``TileMesh`` grid's is :meth:`vals_template`."""
        if self.mode == "local" or not self.mesh.per_process:
            return self.vals_template()
        return np.array(self._host_blocks[1], copy=True)

    def grid_halo_entry_mask(self) -> np.ndarray:
        """:meth:`halo_entry_mask` over every tile of the grid, the mask
        of :meth:`grid_vals_template`."""
        if self.mode == "local":
            return self.halo_entry_mask()
        return self._halo_mask(slice(None))

    def _halo_mask(self, tiles: slice) -> np.ndarray:
        """:meth:`halo_entry_mask` of the grid's tiles ``tiles``, from the
        host blocks."""
        cols, vals = (a[tiles] for a in self._host_blocks)
        if self.mode == "1d":
            ids = np.arange(self.tiles)[tiles][:, None, None]
            return ((cols // self.u) != ids) & (vals != 0)
        imask = (self.comm_plan.interior_mask
                 if self.comm_plan is not None else None)
        if imask is None:
            return vals != 0
        return (~imask[tiles][:, :, None]) & (vals != 0)

    def _host_vals(self, vals) -> np.ndarray:
        """A caller's value buffer as a contiguous host array of the
        engine's dtype, shape-checked against the packed layout."""
        vals = np.ascontiguousarray(vals, dtype=self.dtype)
        want = tuple(self._value_buffer().shape)
        if vals.shape != want:
            raise ValueError(
                f"vals must match the packed value-buffer shape {want}, "
                f"got {vals.shape}")
        return vals

    def vals_operand(self, vals=None) -> torch.Tensor:
        """The value buffer for an injectable plan on the engine's device:
        the engine's clean resident one when None, else the caller's host
        buffer uploaded (shape-checked against the packed layout).  A plan
        copies the operand into its own buffer, the one its program (and
        its captured graph) reads (``SolvePlan.__call__``)."""
        if self.stencil is not None:
            raise ValueError("matrix-free stencil engines store no values "
                             "(no injectable surface)")
        if vals is None:
            return self._value_buffer()
        return torch.from_numpy(self._host_vals(vals)).to(self.device)

    # -- public ops ---------------------------------------------------------

    def spmv(self, x) -> np.ndarray:
        """y = A @ x on a global (n,) vector, or a (k, n) batch through the
        multi-RHS matvec (plain PyTorch, one matrix gather for all k; the
        shifted adds for a stencil).  On a tile grid: the NoC matvec of
        the engine's layout (``_op_layout``), the tiles' blocks in one
        ``ell_spmv``/``ell_spmm`` launch (module docstring)."""
        xd = self.to_device_vec(np.asarray(x))
        if self.mode != "local":
            mv = self._matvec_of(self._op_layout())
            return self.from_device_vec(mv(xd, self._flat_vals(self.vals)))
        if self.stencil is not None:
            return self.from_device_vec(stencil_matvec(self.stencil, xd,
                                                       self.n_pad))
        return self.from_device_vec(_matvec(self.ell.cols, self.ell.vals, xd))

    def solve(self, b, method: str = "pcg", iters: int = 200, x0=None,
              fused=None, tol: float = 1e-8, max_iters: int | None = None):
        """DEPRECATED: build a :class:`SolveSpec` and use :meth:`plan`.

        Thin shim kept for compatibility with the JAX package's surface: it
        builds the equivalent spec, hits the plan cache and executes -- bit
        for bit the plan's result (``b`` may be (n,) or stacked (k, n)).
        Emits one DeprecationWarning per process."""
        warn_deprecated(
            "AzulEngine.solve",
            "AzulEngine.solve(**knobs) is deprecated: build a SolveSpec "
            "and use AzulEngine.plan(spec) (see README 'The plan/execute "
            "API').",
        )
        b = np.asarray(b)
        spec = SolveSpec(
            method=method, iters=iters, tol=tol, max_iters=max_iters,
            batch=b.shape[0] if b.ndim == 2 else None,
            fused="auto" if fused is None else fused,
        )
        return self.plan(spec)(b, x0=x0)

    def device_bytes(self) -> int:
        """Device-resident operator footprint: ELL cols/vals (none for a
        stencil), the inverse diagonal, the SELL/HYB/BCSR containers built
        so far (their row-reduction plans included) and, for block-IC(0),
        both factors with their schedules and the fused application's
        inverse diagonals and solve packs (level lists, level grids,
        dependency codes).  The plans' captured graphs and their memory
        pools are not counted (the JAX package counts no compiled
        program either).  A tile grid counts its stacked ELL cols/vals and
        inverse diagonal, as the JAX package's does (the kernel's offset
        column copies, the halo columns, the split values and the
        block-IC(0) planes are not counted there either)."""
        if self.mode != "local":
            return sum(t.numel() * t.element_size()
                       for t in (self.cols, self.vals, self._dinv_pad))
        tensors = [self._dinv_pad]
        if self.ell is not None:
            tensors += [self.ell.cols, self.ell.vals]
        for obj in self._fmt_objs.values():
            for field in obj:
                if isinstance(field, torch.Tensor):
                    tensors.append(field)
                elif isinstance(field, tuple):      # row_groups
                    tensors += [t for pair in field for t in pair]
        if self._ic0 is not None:
            f = self._ic0
            tensors += [f.ell_l.cols, f.ell_l.vals, f.sched_l.rows,
                        f.ell_u_rev.cols, f.ell_u_rev.vals, f.sched_u_rev.rows,
                        *self._ic0_apply.resident]
        return sum(t.numel() * t.element_size() for t in tensors)

    def substrate_kind(self, method: str = "pcg", fused=None) -> str:
        """The substrate a plan for ``method`` runs on: "reference",
        "fused", "fused_ic0", "fused_shard" or "fused_shard_ic0"."""
        sdef = registry.get_solver(method)
        pdef = registry.get_precond(self.precond)
        knob = self.fused if fused is None else fused
        local = self.mode == "local"
        use = registry.resolve_fused(sdef, pdef, knob, self.device,
                                     local=local)
        return registry.substrate_kind(sdef, pdef, use, local=local)

    # -- the tile grid: construction ----------------------------------------

    def _build_dist(self, mesh, mode, row_axes, col_axes, balance,
                    build: bool = True) -> None:
        self.mesh = mesh
        if mode not in ("2d", "1d"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.row_axes = mesh.axes(row_axes)
        self.col_axes = mesh.axes(col_axes)
        self._all_axes = self.row_axes + self.col_axes
        if self._all_axes != mesh.axis_names:
            raise ValueError(
                f"row_axes + col_axes {self._all_axes} must name every mesh "
                f"axis, in the mesh's order {mesh.axis_names} (the vectors "
                "shard over all of them)")
        self.pr = int(np.prod([mesh.shape[ax] for ax in self.row_axes]))
        self.pc = int(np.prod([mesh.shape[ax] for ax in self.col_axes]))
        self.tiles = self.pr * self.pc
        self.format_choice, self.format_words = "ell", None
        self.ell = None
        self._ic0 = self._ic0_apply = None
        self._pc_blocks = None           # host block-IC(0) planes
        self._block_ic0 = None           # their merged device application
        self._flat_cols: dict = {}       # layout -> offset kernel columns
        self._matvecs: dict = {}         # layout -> matvec closure
        self._vals_split_dev = None      # interior/frontier value blocks
        self._imask_dev = None           # interior-row mask
        self._trsv_cache: dict = {}
        if not build:
            return
        if mode == "2d":
            self._build_2d(balance)
        else:
            self._build_1d(balance)

    def _build_2d(self, balance) -> None:
        plan = plan_2d(self.a, self.pr, self.pc, width_pad=self._width_pad,
                       row_pad=self._row_pad, dtype=self.dtype,
                       balance=balance)
        self.partition_plan = plan       # the static task-compiler output
        self.n_pad = plan.n_padded
        self.br = plan.block_rows
        self.bc = plan.block_cols
        self.u = self.n_pad // self.tiles
        self._pad2g = plan.pad2g         # None for uniform row blocks
        # the static pull schedule: which remote u-shards each tile's
        # stored structure references (core.commplan)
        self.comm_plan = commplan.compile_comm_plan_2d(
            plan.cols, plan.vals, self.pr, self.pc, self.u,
            itemsize=np.dtype(self.dtype).itemsize)
        self._set_blocks(plan.cols, plan.vals)
        if plan.pad2g is None:
            segs = [(min(q * self.u, self.n), min((q + 1) * self.u, self.n))
                    for q in range(self.tiles)]
        else:
            # tile (i, j)'s u-shard sits inside row block i at local
            # offset j*u; valid rows clip at the block's true extent
            offs = plan.row_offsets
            segs = []
            for i in range(self.pr):
                for j in range(self.pc):
                    r0 = min(int(offs[i]) + j * self.u, int(offs[i + 1]))
                    r1 = min(int(offs[i]) + (j + 1) * self.u,
                             int(offs[i + 1]))
                    segs.append((r0, r1))
        self._setup_diag_and_precond(segs, plan.pad2g)

    def _build_1d(self, balance) -> None:
        parts = self.tiles
        plan = plan_1d(self.a, parts, balance=balance,
                       width_pad=self._width_pad, row_pad=self._row_pad,
                       dtype=self.dtype)
        self.partition_plan = plan
        self.n_pad = plan.n_padded
        self.u = self.br = plan.rows_per_tile
        # global cols -> padded tile layout (tile t, local r) = t*u + r
        offs = plan.row_offsets
        cols_pad, pad2g = padded_layout_1d(plan)
        self._pad2g = pad2g
        self.comm_plan = commplan.compile_comm_plan_1d(
            cols_pad, plan.vals, self.u, parts,
            itemsize=np.dtype(self.dtype).itemsize)
        self._set_blocks(cols_pad, plan.vals)
        segs = [(int(offs[t]), int(offs[t + 1])) for t in range(parts)]
        self._setup_diag_and_precond(segs, pad2g)

    def _set_blocks(self, cols: np.ndarray, vals: np.ndarray) -> None:
        """Pin the stacked (tiles, rows_p, w) blocks of this process's
        tiles (all of them, or a rank's own) on the device; the host
        blocks of every tile stay (the layouts' offset kernel columns, the
        halo masks, :meth:`grid_vals_template`)."""
        loc = self.mesh.local
        self._host_blocks = (np.asarray(cols), np.asarray(vals, self.dtype))
        self._cols_host = np.ascontiguousarray(cols[loc], np.int32)
        self.cols = torch.tensor(self._cols_host, device=self.device)
        self.vals = torch.tensor(self._host_blocks[1][loc],
                                 device=self.device)

    def _setup_diag_and_precond(self, seg_ranges, pad2g) -> None:
        dg_g = _host_diag(self.a, 0, self.n)
        dg_g[dg_g == 0] = 1.0
        di = np.zeros(self.n_pad, self.dtype)
        if pad2g is None:
            di[: self.n] = 1.0 / dg_g
        else:
            valid = pad2g < self.n
            di[valid] = 1.0 / dg_g[pad2g[valid]]
        self._dinv_pad = torch.tensor(di[self._shard()], device=self.device)
        if self.precond == "block_ic0":
            rows_p, l_pack, u_pack = self._prep_precond_blocks(seg_ranges)
            ks = np.asarray([max(r1 - r0, 1) for r0, r1 in seg_ranges],
                            np.int32)
            self._set_block_ic0(rows_p, l_pack, u_pack, ks)

    def _set_block_ic0(self, rows_p, l_pack, u_pack, ks) -> None:
        self._pc_blocks = (rows_p, l_pack, u_pack, ks)
        loc = self.mesh.local
        self._block_ic0 = _BlockIC0(rows_p, tuple(a[loc] for a in l_pack),
                                    tuple(a[loc] for a in u_pack), ks[loc],
                                    self.u, self.device, self.dtype)

    def _prep_precond_blocks(self, seg_ranges):
        """Factor every vector segment's diagonal block (block-Jacobi
        IC(0)), falling back to point Jacobi (L = sqrt(D)) for a block
        whose IC(0) pivots fail.  Returns the stacked, commonly padded
        factor planes (cols, vals, dinv, rows) of L and of the reversed
        U -- the JAX package's arrays."""
        segs = len(seg_ranges)
        facs = []
        for (r0, r1) in seg_ranges:
            if r1 <= r0:
                facs.append(None)
                continue
            blk = tile_csr(self.a, r0, r1, r0, r1)
            try:
                facs.append(ic0(blk, dtype=self.dtype, device="cpu"))
            except ValueError:
                facs.append(None)
        max_seg = max((r1 - r0 for r0, r1 in seg_ranges), default=1)
        live = [f for f in facs if f]
        rows_p = max([pad_to(max(max_seg, 1), self._row_pad)]
                     + [max(f.ell_l.rows_padded, f.ell_u_rev.rows_padded)
                        for f in live])
        w = max([max(f.ell_l.width, f.ell_u_rev.width) for f in live] + [1])
        nl = max([max(f.sched_l.n_levels, f.sched_u_rev.n_levels)
                  for f in live] + [1])
        wl = max([max(f.sched_l.max_width, f.sched_u_rev.max_width)
                  for f in live] + [8])

        def pack(get_ell, get_sched):
            cols = np.zeros((segs, rows_p, w), np.int32)
            vals = np.zeros((segs, rows_p, w), self.dtype)
            dinv = np.ones((segs, rows_p), self.dtype)
            rows = np.full((segs, nl, wl), rows_p, np.int32)
            for s, f in enumerate(facs):
                r0, r1 = seg_ranges[s]
                k = r1 - r0
                if f is None:
                    if k <= 0:
                        continue
                    dsqrt = np.sqrt(np.maximum(_host_diag(self.a, r0, r1),
                                               1e-30))
                    cols[s, :k, 0] = np.arange(k)
                    vals[s, :k, 0] = dsqrt
                    dinv[s, :k] = 1.0 / dsqrt
                    # schedule: every row in one flat run (a diagonal)
                    nrows_lv = min(k, nl * wl)
                    flat = rows[s].reshape(-1)
                    flat[:nrows_lv] = np.arange(nrows_lv)
                    rows[s] = flat.reshape(nl, wl)
                    continue
                e, sc = get_ell(f), get_sched(f)
                ec, ev = e.cols.numpy(), e.vals.numpy()
                rp, ww = ec.shape
                cols[s, :rp, :ww] = ec
                vals[s, :rp, :ww] = ev
                dd = np.zeros(rows_p, np.float64)
                rpm = min(rp, rows_p)
                hit = (ec[:rpm] == np.arange(rpm)[:, None]) & (ev[:rpm] != 0)
                has = hit.any(axis=1)
                dd[:rpm][has] = ev[:rpm][np.arange(rpm)[has],
                                         np.argmax(hit, axis=1)[has]]
                dinv[s] = np.where(dd == 0, 1.0,
                                   1.0 / np.where(dd == 0, 1.0, dd))
                sr = np.asarray(sc.rows.cpu().numpy()
                                if isinstance(sc.rows, torch.Tensor)
                                else sc.rows)
                sr = np.where(sr >= sc.n, rows_p, sr)
                rows[s, : sr.shape[0], : sr.shape[1]] = sr
            return cols, vals, dinv, rows

        return (rows_p,
                pack(lambda f: f.ell_l, lambda f: f.sched_l),
                pack(lambda f: f.ell_u_rev, lambda f: f.sched_u_rev))

    # -- the tile grid: NoC programs ----------------------------------------

    def _buffer_len(self, layout: str) -> int:
        """m, the length of each tile's x buffer under ``layout``."""
        if layout == "halo":
            return (1 + self.comm_plan.halo_width) * self.u
        return self.bc if self.mode == "2d" else self.n_pad

    def _kernel_cols(self, layout: str) -> torch.Tensor:
        """The (tiles*rows_p, w) int32 kernel columns of ``layout``: the
        tile-local columns (halo-remapped on a halo layout) offset by t*m
        into the flat tile-stacked buffer, built on first use."""
        got = self._flat_cols.get(layout)
        if got is None:
            base = (self.comm_plan.cols_halo[self.mesh.local]
                    if layout == "halo" else self._cols_host)
            got = torch.tensor(_offset_cols(base, self._buffer_len(layout)),
                               device=self.device)
            self._flat_cols[layout] = got
        return got

    def _flat_vals(self, vals: torch.Tensor) -> torch.Tensor:
        return vals.view(-1, vals.shape[-1])

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """A padded global (..., n_pad) vector as its (..., P, u) tile
        stack (a view); a rank's (..., u) shard as its (..., 1, u)."""
        return x.view(x.shape[:-1] + (self.mesh.local_size, self.u))

    @property
    def _n_local(self) -> int:
        """Length of this process's vectors: n_pad, or a rank's u."""
        return self.mesh.local_size * self.u

    def _pull(self, xs: torch.Tensor, axes) -> tuple:
        """The halo shards: one ``pull_shard`` per scheduled hop."""
        return tuple(noc.pull_shard(xs, self.mesh, axes, d)
                     for d in self.comm_plan.deltas)

    def _comm(self, layout: str):
        """(gather, scatter) of the matvec on ``layout``: gather takes the
        padded global x to the (..., P, m) tile buffers, scatter the
        (..., P*rows_p) block partials to the padded global y."""
        mesh, row_axes, col_axes = self.mesh, self.row_axes, self.col_axes
        if self.mode == "2d":
            def gather(x):
                xc = noc.mesh_transpose(self._stack(x), mesh, row_axes,
                                        col_axes)
                if layout == "halo":       # own shard at slot 0, then pulls
                    return torch.cat((xc,) + self._pull(xc, row_axes), -1)
                return noc.gather_along(xc, mesh, row_axes)

            def scatter(yp):
                yp = yp.view(yp.shape[:-1] + (mesh.local_size, self.br))
                y = noc.reduce_scatter_along(yp, mesh, col_axes)
                return y.reshape(y.shape[:-2] + (self._n_local,))

            return gather, scatter

        def gather1d(x):
            xs = self._stack(x)
            if layout == "halo":
                return torch.cat((xs,) + self._pull(xs, self._all_axes), -1)
            return noc.gather_along(xs, mesh, self._all_axes)

        return gather1d, lambda yp: yp

    def _mk_matvec(self, layout: str = "dense"):
        """``mv(x, vals)``: y = A x on padded global (n_pad,) / (k, n_pad)
        vectors over the flat (tiles*rows_p, w) value blocks ``vals``: the
        NoC gather of x (the blanket collectives on "dense", the compiled
        pull schedule on "halo" -- the same values in every slot the
        structure references, so the two agree bit for bit), one launch
        for every tile's block, and the 2d reduce-scatter.  The NoC
        indices are built here, before any capture."""
        gather, scatter = self._comm(layout)
        cols = self._kernel_cols(layout)
        gather(torch.zeros(self._n_local, dtype=self.torch_dtype,
                           device=self.device))
        scatter(torch.zeros(self.mesh.local_size * self.br,
                            dtype=self.torch_dtype, device=self.device))

        def mv(x, vals):
            return scatter(_block_apply(cols, vals, gather(x)))

        return mv

    def _matvec_of(self, layout: str):
        mv = self._matvecs.get(layout)
        if mv is None:
            mv = self._matvecs[layout] = self._mk_matvec(layout)
        return mv

    def _tparts(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Every tile's partial of dot(u, v) over its shard: (L,) for (n,)
        vectors, (k, L) for (k, n) batches.  A batch reduces lane by lane,
        each lane as an (n,) solve reduces its vector, so lane j's bits do
        not depend on k (a reduction over a (k, P, u) block is laid out by
        its shape on the card)."""
        if u.dim() == 1:
            return torch.sum(self._stack(u * v), dim=-1)
        return torch.stack([torch.sum(self._stack(a * b), dim=-1)
                            for a, b in zip(u, v)])

    def _tdots(self, *vs: torch.Tensor) -> torch.Tensor:
        """N stacked dots of flat ``(a1, b1, a2, b2, ...)`` pairs,
        unrecorded: the tiles' partials added in tile order (the psum), one
        ``tile_sum`` for all N; (N,) for (n,) vectors, (N, k, 1) for (k, n)
        batches."""
        parts = [self._tparts(a, b) for a, b in zip(vs[::2], vs[1::2])]
        # one pair: a view, not a stack's copy (one node less a step)
        parts = (parts[0].unsqueeze(0) if len(parts) == 1
                 else torch.stack(parts))
        s = noc.tile_sum(parts, self.mesh)
        return s if vs[0].dim() == 1 else s.unsqueeze(-1)

    def _dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The grid's dot, one all-reduce: () for (n,) vectors, (k, 1) for
        (k, n) batches."""
        noc.record("all-reduce")
        return self._tdots(u, v)[0]

    def _dot2(self, *vs: torch.Tensor) -> torch.Tensor:
        """N stacked dots, ONE reduction (the pipelined recurrence's):
        flat ``(a1, b1, a2, b2, ...)`` pairs."""
        noc.record("all-reduce")
        return self._tdots(*vs)

    def _psum(self, *shares: torch.Tensor) -> tuple:
        """Sums over every tile from this process's shares of them (a
        kernel's in-stream reductions over its shard): the shares
        themselves on a ``TileMesh``, the ranks' shares added in rank
        order (one collective for all of them) on a ``ProcessMesh``.
        Unrecorded."""
        if not self.mesh.per_process:
            return shares
        return tuple(noc.rank_sum(torch.stack(shares), self.mesh).unbind(0))

    def _mk_matvec_split(self):
        """The communication-hiding SpMV as a ``(start, finish)`` pair
        (halo layout).  ``start(x)`` issues x's exchange -- the 2d mesh
        transpose and the pull schedule -- and returns the halo
        ``(own, pulled...)``; ``finish(halo, vi, vf)`` computes

            y = A_interior [own, 0...] + A_frontier [own, pulled...]

        as two launches summed, the JAX package's two applies: ``vi`` and
        ``vf`` zero complementary row sets of the same blocks, so the sum
        equals the one-pass halo SpMV."""
        gather, scatter = self._comm("halo")
        cols = self._kernel_cols("halo")
        row_axes, col_axes = self.row_axes, self.col_axes
        pull_axes = row_axes if self.mode == "2d" else self._all_axes

        def start(x):
            xs = self._stack(x)
            xc = (noc.mesh_transpose(xs, self.mesh, row_axes, col_axes)
                  if self.mode == "2d" else xs)
            return (xc,) + self._pull(xc, pull_axes)

        def finish(halo, vi, vf):
            xc, pulled = halo[0], halo[1:]
            x_int = torch.cat([xc] + [torch.zeros_like(t) for t in pulled],
                              -1)
            x_ext = torch.cat([xc, *pulled], -1)
            return scatter(_block_apply(cols, vi, x_int)
                           + _block_apply(cols, vf, x_ext))

        start(torch.zeros(self._n_local, dtype=self.torch_dtype,
                          device=self.device))
        return start, finish

    def _split_vals(self):
        """The interior/frontier value blocks of the overlap lowering,
        built on first use (the split doubles the value footprint): each
        keeps the full ELL shape with the complementary rows zeroed
        (``comm_plan.interior_mask``)."""
        if self._vals_split_dev is None:
            vals = self.vals_template()
            mask = self.comm_plan.interior_mask[self.mesh.local][:, :, None]
            vi = np.where(mask, vals, 0).astype(vals.dtype)
            vf = np.where(mask, 0, vals).astype(vals.dtype)
            self._vals_split_dev = tuple(
                torch.tensor(v.reshape(-1, v.shape[-1]), device=self.device)
                for v in (vi, vf))
        return self._vals_split_dev

    def _interior_mask_dev(self) -> torch.Tensor:
        """The (tiles*rows_p, 1) interior-row mask on the device
        (injectable overlap plans split their runtime values with it)."""
        if self._imask_dev is None:
            self._imask_dev = torch.tensor(
                self.comm_plan.interior_mask[self.mesh.local].reshape(-1, 1),
                device=self.device)
        return self._imask_dev

    def _op_layout(self) -> str:
        """The communication layout the engine-level ops (``spmv``) run:
        the engine knob resolved against the compiled comm plan ("auto" =
        halo exactly where it moves fewer bytes)."""
        if self.mode == "local" or self.comm_plan is None:
            return "dense"
        if self.layout == "auto":
            return "halo" if self.comm_plan.use_halo else "dense"
        return self.layout

    @staticmethod
    def _overlaps(sdef, spec: SolveSpec, kind: str) -> bool:
        """Whether a plan lowers the split communication-hiding matvec:
        the method consumes it (``comm_overlap``), the layout is the
        compiled pull schedule and the plan runs a shard substrate."""
        return (sdef.comm_overlap and spec.layout == "halo"
                and kind in ("fused_shard", "fused_shard_ic0"))

    def _lower_dist(self, spec: SolveSpec, sdef, kind: str) -> SolvePlan:
        """The tile grid's program: the NoC matvec of the spec's layout,
        the psolve from the registry capability flags (the inverse
        diagonal, the tiles' block-IC(0) solves, or the identity), the
        shard substrate of the resolved kind, and the reducing dot."""
        eff = registry.effective_precond(sdef, self.precond, local=False)
        mv = self._matvec_of(spec.layout)
        vals = self.vals.clone() if spec.injectable else self.vals
        vflat = self._flat_vals(vals)

        def amv(x):
            return mv(x, vflat)

        dinv = self._dinv_pad if eff.uses_dinv else None
        if eff.factorized:
            ps = self._block_ic0
        elif eff.uses_dinv:
            def ps(r):
                return r * dinv
        else:
            def ps(r):
                return r
        sub = None
        if kind == "fused_shard":
            sub = fused_shard_substrate(amv, dinv, self._tdots, self._psum)
        elif kind == "fused_shard_ic0":
            sub = fused_shard_ic0_substrate(amv, ps, self._tdots, self._psum)
        if self._overlaps(sdef, spec, kind):
            start, finish = self._mk_matvec_split()
            if spec.injectable:
                # the split recomputed from the plan's value buffer each
                # call (a host split would bake the clean values in)
                mask = self._interior_mask_dev()
                zero = torch.zeros((), dtype=self.torch_dtype,
                                   device=self.device)

                def fin(h):
                    return finish(h, torch.where(mask, vflat, zero),
                                  torch.where(mask, zero, vflat))
            else:
                vi, vf = self._split_vals()

                def fin(h):
                    return finish(h, vi, vf)
            sub = sub._replace(matvec_start=start, matvec_finish=fin)
        cell = ProgramCell(capture=not self.mesh.per_process)
        ctx = registry.SolveContext(
            matvec=amv, psolve=ps, dinv=dinv, substrate=sub,
            iters=spec.iters, tol=spec.tol, max_iters=spec.max_iters,
            guard=spec.guard, cell=cell, dot=self._dot, dot2=self._dot2)
        noc_model = self.comm_plan.model()
        noc_model["plan"] = spec.layout
        noc_model["comm_overlap"] = self._overlaps(sdef, spec, kind)
        return self._finish_plan(spec, sdef, kind, ctx, cell,
                                 vals if spec.injectable else None,
                                 noc_info=noc_model)

    # -- the tile grid: block-staged lower solve ----------------------------

    def build_sptrsv(self, l_csr: CSR):
        """Compile a distributed lower-triangular solve for ``l_csr`` on
        this engine's grid (square 2d grids).  Returns fn: b_global ->
        x_global, cached by the matrix's content.

        pr block stages: at stage I the tiles of block row I apply their
        L_IJ against the already solved x_J (one launch for every tile's
        block, then a psum along the row), the diagonal tile runs its own
        level-scheduled solve (one ``sptrsv_solve_dot`` over every tile's
        block, the tiles' schedules merged; only the diagonal tile's rows
        are real), and the solved x_I is broadcast down column I -- the
        JAX package's three NoC messages a stage."""
        if self.mode != "2d" or self.pr != self.pc:
            raise ValueError("distributed SpTRSV needs a square 2d engine")
        if self._row_perm is not None:
            raise ValueError(
                "distributed SpTRSV needs reorder='none': the engine's "
                "permutation would destroy triangularity of l_csr")
        if self.a is None:
            raise ValueError("distributed SpTRSV needs the engine's host "
                             "matrix (an engine built from_dist_state has "
                             "none)")
        if self._pad2g is not None:
            raise ValueError(
                "distributed SpTRSV needs uniform row blocks (the engine's "
                "nnz-balanced 2d embedding shifts block boundaries) -- "
                "build the engine with balance='rows'")
        key = _csr_fingerprint(l_csr)
        if key in self._trsv_cache:
            return self._trsv_cache[key]
        solve = _BlockSptrsv(self, l_csr)
        self._trsv_cache[key] = solve
        return solve

    # -- plan/execute API ---------------------------------------------------

    def plan(self, spec: SolveSpec | None = None, **kwargs) -> SolvePlan:
        """Lower a :class:`SolveSpec` into a cached :class:`SolvePlan`
        (``plan(method="pcg_tol", tol=1e-8)`` is shorthand for the spec)."""
        if spec is None:
            spec = SolveSpec(**kwargs)
        return self.plans.get(canonicalize(spec, self), self._lower)

    def _lower(self, spec: SolveSpec) -> SolvePlan:
        """Pick the substrate by capability lookup and close the program
        over the device operands.  A non-ELL format streams the operator
        through its own (matvec, fold) pair: ONE matvec closure serves
        the fused substrate and the reference one."""
        sdef = registry.get_solver(spec.method)
        pdef = registry.get_precond(self.precond)
        if self.mode != "local":
            return self._lower_dist(
                spec, sdef,
                registry.substrate_kind(sdef, pdef, spec.fused, local=False))
        kind = registry.substrate_kind(sdef, pdef, spec.fused)
        # the preconditioner the method's psolve is built from: identity
        # for cg, jacobi for the jacobi smoother, else the engine's
        eff = registry.effective_precond(sdef, self.precond)
        cols = vals = None
        if self.ell is not None:
            cols, vals = self.ell.cols, self.ell.vals
        if spec.injectable:
            # the plan's own value buffer, with the layout and alignment of
            # the engine's: the program (and its captured graph) reads it,
            # each call copies the operand into it, and the engine's
            # buffer -- engine.spmv, the audits' clean operator -- stays
            # clean.  The preconditioner's operands stay clean too:
            # faults target the streamed matrix.
            vals = vals.clone()
        dinv = self._dinv_pad
        stream = None
        if spec.format != "ell":
            fobj = (self.stencil if spec.format == "stencil"
                    else self._format_obj(spec.format))
            stream = format_stream_ops(fobj, spec.format, self.n_pad)
        sub = None
        if kind == "fused_ic0":
            sub = fused_ic0_local_substrate(cols, vals, self._ic0_apply,
                                            stream_ops=stream)
        elif kind == "fused":
            sub = fused_local_substrate(cols, vals,
                                        dinv=dinv if eff.uses_dinv else None,
                                        stream_ops=stream)
        if stream is not None:
            matvec = stream[0]
        else:
            def matvec(x):
                return _matvec(cols, vals, x)
        # the plan's capture cell, as the JAX engine's trace cell: the
        # program counts its builds there, and the solver's while_loop
        # captures and replays its loop there
        cell = ProgramCell()
        ctx = registry.SolveContext(
            matvec=matvec,
            psolve=eff.local_apply(self), dinv=dinv, substrate=sub,
            iters=spec.iters, tol=spec.tol, max_iters=spec.max_iters,
            guard=spec.guard, cell=cell,
        )

        return self._finish_plan(spec, sdef, kind, ctx, cell,
                                 vals if spec.injectable else None)

    def _finish_plan(self, spec: SolveSpec, sdef, kind: str, ctx, cell,
                     vals, noc_info: dict | None = None) -> SolvePlan:
        """The plan around a built context: the program (the solver run
        inside the plan's cell), its info and the observability records."""

        def run(b_pad, x0_pad):
            return ensure_status(sdef.run(ctx, b_pad, x0_pad), b_pad)

        def prog(b_pad, x0_pad):
            with cell.running(b_pad, x0_pad):
                return run(b_pad, x0_pad)

        info = {
            "method": spec.method,
            "precond": spec.precond,
            "fused": spec.fused,
            "substrate": kind,
            "batch": spec.batch,
            "layout": spec.layout,
            "reorder": spec.reorder,
            "format": spec.format,
            "loop": ("captured" if cell.capture and self.device.type == "cuda"
                     else "eager"),
        }
        _OBS.counter(
            "repro_plan_format_total",
            "plans lowered by operator storage format", ("format",),
        ).inc(format=spec.format)
        if noc_info is not None:
            info["noc"] = noc_info
            g = _OBS.gauge(
                "repro_plan_noc_bytes_per_iter",
                "modeled NoC bytes per solver iteration by comm layout",
                ("layout",))
            for lay in ("halo", "dense"):
                g.set(float(noc_info[f"bytes_per_iter_{lay}"]), layout=lay)
        _OBS.gauge(
            "repro_engine_device_bytes",
            "device-resident operator footprint of the last-planned engine",
        ).set(float(self.device_bytes()))
        return SolvePlan(self, spec, prog, info, cell, ctx, vals=vals,
                         trace_fn=run if self.mode != "local" else None)


class _BlockSptrsv:
    """The block-staged distributed lower solve of
    ``AzulEngine.build_sptrsv``: ``solve(b_global) -> x_global``, and
    ``device_fn`` on the engine's padded device vectors."""

    def __init__(self, eng, l_csr: CSR):
        from ..kernels import ops

        pr, pc, mesh = eng.pr, eng.pc, eng.mesh
        plan = plan_2d(l_csr, pr, pc, width_pad=eng._width_pad,
                       row_pad=eng._row_pad, dtype=eng.dtype)
        if plan.n_padded != eng.n_pad:
            raise ValueError("triangular matrix padding mismatch with engine")
        br = plan.block_rows
        # this process's tiles (all of them, or a rank's own); every
        # diagonal one's level schedule of its own block, merged level by
        # level over the tiles (local tile j's rows at offset j*br)
        tiles = range(pr * pc)[mesh.local]
        p = len(tiles)
        nl = l_csr.shape[0]
        scheds = {}
        for j, t in enumerate(tiles):
            i = t // pc
            r0, r1 = min(i * br, nl), min((i + 1) * br, nl)
            if t == i * pc + i and r1 > r0:
                scheds[j] = build_schedule(tile_csr(l_csr, r0, r1, r0, r1))
        n_lv = max([sc.n_levels for sc in scheds.values()] + [1])
        w_lv = max([sc.max_width for sc in scheds.values()] + [8])
        rows = np.full((n_lv, p * w_lv), p * br, np.int64)
        for j, sc in scheds.items():
            sr = np.asarray(sc.rows, np.int64)
            sr = np.where(sr >= sc.n, p * br, sr + j * br)
            rows[: sr.shape[0], j * w_lv: j * w_lv + sr.shape[1]] = sr
        dloc = np.ones((p, br), eng.dtype)
        dg = np.ones(eng.n_pad, np.float64)
        dg[:nl] = _host_diag(l_csr, 0, nl)
        dg[dg == 0] = 1.0
        for j, t in enumerate(tiles):
            i = t // pc
            if t == i * pc + i:
                dloc[j] = (1.0 / dg[i * br: (i + 1) * br]).astype(eng.dtype)
        dev = eng.device
        self.cols = torch.tensor(_offset_cols(plan.cols[mesh.local], br),
                                 device=dev)
        self.vals = torch.tensor(plan.vals[mesh.local].reshape(p * br, -1),
                                 device=dev)
        self.dinv = torch.tensor(dloc.reshape(-1), device=dev)
        self.rows = torch.tensor(rows.astype(np.int32), device=dev)
        self.pack = ops.sptrsv_solve_pack(self.cols, self.rows, p * br)
        self.ri = noc.axis_coord(mesh, eng.row_axes)
        self.ci = noc.axis_coord(mesh, eng.col_axes)
        self.eng, self.br, self.p = eng, br, p

    def device_fn(self, b: torch.Tensor) -> torch.Tensor:
        """x for b, both this process's part of the padded global vectors
        ((n_pad,), or a rank's (u,) shard)."""
        from ..kernels import ops

        eng, br, p, mesh = self.eng, self.br, self.p, self.eng.mesh
        u, pc = eng.u, eng.pc
        b_row = noc.gather_along(eng._stack(b), mesh, eng.col_axes)  # b_I
        x_col = b.new_zeros(p, br)          # the solved x_J of each column
        out = b.new_zeros(p, u)
        tiles = torch.arange(p, device=b.device)
        for stage in range(eng.pr):
            part = _block_apply(self.cols, self.vals, x_col).view(p, br)
            rhs = b_row - noc.reduce_along(part, mesh, eng.col_axes)
            xi, _ = ops.sptrsv_solve_dot(self.cols, self.vals, self.dinv,
                                         rhs.reshape(-1), self.rows, None,
                                         n_rows=p * br, pack=self.pack)
            mine = ((self.ri == stage) & (self.ci == stage))[:, None]
            x_i = noc.reduce_along(torch.where(mine, xi.view(p, br), 0.0),
                                   mesh, eng._all_axes)
            x_col = torch.where((self.ci == stage)[:, None], x_i, x_col)
            seg = x_i.view(p, pc, u)[tiles, self.ci]
            out = torch.where((self.ri == stage)[:, None], seg, out)
        return out.reshape(-1)

    def __call__(self, b_global) -> np.ndarray:
        bd = self.eng.to_device_vec(np.asarray(b_global))
        return self.eng.from_device_vec(self.device_fn(bd))
