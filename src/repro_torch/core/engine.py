"""AzulEngine: the public solve API of the port (local mode).

Port of ``repro.core.engine`` for one device.  Given a square sparse
matrix (or a matrix-free ``Stencil``), the engine

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

``reorder="rcm"`` packs the reverse Cuthill-McKee permuted matrix (ELL,
the format containers, the IC(0) factors and ``device_bytes`` all see it)
and permutes every vector on the way in and back on the way out
(``to_device_vec`` / ``from_device_vec``), so callers speak the original
ordering.  ``layout`` is the distributed communication knob: one device
has no NoC, so plans lower "dense" and "halo" raises.

Not ported yet, and refused with NotImplementedError naming the ROADMAP
item: distributed meshes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import registry
from ..device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..kernels.autotune import choose_format, modeled_format_words
from ..obs import REGISTRY as _OBS
from .formats import (CSR, ELL, bcsr_from_csr, ell_arrays_from_csr,
                      hyb_from_csr, pad_to, sell_from_csr)
from .loop import ProgramCell
from .partition import permute_csr, rcm_permutation
from .plan import (PlanCache, SolvePlan, SolveSpec, canonicalize,
                   warn_deprecated)
from .precond import ic0, make_fused_ic0_apply
from .solvers import ensure_status
from .spops import spmm_ell_padded, spmv_ell_padded
from .stencil import Stencil, stencil_diag, stencil_matvec
from .substrate import (format_stream_ops, fused_ic0_local_substrate,
                        fused_local_substrate)

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


class AzulEngine:
    """Single-device sparse iterative-solver engine (module docstring).

    Parameters
    ----------
    a : CSR | Stencil       square sparse matrix (host side), or a
                            matrix-free stencil operator
    mesh : None             distributed meshes are not ported yet
                            (ROADMAP Queue 1 item 10)
    precond : "jacobi" | "block_ic0" | "none"  (a stencil takes "jacobi"
                            or "none": block_ic0 needs stored nonzeros)
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
        Distributed communication layout; a local engine lowers "dense"
        and rejects "halo" (it needs a mesh).
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
    device : "cuda" (default) | "cpu"
    """

    def __init__(self, a: CSR | Stencil, mesh=None, precond: str = "jacobi",
                 dtype=np.float32, row_pad: int = 8, width_pad: int = 8,
                 fused="auto", layout: str = "auto", reorder: str = "none",
                 format: str = "auto", device=DEFAULT_DEVICE):
        if mesh is not None:
            raise NotImplementedError(
                "distributed meshes are not ported yet (ROADMAP Queue 1 "
                "item 10)")
        if a.shape[0] != a.shape[1]:
            raise ValueError("engine expects a square matrix")
        if layout not in ("auto", "halo", "dense"):
            raise ValueError(
                f"layout must be 'auto', 'halo' or 'dense', got {layout!r}")
        if reorder not in ("none", "rcm"):
            raise ValueError(f"reorder must be 'none' or 'rcm', got {reorder!r}")
        if layout == "halo":
            raise ValueError("layout='halo' needs a mesh (no NoC locally)")
        if format not in _FORMAT_KNOBS:
            raise ValueError(
                "format must be 'auto', 'ell', 'sell', 'hyb', 'bcsr' or "
                f"'stencil', got {format!r}")
        self._configure(precond, fused, dtype, device)
        self.layout = layout
        is_stencil = isinstance(a, Stencil)
        if is_stencil:
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
        n = a.shape[0]
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

    def _configure(self, precond, fused, dtype, device) -> None:
        if fused not in ("auto", True, False):
            raise ValueError(f"fused must be 'auto', True or False, got {fused!r}")
        registry.get_precond(precond)      # fail fast on unknown names
        self.precond = precond
        self.fused = fused
        self.dtype, self.torch_dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.mode = "local"
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

    def to_device_vec(self, v: np.ndarray) -> torch.Tensor:
        """Embed a global (n,) vector, or a (k, n) batch, into the padded
        (n_pad,) / (k, n_pad) device layout (zeros past n).  With
        ``reorder`` active the engine's row permutation applies here (and
        inverts in :meth:`from_device_vec`), so callers always speak the
        original ordering."""
        v = np.asarray(v)
        if self._row_perm is not None:
            v = v[..., self._row_perm]
        out = np.zeros(v.shape[:-1] + (self.n_pad,), self.dtype)
        out[..., : self.n] = v
        return torch.from_numpy(out).to(self.device)

    def from_device_vec(self, v: torch.Tensor) -> np.ndarray:
        """Extract the global (n,) / (k, n) vectors from the padded
        layout (waits for the device: the copy to the host)."""
        out = v[..., : self.n].cpu().numpy()
        if self._row_iperm is not None:
            out = out[..., self._row_iperm]
        return out

    # -- public ops ---------------------------------------------------------

    def spmv(self, x) -> np.ndarray:
        """y = A @ x on a global (n,) vector, or a (k, n) batch through the
        multi-RHS matvec (plain PyTorch, one matrix gather for all k; the
        shifted adds for a stencil)."""
        xd = self.to_device_vec(np.asarray(x))
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
        program either)."""
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
        "fused" or "fused_ic0"."""
        sdef = registry.get_solver(method)
        pdef = registry.get_precond(self.precond)
        knob = self.fused if fused is None else fused
        use = registry.resolve_fused(sdef, pdef, knob, self.device)
        return registry.substrate_kind(sdef, pdef, use)

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
        kind = registry.substrate_kind(sdef, pdef, spec.fused)
        # the preconditioner the method's psolve is built from: identity
        # for cg, jacobi for the jacobi smoother, else the engine's
        eff = registry.effective_precond(sdef, self.precond)
        cols = vals = None
        if self.ell is not None:
            cols, vals = self.ell.cols, self.ell.vals
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

        def prog(b_pad, x0_pad):
            with cell.running(b_pad, x0_pad):
                return ensure_status(sdef.run(ctx, b_pad, x0_pad), b_pad)

        info = {
            "method": spec.method,
            "precond": spec.precond,
            "fused": spec.fused,
            "substrate": kind,
            "batch": spec.batch,
            "layout": spec.layout,
            "reorder": spec.reorder,
            "format": spec.format,
        }
        _OBS.counter(
            "repro_plan_format_total",
            "plans lowered by operator storage format", ("format",),
        ).inc(format=spec.format)
        _OBS.gauge(
            "repro_engine_device_bytes",
            "device-resident operator footprint of the last-planned engine",
        ).set(float(self.device_bytes()))
        return SolvePlan(self, spec, prog, info, cell, ctx)
