"""Carry a local operator's state between the JAX package and the port.

The JAX engine's local operator is three arrays -- the padded ELL
``cols``/``vals`` and the padded inverse diagonal -- read out as numpy
(``np.asarray(eng.ell.cols)``, ``eng.ell.vals``, ``eng._dinv_pad``).
:func:`engine_state_from_numpy` builds the port's engine over exactly those
arrays, so both packages can run on identical operands;
:func:`engine_state_to_numpy` reads them back.

A block-IC(0) engine also carries its ``IC0Factors``: the two padded ELL
factors and the two schedules' ``rows`` (``eng._ic0.ell_l.cols``, ...,
``eng._ic0.sched_l.rows``), as the dict :func:`ic0_factors_to_numpy`
returns.  :func:`ic0_factors_from_numpy` builds the port's factors from
it.

The JAX package's SELL, HYB and BCSR containers and its matrix-free
``Stencil`` carry over as dicts of their fields, arrays as numpy
(``{k: np.asarray(v) for k, v in obj._asdict().items()}``):
:func:`format_from_numpy` builds the port's container (SELL and HYB with
their row-reduction plans), :func:`format_to_numpy` reads one back.  An
engine built by :func:`engine_state_from_numpy` takes them as
``formats={"hyb": {...}}`` for plans with ``SolveSpec(format=...)``.

A distributed (tile-grid) engine's state is the partition and its NoC
plan: the stacked ``partition_plan.cols``/``vals`` (the 1d mode's padded
layout columns, ``eng._cols_pad_host``), the inverse diagonal, ``pad2g``,
the comm plan's fields and, for block-IC(0), the per-tile factor planes
(``eng._pc_l``, ``eng._pc_u``, ``eng._pc_k``, ``eng._pc_rows_p``), all as
numpy -- the dict :func:`dist_engine_state_to_numpy` returns for a port
engine.  :func:`dist_engine_state_from_numpy` builds the port's engine on
a ``TileMesh`` over it.

An LM's params carry over as the JAX package's tree with numpy leaves
(``jax.tree.map(np.asarray, M.init_params(key, cfg))``): ``embed``,
``final_norm``, ``head``, ``mtp`` and ``groups``, one tree a layer group
with the group's layers stacked on a leading axis.
:func:`lm_params_from_numpy` builds the port's ``Model`` over it and
:func:`lm_params_to_numpy` reads one back (bfloat16 leaves as float32, which
holds them exactly); :func:`lm_caches_to_numpy` stacks the port's
``[group][layer]`` caches into the JAX package's layout.

A training state carries over in the JAX ``TrainState``'s layout: its
``params`` (the tree above), ``opt_state`` (AdamW's ``{"m", "v"}`` or
Adafactor's ``{"f"}``, trees of the params' paths, a group's state stacked
on a leading axis), ``step`` and ``ef`` (the error-feedback residuals, or
None), numpy leaves -- ``jax.tree.map(np.asarray, state)`` or a dict of the
four fields.  :func:`train_state_from_numpy` builds the port's
``train.TrainState`` over it, :func:`train_state_to_numpy` reads one back
as that dict.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.engine import AzulEngine
from .core.formats import (BCSR, ELL, HYB, SELL, hyb_row_groups,
                           sell_row_groups)
from .core.levels import LevelSchedule
from .core.precond import IC0Factors
from .core.stencil import Stencil
from .device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from .models import model as lm
from .train.step import TrainState

__all__ = ["engine_state_from_numpy", "engine_state_to_numpy",
           "dist_engine_state_from_numpy", "dist_engine_state_to_numpy",
           "ic0_factors_from_numpy", "ic0_factors_to_numpy",
           "format_from_numpy", "format_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy", "lm_caches_to_numpy"]

_FACTORS = (("l", "ell_l", "sched_l"), ("u_rev", "ell_u_rev", "sched_u_rev"))


def _check_ell(cols, vals, rows_p: int, what: str):
    cols, vals = np.asarray(cols), np.asarray(vals)
    if cols.ndim != 2 or cols.shape != vals.shape or cols.shape[0] != rows_p:
        raise ValueError(f"{what}: cols {cols.shape} / vals {vals.shape} must "
                         f"both be ({rows_p}, w)")
    if not np.issubdtype(cols.dtype, np.integer):
        raise TypeError(f"{what}: cols must be integer, got {cols.dtype}")
    if cols.size and (cols.min() < 0 or cols.max() >= rows_p):
        raise ValueError(f"{what}: cols index outside [0, {rows_p})")
    return cols.astype(np.int32), vals


def _schedule(rows, n: int) -> LevelSchedule:
    """A LevelSchedule from its (n_levels, W) ``rows`` (padded with ``n``);
    raises unless every row 0..n-1 is listed exactly once."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or not np.issubdtype(rows.dtype, np.integer):
        raise ValueError(f"schedule rows must be a 2-D integer array, got "
                         f"{rows.dtype} {rows.shape}")
    real = rows != n
    ids = rows[real]
    if ids.size != n or not np.array_equal(np.sort(ids), np.arange(n)):
        raise ValueError("schedule rows must list every row 0..n-1 once, "
                         "padded with n")
    level_of = np.empty(n, np.int32)
    level_of[ids] = np.nonzero(real)[0]
    return LevelSchedule(rows.astype(np.int32),
                         real.sum(axis=1).astype(np.int32), level_of, n)


def ic0_factors_from_numpy(factors: dict, device=DEFAULT_DEVICE) -> IC0Factors:
    """The port's ``IC0Factors`` on ``device`` from host arrays:
    ``{"l_cols", "l_vals", "l_rows", "u_rev_cols", "u_rev_vals",
    "u_rev_rows", "n"}`` (the ELL factors and the schedules' ``rows``)."""
    dev = resolve_device(device)
    n = int(factors["n"])
    parts = []
    for key, _, _ in _FACTORS:
        rows_p = np.asarray(factors[f"{key}_cols"]).shape[0]
        if not 0 < n <= rows_p:
            raise ValueError(f"need 0 < n <= rows_p, got n={n}, {rows_p}")
        cols, vals = _check_ell(factors[f"{key}_cols"], factors[f"{key}_vals"],
                                rows_p, f"factor {key}")
        sched = _schedule(factors[f"{key}_rows"], n)
        parts += [ELL(torch.tensor(cols, device=dev),
                      torch.tensor(vals, device=dev), n, n),
                  sched._replace(rows=torch.tensor(sched.rows, device=dev))]
    return IC0Factors(*parts, n)


def ic0_factors_to_numpy(f: IC0Factors) -> dict:
    """The host arrays of the port's factors, as
    :func:`ic0_factors_from_numpy` takes them."""
    out = {"n": f.n}
    for key, ell_name, sched_name in _FACTORS:
        ell, sched = getattr(f, ell_name), getattr(f, sched_name)
        out[f"{key}_cols"] = ell.cols.cpu().numpy()
        out[f"{key}_vals"] = ell.vals.cpu().numpy()
        out[f"{key}_rows"] = sched.rows.cpu().numpy()
    return out


def _index(a, bound: int, what: str) -> np.ndarray:
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"{what} must be integer, got {a.dtype}")
    if a.size and (a.min() < 0 or a.max() >= bound):
        raise ValueError(f"{what}: index outside [0, {bound})")
    return a.astype(np.int32)


def format_from_numpy(fmt: str, arrays: dict, device=DEFAULT_DEVICE):
    """The port's container for ``fmt`` ("sell", "hyb", "bcsr" or
    "stencil") from the JAX container's fields as host arrays (the
    ``_asdict()`` of it).  Indices are validated here, once, so the
    matvecs gather without bounds checks."""
    if fmt not in ("sell", "hyb", "bcsr", "stencil"):
        raise ValueError(f"no format container for {fmt!r}")
    dev = resolve_device(device)
    a = arrays
    if fmt == "stencil":
        if a["kind"] not in ("lap2d", "lap3d"):
            raise ValueError(f"unknown stencil kind {a['kind']!r}")
        return Stencil(str(a["kind"]), tuple(int(d) for d in a["dims"]))
    n_rows, n_cols = int(a["n_rows"]), int(a["n_cols"])
    if fmt == "sell":
        rp, sh = int(a["rows_padded"]), int(a["slice_height"])
        widths = np.asarray(a["slice_widths"]).astype(np.int32)
        vals = np.asarray(a["vals"])
        total = sh * int(widths.sum())
        if rp != sh * widths.size or vals.shape != (total,):
            raise ValueError(f"SELL: {widths.size} slices of {sh} rows and "
                             f"{vals.shape} values for {rp} padded rows")
        cols = _index(a["cols"], n_cols, "SELL cols")
        rows = _index(a["rows"], rp, "SELL rows")
        if not np.array_equal(rows, np.repeat(np.arange(rp, dtype=np.int32),
                                              np.repeat(widths, sh))):
            raise ValueError("SELL rows do not follow the slice widths")
        return SELL(torch.tensor(cols, device=dev), torch.tensor(vals, device=dev),
                    torch.tensor(rows, device=dev), widths, n_rows, n_cols, rp,
                    sh, sell_row_groups(widths, sh, dev))
    if fmt == "hyb":
        vals, tv = np.asarray(a["vals"]), np.asarray(a["tail_vals"])
        rp = vals.shape[0]
        cols, _ = _check_ell(a["cols"], vals, rp, "HYB core")
        cols = _index(cols, n_cols, "HYB cols")
        tr = _index(a["tail_rows"], rp, "HYB tail_rows")
        tc = _index(a["tail_cols"], n_cols, "HYB tail_cols")
        if not tr.shape == tc.shape == tv.shape:
            raise ValueError("HYB tail arrays differ in length")
        t = [torch.tensor(v, device=dev) for v in (cols, vals, tr, tc, tv)]
        return HYB(*t, n_rows, n_cols, hyb_row_groups(tr, dev))
    else:
        blocks = np.asarray(a["blocks"])
        if blocks.ndim != 4:
            raise ValueError(f"BCSR blocks {blocks.shape} must be (nbr, w, bm, bn)")
        nbc = -(-n_cols // blocks.shape[3])
        bc = _index(a["block_cols"], nbc, "BCSR block_cols")
        if bc.shape != blocks.shape[:2]:
            raise ValueError(f"BCSR block_cols {bc.shape} vs blocks {blocks.shape}")
        return BCSR(torch.tensor(bc, device=dev), torch.tensor(blocks, device=dev),
                    n_rows, n_cols)


def format_to_numpy(obj) -> tuple[str, dict]:
    """``(fmt, fields)`` of a port container, arrays as numpy, the fields
    :func:`format_from_numpy` takes (SELL/HYB without their plans)."""
    fmt = {SELL: "sell", HYB: "hyb", BCSR: "bcsr", Stencil: "stencil"}[type(obj)]
    out = {}
    for k, v in obj._asdict().items():
        if k == "row_groups":
            continue
        out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return fmt, out


def engine_state_from_numpy(cols, vals, dinv, n: int, n_pad: int,
                            precond: str = "jacobi", fused="auto",
                            device=DEFAULT_DEVICE,
                            ic0: dict | None = None,
                            formats: dict | None = None) -> AzulEngine:
    """The port's local engine over a packed operator.

    ``cols``/``vals``: (n_pad, w) padded ELL, ``dinv``: (n_pad,) inverse
    diagonal (zeros past ``n``), ``n``: the true row count; ``ic0``: for
    ``precond="block_ic0"``, the factors as :func:`ic0_factors_from_numpy`
    takes them; ``formats``: {"sell" | "hyb" | "bcsr": the container's
    fields} (:func:`format_from_numpy`) of the same operator.  The arrays
    are validated here, once, so the kernels can gather without bounds
    checks.
    """
    cols, vals = _check_ell(cols, vals, n_pad, "operator")
    dinv = np.asarray(dinv)
    if dinv.shape != (n_pad,):
        raise ValueError(f"dinv {dinv.shape} must be ({n_pad},)")
    if not 0 < n <= n_pad:
        raise ValueError(f"need 0 < n <= n_pad, got n={n}, n_pad={n_pad}")
    factors = None
    if ic0 is not None:
        if int(ic0["n"]) != n:
            raise ValueError(f"factors are for n={ic0['n']}, operator n={n}")
        for key in ("l_vals", "u_rev_vals"):
            if np.asarray(ic0[key]).dtype != vals.dtype:
                raise TypeError(f"factor {key} is {np.asarray(ic0[key]).dtype}, "
                                f"the operator {vals.dtype}")
        factors = ic0_factors_from_numpy(ic0, device=device)
    objs = {}
    for fmt, arrays in (formats or {}).items():
        obj = format_from_numpy(fmt, arrays, device=device)
        if obj.n_rows != n or obj.n_cols != n:
            raise ValueError(f"{fmt} container is {obj.n_rows} x "
                             f"{obj.n_cols}, the operator {n} x {n}")
        vt = obj.blocks if fmt == "bcsr" else obj.vals
        if vt.dtype != resolve_dtype(vals.dtype)[1]:
            raise TypeError(f"{fmt} container is {vt.dtype}, the operator "
                            f"{vals.dtype}")
        if fmt != "bcsr" and obj.rows_padded != n_pad:
            raise ValueError(f"{fmt} container has {obj.rows_padded} padded "
                             f"rows, the operator {n_pad}")
        objs[fmt] = obj
    return AzulEngine.from_state(cols, vals, dinv.astype(vals.dtype), n,
                                 precond=precond, fused=fused, device=device,
                                 ic0_factors=factors, fmt_objs=objs)


def engine_state_to_numpy(engine: AzulEngine) -> dict:
    """``{"cols", "vals", "dinv", "n", "n_pad"}`` of a port engine, as
    host arrays, ``"ic0"`` (:func:`ic0_factors_to_numpy`) for a
    block-IC(0) engine and ``"formats"`` for the SELL/HYB/BCSR containers
    it has built."""
    if engine.ell is None:
        raise ValueError("a stencil engine stores no operator; carry its "
                         "Stencil with format_to_numpy")
    out = {
        "cols": engine.ell.cols.cpu().numpy(),
        "vals": engine.ell.vals.cpu().numpy(),
        "dinv": engine._dinv_pad.cpu().numpy(),
        "n": engine.n,
        "n_pad": engine.n_pad,
    }
    if engine._ic0 is not None:
        out["ic0"] = ic0_factors_to_numpy(engine._ic0)
    if engine._fmt_objs:
        out["formats"] = {fmt: format_to_numpy(obj)[1]
                          for fmt, obj in engine._fmt_objs.items()}
    return out


_COMM_FIELDS = ("mode", "deltas", "cols_halo", "pull_axis_size", "u",
                "itemsize", "fixed_words", "use_halo", "interior_mask",
                "interior_nnz", "total_nnz")
_PLANES = ("cols", "vals", "dinv", "rows")


def dist_engine_state_to_numpy(engine: AzulEngine) -> dict:
    """The host arrays of a tile-grid engine (module docstring): ``mode``,
    the axes, the sizes, ``cols``/``vals`` (tiles, rows_p, w), ``dinv``
    (n_pad,), ``pad2g``, ``comm_plan`` (its fields) and, for block-IC(0),
    ``block_ic0`` (``rows_p``, ``ks`` and the ``l_*``/``u_*`` planes)."""
    if engine.mode == "local":
        raise ValueError("a local engine: use engine_state_to_numpy")
    out = {
        "mode": engine.mode, "row_axes": engine.row_axes,
        "col_axes": engine.col_axes, "n": engine.n, "n_pad": engine.n_pad,
        "u": engine.u, "br": engine.br,
        "bc": engine.bc if engine.mode == "2d" else engine.n_pad,
        "cols": engine.cols_template(), "vals": engine.vals_template(),
        "dinv": engine._dinv_pad.cpu().numpy(),
        "pad2g": None if engine._pad2g is None else engine._pad2g.copy(),
        "comm_plan": {k: getattr(engine.comm_plan, k) for k in _COMM_FIELDS},
    }
    if engine._pc_blocks is not None:
        rows_p, lp, up, ks = engine._pc_blocks
        blk = {"rows_p": rows_p, "ks": np.asarray(ks)}
        for pre, planes in (("l", lp), ("u", up)):
            blk.update({f"{pre}_{k}": np.asarray(a)
                        for k, a in zip(_PLANES, planes)})
        out["block_ic0"] = blk
    return out


def dist_engine_state_from_numpy(mesh, state: dict, precond: str = "jacobi",
                                 fused="auto",
                                 layout: str = "auto") -> AzulEngine:
    """The port's tile-grid engine on ``mesh`` over ``state`` (the dict of
    :func:`dist_engine_state_to_numpy`, or the same arrays read out of a
    JAX distributed engine).  The stacked columns are validated here
    against the layouts they index."""
    cols = np.asarray(state["cols"])
    vals = np.asarray(state["vals"])
    if cols.ndim != 3 or cols.shape != vals.shape:
        raise ValueError(f"cols {cols.shape} / vals {vals.shape} must both "
                         "be (tiles, rows_p, w)")
    bound = int(state["bc"]) if state["mode"] == "2d" else int(state["n_pad"])
    if cols.size and (cols.min() < 0 or cols.max() >= bound):
        raise ValueError(f"cols index outside [0, {bound})")
    halo = np.asarray(state["comm_plan"]["cols_halo"])
    h = len(state["comm_plan"]["deltas"])
    if halo.shape != cols.shape or (halo.size and (
            halo.min() < 0 or halo.max() >= (1 + h) * int(state["u"]))):
        raise ValueError("comm plan cols_halo does not match the blocks")
    return AzulEngine.from_dist_state(mesh, state, precond=precond,
                                      fused=fused, layout=layout)



# -- LM params ----------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _host(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no torch view of it
        a = a.astype(np.float32)
    return a


def lm_params_from_numpy(cfg, tree: dict, device=DEFAULT_DEVICE) -> lm.Model:
    """The port's ``Model`` of ``cfg`` on ``device`` holding exactly the
    arrays of ``tree`` (the JAX package's param tree, numpy leaves), cast to
    ``cfg.param_dtype``.  Every leaf must be used, with its shape."""
    dev = resolve_device(device)
    model = lm.init_params(cfg, None, dev)
    want = set()
    for name, prm in model.named_parameters():
        path, layer = lm.jax_path(name)
        want.add(tuple(path))
        node = tree
        try:
            for q in path:
                node = node[q]
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"param tree has no {'/'.join(map(str, path))}")
        a = _host(node)
        if layer is not None:
            a = a[layer]
        if tuple(a.shape) != tuple(prm.shape):
            raise ValueError(f"{name}: tree shape {a.shape}, model {tuple(prm.shape)}")
        with torch.no_grad():
            prm.copy_(torch.from_numpy(np.array(a)))
    extra = {p for p, _ in _leaves(tree)} - want
    if extra:
        raise ValueError(f"param tree leaves the model has no place for: "
                         f"{sorted('/'.join(map(str, p)) for p in extra)}")
    return model


def _set(tree: dict, path, value) -> None:
    node = tree
    for q, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= q:
                node.append([] if isinstance(nxt, int) else {})
            node = node[q]
        else:
            node = node.setdefault(q, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def lm_params_to_numpy(model: lm.Model) -> dict:
    """``model``'s params as the JAX package's tree with numpy leaves, each
    group's layers stacked on a leading axis (bfloat16 as float32)."""
    tree: dict = {}
    stacks: dict = {}
    for name, prm in model.named_parameters():
        path, layer = lm.jax_path(name)
        if layer is None:
            _set(tree, path, _numpy(prm))
        else:
            stacks.setdefault(tuple(path), {})[layer] = _numpy(prm)
    for path, by_layer in stacks.items():
        _set(tree, list(path), np.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree


def lm_caches_to_numpy(caches) -> list:
    """The port's ``[group][layer]`` caches as the JAX package's: one tree a
    group, each leaf stacked over the group's layers, numpy."""
    out = []
    for group in caches:
        tree: dict = {}
        for path, _ in _leaves(group[0]):
            leaves = []
            for layer in group:
                node = layer
                for q in path:
                    node = node[q]
                leaves.append(_numpy(node))
            _set(tree, list(path), np.stack(leaves))
        out.append(tree)
    return out


# -- training state -----------------------------------------------------------


def _map_leaves(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_numpy(cfg, tree, device=DEFAULT_DEVICE,
                           placements=None) -> TrainState:
    """The port's ``TrainState`` on ``device`` holding exactly the arrays of
    ``tree`` (a JAX ``TrainState`` with numpy leaves, or a dict of its
    four fields): the params cast to ``cfg.param_dtype``, the optimizer
    state and ``ef`` as they are, ``step`` as int32.  With ``placements``
    (``launch.sharding.named``'s ``TrainState`` of them) the state is
    built on the host, then each rank keeps its slices on the mesh's
    device (``sharding.place``) and ``device`` is not used."""
    if placements is not None:
        from .launch import sharding

        return sharding.place(train_state_from_numpy(cfg, tree, "cpu"), placements)
    dev = resolve_device(device)
    to_dev = lambda a: torch.from_numpy(np.array(_host(a))).to(dev)
    return TrainState(
        lm_params_from_numpy(cfg, _field(tree, "params"), dev),
        _map_leaves(to_dev, _field(tree, "opt_state")),
        torch.tensor(int(np.asarray(_field(tree, "step"))), dtype=torch.int32,
                     device=dev),
        _map_leaves(to_dev, _field(tree, "ef")))


def train_state_to_numpy(state: TrainState, placements=None) -> dict:
    """``state`` as a dict of the JAX ``TrainState``'s fields with numpy
    leaves (bfloat16 params as float32); with ``placements`` ``state`` is
    a rank's slices, gathered whole first (``sharding.gather``: every rank
    gets the whole tree)."""
    if placements is not None:
        from .launch import sharding

        state = sharding.gather(state, placements)
    return {"params": lm_params_to_numpy(state.params),
            "opt_state": _map_leaves(_numpy, state.opt_state),
            "step": np.asarray(int(state.step), np.int32),
            "ef": _map_leaves(_numpy, state.ef)}
