"""Dry run of one (arch x shape x mesh) cell on the meta device: the
roofline's inputs without a card (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --mesh card --out experiments/dryrun_torch

The JAX package lowers and compiles each cell on 512 placeholder devices
and reads XLA's analyses.  The port builds the cell's params, optimizer
state, caches and batch on the ``meta`` device (shapes and dtypes, no
storage) and runs the cell's step there once, under :class:`StepCounter`
(a ``TorchDispatchMode``): every op's FLOPs by
``torch.utils.flop_counter``'s formulas (matmuls, attention, convolutions;
gathers and elementwise ops count 0), and the bytes of the storages the
step creates, live at each moment (freed when the last tensor on them
goes).  Meshes: ``single`` (16 x 16) and ``multi`` (2 x 16 x 16), the JAX
package's, and ``card``, a 1 x 1 mesh: the one H100 the port runs on.

Per cell, ``<out>/<arch>__<shape>__<mesh>.json`` with the JAX cell's keys
where they mean the same (``arch`` ... ``variant``, ``optimizer``,
``grad_accum``, ``memory_analysis``, ``collectives``) and new keys where
they do not:

* ``memory_analysis`` -- bytes per device: ``argument_size_in_bytes`` and
  ``output_size_in_bytes`` from the leaf shapes split by the validated
  specs of ``launch.sharding`` (exact); ``alias_size_in_bytes``, the
  donated inputs (train state, decode caches); ``temp_size_in_bytes``, the
  peak of live bytes the step creates less what it returns: on ``card``
  the whole step's, and on ``single``/``multi`` rank 0's (below);
* ``argument_bytes_by_part`` -- the argument bytes by input (params,
  opt_state, step, ef, batch; caches, tokens);
* ``counted_flops`` -- the counted FLOPs a device runs (a count of every
  op, where XLA's ``cost_analysis`` counts a loop body once; so not under
  ``cost_analysis``): on ``single``/``multi`` rank 0's own count, on
  ``card`` the whole step's; and ``counted_flops_total``, that times the
  devices;
* ``collectives`` -- ``{"total_bytes": 0.0}`` on ``card``; on ``single``
  and ``multi`` the bytes rank 0 receives in its step (``total_bytes``
  and ``by_call``, counted by the stand-in; equal to ``roofline.
  collect.train_step_bytes`` for a train cell and ``serve_step_bytes``
  for a prefill or decode cell), so ``roofline.analyze`` has a
  collective term there.

A cell on ``single``/``multi`` runs rank 0's step on ``meta``, over
:class:`StandInMesh`: a stand-in of a ``launch.mesh.ProcessMesh`` with
no processes, whose ``gather`` and ``all_to_all`` return what the real
ones would return on rank 0 (its shapes, new storage) and count the
bytes.  A train cell's step is the port's split train step
(``build_train_step(grad_shardings=)``); its ``sp`` and ``ep`` variants
run it with ``seq_parallel`` / ``ep_stationary`` (the state placed by
``state_specs(..., ep_stationary=)``), and ``collect`` models them.  A
prefill or decode cell's is ``models.model.prefill`` / ``decode_step``
under ``serve.engine.on_mesh``: rank 0's slices of the params
(``param_specs(..., fsdp=cfg.fsdp, ep_stationary=)``; ``nofsdp`` keeps
them off the batch axes) and of the caches (``cache_specs``, their
sequence over ``model``), its rows of the tokens, a decode step at
position ``seq - 1``; ``int8kv``, ``nofsdp``, ``sp`` (a prefill's) and
``ep`` as the JAX package's ``build_cell`` takes them.
* ``build_s``, ``run_s`` -- seconds to build the cell on ``meta`` and to
  run its step there (the JAX ``lower_s`` / ``compile_s`` have no
  counterpart).

What the count leaves out against ``roofline.analyze.analytic_cell``: the
embedding gather and elementwise work (0 FLOPs here), and the last
projection of each layer in remat's recompute (non-reentrant checkpointing
stops recomputing once the saved tensors the backward needs exist); it
counts every attention tile the chunked softmax computes, as
``analytic_cell`` does.  tests/test_torch_dryrun.py holds the band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .mesh import NocStats, _Grid

__all__ = ["StepCounter", "StandInMesh", "build_cell", "run_cell", "main",
           "MESH_KINDS"]

MESH_KINDS = ("single", "multi", "card")


def _parse_variant(variant: str) -> dict:
    """Comma-separated perf-variant flags:
      sp        -- sequence parallelism on the residual stream
      ep        -- expert-stationary MoE sharding (weights never move)
      rsgrad    -- constrain grads to param sharding (reduce-scatter)
      ga<k>     -- override gradient-accumulation factor
      int8kv    -- int8-quantized KV cache
      pipecg    -- (solver) single-reduction pipelined CG
    """
    out = {"sp": False, "ep": False, "rsgrad": False, "ga": None,
           "int8kv": False, "nofsdp": False}
    for tok in filter(None, (variant or "").split(",")):
        if tok == "sp":
            out["sp"] = True
        elif tok == "ep":
            out["ep"] = True
        elif tok == "rsgrad":
            out["rsgrad"] = True
        elif tok == "int8kv":
            out["int8kv"] = True
        elif tok == "nofsdp":
            out["nofsdp"] = True
        elif tok.startswith("ga"):
            out["ga"] = int(tok[2:])
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return out


class StepCounter(TorchDispatchMode):
    """Counts the FLOPs of every op dispatched inside it (the formulas of
    ``torch.utils.flop_counter``, without ``FlopCounterMode``'s module
    tracking, which keeps tensors alive) and the bytes of the storages
    those ops create: ``live`` now, ``peak`` the most at once.  A storage
    an op returns that one of its inputs already had (a view, an in-place
    op) is not new; a new one counts until it is freed."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count = flop_registry.get(func._overloadpacket)
        if count is None:
            # a composite op that reaches the mode whole (``matmul`` or
            # ``einsum`` under inference mode): count its decomposition
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        seen = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k, n))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out

    def _free(self, key, n):
        if self._refs.pop(key, None) is not None:
            self.live -= n


class StandInMesh(_Grid):
    """Rank ``rank`` of a ``launch.mesh.ProcessMesh`` of ``shape`` (axis
    name -> size) on ``meta``, with no processes: ``gather`` and
    ``all_to_all`` return new tensors of the shapes the real calls return
    and count the bytes this rank would receive in ``stats`` (a
    ``NocStats``), as the real calls do."""

    per_process = True

    def __init__(self, shape: dict, rank: int = 0):
        super().__init__(tuple(shape.values()), tuple(shape))
        self.rank = rank
        self.coords = tuple(int(c) for c in self._coords[rank])
        self.local, self.local_size = slice(rank, rank + 1), 1
        self.device = torch.device("meta")
        self.stats = NocStats()

    def _members(self, axes, what: str) -> int:
        self.stats.calls[what] += 1
        return self.group(self.axes(axes))[1].shape[1]

    def gather(self, xs, axes, what: str):
        p = self._members(axes, what)
        if p > 1:
            self.stats.wire_bytes[what] += (p - 1) * xs.numel() * xs.element_size()
        return xs.new_empty(xs.shape[:-1] + (p, xs.shape[-1]))

    def all_to_all(self, xs, axes, what: str):
        p = self._members(axes, what)
        if p > 1:
            self.stats.wire_bytes[what] += (p - 1) * (xs.numel() // p) * xs.element_size()
        return xs.new_empty(xs.shape)


def _meta_batch(shape: dict):
    """int32 token tensors on ``meta``, as the pipeline's numpy batches."""
    return {k: torch.empty(v, dtype=torch.int32, device="meta")
            for k, v in shape.items()}


def build_cell(arch: str, shape, mesh_kind: str, probe_layers: int | None = None,
               variant: str = "", optimizer: str | None = None):
    """Returns (run_fn, meta).  ``shape`` is a name of ``configs.SHAPES`` or
    a (kind, seq, global_batch) tuple; ``optimizer`` ("adamw" or
    "adafactor") overrides the JAX package's rule for a train cell.
    ``run_fn()`` runs the cell's step on ``meta`` once and returns (the
    step's outputs, the argument bytes by part, the output bytes, the
    alias bytes)."""
    import math

    from ..configs import SHAPES, get
    from ..models import model as M
    from ..roofline.collect import train_step_bytes
    from ..train import (adafactor, adamw, build_train_step, init_train_state,
                         warmup_cosine)
    from . import sharding as SH
    from .mesh import batch_axes

    var = _parse_variant(variant)
    cfg = get(arch)
    if var["int8kv"]:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if var["nofsdp"]:
        # weights-stationary serving: params TP-sharded only, replicated
        # over the batch axes
        cfg = cfg.replace(fsdp=False)
    if probe_layers is not None:
        # probe configs: same shapes per layer, reduced trip counts
        if cfg.family == "hybrid":
            cfg = cfg.replace(n_layers=probe_layers * len(cfg.block_pattern))
        elif cfg.first_dense_layers:
            cfg = cfg.replace(
                n_layers=cfg.first_dense_layers + probe_layers,
            )
        else:
            cfg = cfg.replace(n_layers=probe_layers)
    if isinstance(shape, str):
        kind, seq, global_batch = SHAPES[shape]
    else:
        kind, seq, global_batch = shape
        shape = f"{kind}_{global_batch}x{seq}"
    mesh = SH.MESHES[mesh_kind]
    baxes = batch_axes(mesh)
    ep = var["ep"]

    meta = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "kind": kind, "seq": seq, "global_batch": global_batch,
        "devices": mesh.size,
        "n_params": cfg.n_params(),
        "layer_groups": [list(g) for g in cfg.layer_groups()],
        "probe_layers": probe_layers,
        "variant": variant or "baseline",
    }
    params = M.init_params(cfg, None, "meta")
    p_leaves = M.param_leaves(params)
    p_bytes = SH.device_bytes(p_leaves, SH.param_specs(p_leaves, cfg.fsdp, mesh, ep),
                              mesh)

    def tok_bytes(b):
        leaves = SH.tree_leaves(b)
        return SH.device_bytes(leaves, SH.batch_specs(leaves, baxes), mesh)

    def replicated(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    if kind == "train":
        # big models use Adafactor (AdamW's f32 moments exceed memory)
        use_adafactor = cfg.n_params() > 40e9
        if optimizer is not None:
            use_adafactor = optimizer == "adafactor"
        opt = (adafactor if use_adafactor else adamw)(
            warmup_cosine(1e-4, 100, 10_000)
        )
        meta["optimizer"] = "adafactor" if use_adafactor else "adamw"
        # microbatching: keep remat-saved activations inside memory
        n_bdev = math.prod(mesh.shape[a] for a in baxes)
        per_dev = global_batch // n_bdev
        ga_target = 1
        if cfg.n_params() > 100e9:
            ga_target = min(per_dev, 16)
        elif cfg.n_params() > 20e9:
            ga_target = min(per_dev, 8)
        elif cfg.n_params() > 4e9:
            ga_target = min(per_dev, 2)
        grad_accum = max(1, ga_target)
        if var["ga"]:
            grad_accum = var["ga"]
        meta["grad_accum"] = grad_accum
        state = init_train_state(params, opt)
        st_specs = SH.state_specs(state, fsdp=cfg.fsdp, mesh=mesh,
                                  ep_stationary=ep)
        o_leaves = SH.tree_leaves(state.opt_state)
        parts = {"params": p_bytes,
                 "opt_state": SH.device_bytes(o_leaves, st_specs.opt_state, mesh),
                 "step": state.step.element_size(), "ef": 0}
        batch = _meta_batch({"tokens": (global_batch, seq),
                             "labels": (global_batch, seq)})
        parts["batch"] = tok_bytes(batch)
        alias = parts["params"] + parts["opt_state"] + parts["step"]
        if mesh.size == 1:
            step_fn = build_train_step(cfg, opt, grad_accum=grad_accum, donate=True)

            def run():
                st, metrics = step_fn(state, batch)
                out_b = alias + replicated(metrics.values())
                return (st, metrics), parts, out_b, alias
            return run, meta
        # rank 0's step on a stand-in of the process grid, its state cut to
        # its slices as launch.train.placed_state builds it
        rank = StandInMesh(mesh.shape)
        pls = SH.named(rank, st_specs, state)
        local = init_train_state(M.init_params(cfg, None, "meta",
                                               placements=pls.params), opt)
        opts = {"seq_parallel": var["sp"], "ep_stationary": ep}
        step_fn = build_train_step(cfg, opt, grad_accum=grad_accum,
                                   grad_shardings=pls.params, donate=True, **opts)
        want = train_step_bytes(cfg, state, mesh, st_specs, grad_accum,
                                batch=(global_batch, seq), **opts)
        want.pop("total_bytes")
        meta["rank_step"] = True

        def run():
            rank.stats.reset()
            st, metrics = step_fn(local, batch)
            by_call = {k: v for k, v in rank.stats.wire_bytes.items() if v}
            if by_call != want:
                raise RuntimeError(f"{arch} {shape} on {mesh_kind}: rank 0 "
                                   f"received {by_call}, collect models {want}")
            meta["collectives"] = {"total_bytes": float(sum(by_call.values())),
                                   "by_call": by_call}
            out_b = alias + replicated(metrics.values())
            return (st, metrics), parts, out_b, alias
        return run, meta

    c_leaves = SH.cache_leaves(M.init_caches(cfg, global_batch, seq, device="meta"))
    c_specs = SH.cache_specs(c_leaves, baxes, cfg.seq_shard_decode)
    c_bytes = SH.device_bytes(c_leaves, c_specs, mesh)
    tokens = _meta_batch({"tokens": (global_batch, seq if kind == "prefill" else 1)})[
        "tokens"]
    if kind == "prefill":
        parts, alias = {"params": p_bytes, "tokens": tok_bytes({"tokens": tokens})}, 0
    else:
        parts = {"params": p_bytes, "caches": c_bytes,
                 "tokens": tok_bytes({"tokens": tokens}), "pos": 4}
        alias = c_bytes
    serve = None
    if mesh.size > 1:
        # rank 0's step on a stand-in of the process grid: its slices of
        # the params and caches, its rows of the tokens
        from ..roofline.collect import serve_step_bytes
        from ..serve.engine import on_mesh

        rank = StandInMesh(mesh.shape)
        pls = SH.named(rank, SH.param_specs(params, cfg.fsdp, mesh, ep), params)
        c_pls = SH.named(rank, c_specs, c_leaves)
        want = serve_step_bytes(cfg, params, mesh, kind, global_batch, seq,
                                max_len=seq, seq_parallel=var["sp"],
                                ep_stationary=ep)
        want.pop("total_bytes")
        params = M.init_params(cfg, None, "meta", placements=pls)
        tokens = tokens[:SH.Placement(rank, (baxes, None), tokens.shape).local_shape[0]]
        serve = lambda: on_mesh(params, cfg, pls, c_pls, seq,
                                seq_parallel=var["sp"], ep_stationary=ep)
        meta["rank_step"] = True
    caches = None if kind == "prefill" else M.init_caches(
        cfg, global_batch, seq, device="meta",
        placements=None if serve is None else c_pls)

    def step():
        if kind == "prefill":
            logits, new, _ = M.prefill(params, cfg, tokens=tokens.long(), max_len=seq)
        else:
            logits, new = M.decode_step(params, cfg, caches, tokens.long(), seq - 1)
        return logits, new

    def run():
        with torch.inference_mode():
            if serve is None:
                logits, new = step()
            else:
                rank.stats.reset()
                with serve():
                    logits, new = step()
                by_call = {k: v for k, v in rank.stats.wire_bytes.items() if v}
                if by_call != want:
                    raise RuntimeError(f"{arch} {shape} on {mesh_kind}: rank 0 "
                                       f"received {by_call}, collect models {want}")
                meta["collectives"] = {"total_bytes": float(sum(by_call.values())),
                                       "by_call": by_call}
        return (logits, new), parts, replicated([logits]) + c_bytes, alias
    return run, meta


def run_cell(arch: str, shape, mesh_kind: str, out_dir: str = "",
             probe_layers: int | None = None, variant: str = "",
             optimizer: str | None = None) -> dict:
    """Build the cell on ``meta``, run its step once under
    :class:`StepCounter`, and return (and with ``out_dir`` write) its
    JSON dict (module docstring)."""
    from ..obs import clock as _clock

    t0 = _clock.now()
    run_fn, meta = build_cell(arch, shape, mesh_kind, probe_layers, variant,
                              optimizer)
    t1 = _clock.now()
    counter = StepCounter()
    with counter:
        outs, parts, out_b, alias = run_fn()
        returned = counter.live       # new storages the step hands back
    del outs
    t2 = _clock.now()

    devices = meta["devices"]
    card = mesh_kind == "card"
    rank_step = meta.pop("rank_step", False)
    result = dict(meta)
    result.update(
        build_s=round(t1 - t0, 2),
        run_s=round(t2 - t1, 2),
        memory_analysis={
            "argument_size_in_bytes": sum(parts.values()),
            "output_size_in_bytes": out_b,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": (counter.peak - returned)
            if card or rank_step else None,
        },
        argument_bytes_by_part=parts,
        counted_flops=counter.flops if rank_step else counter.flops / devices,
        counted_flops_total=counter.flops * devices if rank_step else counter.flops,
        collectives={"total_bytes": 0.0} if card else meta.get("collectives"),
    )
    suffix = f"__probe{probe_layers}" if probe_layers is not None else ""
    if variant:
        suffix += f"__{variant.replace(',', '+')}"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir,
            f"{arch.replace('/', '_')}__{result['shape']}__{mesh_kind}{suffix}.json"
        )
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        result["_path"] = path
    return result


def main(argv=None):
    from ..configs import SHAPES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=MESH_KINDS)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--probe-layers", type=int, default=None,
                    help="override per-group layer count (roofline probes)")
    ap.add_argument("--variant", default="",
                    help="comma-separated perf flags: sp,ep,rsgrad,ga<k>,int8kv,nofsdp")
    args = ap.parse_args(argv)

    res = run_cell(args.arch, args.shape, args.mesh, args.out,
                   args.probe_layers, args.variant)
    slim = {k: v for k, v in res.items() if k != "collectives"}
    slim["collective_bytes_per_device"] = (
        None if res["collectives"] is None else res["collectives"]["total_bytes"])
    print(json.dumps(slim, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
