"""Three-term roofline model of one step, with the H100's figures (port of
``repro.roofline.analyze``).

Hardware model: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data
sheet, dense rates without sparsity:
    peak bf16 compute : 989.4 TFLOP/s
    HBM3 bandwidth    : 3.35 TB/s
    HBM capacity      : 80 GB
    NVLink 4          : 450 GB/s a direction (18 links x 25 GB/s)

Terms (seconds per step, per card):
    compute    = FLOPs_per_card / PEAK_FLOPS
    memory     = HBM_bytes_per_card / HBM_BW
    collective = collective_bytes_per_card / LINK_BW

FLOPs and bytes come from the config and the shape (``analytic_cell``, the
JAX package's arithmetic as it is: every projection's 2·m·n·k, attention
at its computed, unskipped size, train = 3 x forward plus one forward for
remat).  MODEL_FLOPS is the 6·N·D (train) / 2·N·D (inference) convention
on *active* params; MODEL_FLOPS / PEAK_FLOPS is the step's floor at the
bf16 peak, and MODEL / analytic FLOPs the useful share of the computed
work.

Collective bytes are 0 on one card.  On a mesh of several devices a
train cell carries the bytes of the port's sharded step
(``roofline.collect``, via ``launch.dryrun``); where a cell has none
(prefill and decode, whose serving is not placed on a process grid yet)
it carries ``None``, ``t_collective`` is ``None``, ``dominant`` is picked
from the terms that are known, and ``note`` says the term is missing --
missing bytes are never read as 0.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

PEAK_FLOPS = 989.4e12    # bf16 dense, H100 SXM, 700 W
HBM_BW = 3.35e12         # HBM3, H100 SXM
HBM_BYTES = 80e9         # H100 SXM
LINK_BW = 450e9          # NVLink 4, one direction: 18 links x 25 GB/s

__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "LINK_BW", "RooflineRow",
           "analytic_cell", "roofline_row", "load_cells", "markdown_table"]

_NOTES = {
    "compute": "increase per-chip useful work: larger micro-batch or fewer wasted (masked/padded) tiles",
    "memory": "cut HBM traffic: fuse vector ops, quantize caches/params, raise arithmetic intensity",
    "collective": "cut wire bytes: 2D layouts, overlap collectives with compute, compress",
}
_NO_COLLECTIVE = ("; collective term missing: this cell's collective bytes "
                  "are not known (serving is not placed on a process grid)")


def _active_params(cfg) -> int:
    """Params touched per token (MoE: shared + top_k experts only)."""
    total = cfg.n_params()
    if not cfg.n_experts:
        return total
    ffe = cfg.d_ff_expert or cfg.d_ff
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    all_expert = moe_layers * cfg.n_experts * mult * cfg.d_model * ffe
    used_expert = moe_layers * cfg.top_k * mult * cfg.d_model * ffe
    return total - all_expert + used_expert


def analytic_cell(cfg, kind: str, seq: int, batch: int, grad_accum: int = 1):
    """Exact-ish FLOPs/bytes for one step of a cell (global, all devices).

    matmul flops = 2·m·n·k summed over every projection; attention scores/
    values counted at the *computed* (not theoretical-causal) size, since
    the chunked softmax does not skip masked tiles -- the causal waste
    therefore shows up in the MODEL/analytic ratio.  Train multiplies
    forward by 3 (bwd = 2x fwd) and remat adds one extra forward of the
    layer stack.
    """
    n_active = _active_params(cfg)
    tokens = batch * seq if kind != "decode" else batch
    hd = cfg.hd

    # attention score+value flops per layer (full, unskipped causal tiles)
    if kind == "decode":
        ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        attn = 4 * batch * 1 * ctx * cfg.n_heads * hd
    else:
        ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        attn = 4 * batch * seq * ctx * cfg.n_heads * hd
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid" and cfg.block_pattern:
        n_attn_layers = sum(
            1 for i in range(cfg.n_layers)
            if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn"
        )
    if cfg.family == "ssm":
        n_attn_layers = 0
        # SSD dual form: intra-chunk quadratic + state flops
        din = cfg.ssm_expand * cfg.d_model
        q = cfg.ssm_chunk
        attn = 4 * batch * (seq if kind != "decode" else 1) * (
            q if kind != "decode" else 1
        ) * din

    fwd = 2 * n_active * tokens + attn * max(n_attn_layers, 1)
    if kind == "train":
        total = 3 * fwd + (fwd if cfg.remat else 0)  # bwd=2x fwd (+remat fwd)
    else:
        total = fwd

    # HBM bytes: params once per step (+3x for train: grad + opt read/write)
    # + caches (decode) + activations working set (coarse: 6 x hidden bytes)
    pbytes = cfg.n_params() * 2
    if kind == "train":
        # params read fwd+bwd per micro, grads written/read f32, opt state rw
        hbm = pbytes * 2 * grad_accum + cfg.n_params() * (4 + 4 + 4)
        hbm += tokens * cfg.d_model * 2 * 12 * cfg.n_layers / max(grad_accum, 1)
    elif kind == "prefill":
        hbm = pbytes + tokens * cfg.d_model * 2 * 8 * cfg.n_layers
    else:
        hbm = pbytes * 1  # every decode step streams all active params
        if cfg.family == "ssm":
            din = cfg.ssm_expand * cfg.d_model
            nh = din // cfg.ssm_headdim
            hbm += 2 * batch * cfg.n_layers * (nh * cfg.ssm_headdim * cfg.ssm_d_state) * 4
        elif cfg.use_mla:
            hbm += batch * seq * cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        else:
            ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
            kvb = 2 if cfg.kv_cache_dtype != "int8" else 1
            n_attn = max(n_attn_layers, 0)
            hbm += 2 * batch * ctx * n_attn * cfg.n_kv_heads * hd * kvb
    return {"flops": float(total), "hbm_bytes": float(hbm),
            "model_flops": float((6 if kind == "train" else 2) * n_active * tokens)}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float | None   # None: the mesh's collective bytes unknown
    dominant: str
    model_flops: float     # useful flops per card (6ND convention)
    analytic_flops: float  # computed-work model per card (incl. waste)
    hlo_flops_raw: float   # cost_analysis flops (none in the port's cells: 0)
    ratio: float           # model / analytic -- useful-compute fraction
    fits_hbm: bool | None  # None: the temporaries are unknown
    hbm_used: float
    note: str
    counted_flops: float | None = None  # the dry run's FlopCounterMode count per card

    def frac_of_roofline(self) -> float:
        """Useful-compute fraction of the step-time bound: the time the
        card would need for MODEL_FLOPS at peak, over the largest known
        roofline term (what the step costs at best)."""
        t = self.t_bound()
        t_useful = self.model_flops / PEAK_FLOPS
        return t_useful / t if t > 0 else 0.0

    def t_bound(self) -> float:
        """The largest known term: the step's least time on the card."""
        return max(t for t in (self.t_compute, self.t_memory,
                               self.t_collective) if t is not None)


def _collective_bytes(cell: dict) -> float | None:
    """Per-device collective bytes: 0 on one device, else what the cell
    says, ``None`` where it says nothing."""
    coll = cell.get("collectives")
    if isinstance(coll, dict) and coll.get("total_bytes") is not None:
        return float(coll["total_bytes"])
    if cell.get("collective_bytes_per_device") is not None:
        return float(cell["collective_bytes_per_device"])
    return 0.0 if cell["devices"] == 1 else None


def roofline_row(cell: dict, cfg) -> RooflineRow:
    chips = cell["devices"]
    kind = cell["kind"]
    ga = cell.get("grad_accum", 1)
    ana = analytic_cell(cfg, kind, cell["seq"], cell["global_batch"], ga)
    flops_chip = ana["flops"] / chips
    hbm_chip = ana["hbm_bytes"] / chips
    coll_chip = _collective_bytes(cell)

    t_c = flops_chip / PEAK_FLOPS
    t_m = hbm_chip / HBM_BW
    t_n = None if coll_chip is None else coll_chip / LINK_BW
    terms = (("compute", t_c), ("memory", t_m), ("collective", t_n))
    dom = max(((k, t) for k, t in terms if t is not None),
              key=lambda kv: kv[1])[0]
    mem = cell.get("memory_analysis") or {}
    temp = mem.get("temp_size_in_bytes", 0)
    used = (mem.get("argument_size_in_bytes", 0) + mem.get("output_size_in_bytes", 0)
            - mem.get("alias_size_in_bytes", 0) + (temp or 0))
    fits = None if temp is None else used <= HBM_BYTES
    hlo = (cell.get("cost_analysis") or {}).get("flops", 0.0)
    note = _NOTES[dom] + (_NO_COLLECTIVE if t_n is None else "")
    return RooflineRow(
        cell["arch"], cell["shape"], cell["mesh"], chips, t_c, t_m, t_n, dom,
        ana["model_flops"] / chips, flops_chip, hlo,
        ana["model_flops"] / ana["flops"] if ana["flops"] else 0.0,
        fits, used, note, cell.get("counted_flops"),
    )


def load_cells(dry_dir: str) -> list[dict]:
    out = []
    for f in sorted(os.listdir(dry_dir)):
        if f.endswith(".json") and "probe" not in f:
            with open(os.path.join(dry_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def _s(t: float | None) -> str:
    return "missing" if t is None else f"{t:.3e}"


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | roofline frac | useful/compiled | HBM GB | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        fits = "?" if r.fits_hbm is None else ("Y" if r.fits_hbm else "N")
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute:.3e} | "
            f"{r.t_memory:.3e} | {_s(r.t_collective)} | **{r.dominant}** | "
            f"{r.frac_of_roofline():.2%} | {r.ratio:.2f} | "
            f"{r.hbm_used/1e9:.1f} | {fits} |"
        )
    return hdr + "\n".join(lines) + "\n"
