"""Model configuration for the LM architecture zoo (the port's own copy of
``repro.models.config``, field for field, with the same exact parameter
count).

One ``ModelConfig`` describes any of the 10 assigned architectures; family-
specific blocks read their own sub-fields.  ``layer_groups()`` returns the
homogeneous, contiguous layer groups the stack runs over (e.g. deepseek =
3 dense + 58 MoE layers; recurrentgemma = 12 x [rec, rec, attn] units + a
[rec, rec] tail).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 256
    max_seq_len: int = 8192

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None     # SWA width (h2o-danube, rg local)
    prefix_lm: bool = False               # bidirectional prefix (paligemma)
    logit_softcap: float | None = None

    # norms / activations
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | geglu | gelu
    tie_embeddings: bool = False

    # --- MoE (deepseek-v3, dbrx) ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0    # deepseek: first k layers stay dense
    router_aux_coef: float = 0.0
    moe_capacity_factor: float = 1.3

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MTP (deepseek-v3) ---
    mtp_depth: int = 0             # extra next^2-token prediction heads

    # --- SSM (mamba2) ---
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256

    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv1d_width: int = 4

    # --- modality frontend stub ---
    frontend: str | None = None    # None | "vision" | "audio"
    n_prefix_tokens: int = 0       # vision patches / audio frames prepended

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "int8" enables quantized KV cache

    # distribution knobs (read by launch/sharding)
    fsdp: bool = True              # shard params over the data axis too
    remat: bool = True             # per-layer activation checkpointing
    seq_shard_decode: bool = True  # shard decode KV cache on seq over model

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_groups(self) -> list[tuple[str, int]]:
        """[(block_kind, count), ...] contiguous homogeneous groups."""
        if self.family == "ssm":
            return [("ssm", self.n_layers)]
        if self.family == "hybrid" and self.block_pattern:
            p = len(self.block_pattern)
            units, tail = divmod(self.n_layers, p)
            out: list[tuple[str, int]] = []
            if units:
                out.append(("unit:" + ",".join(self.block_pattern), units))
            for k in range(tail):
                out.append((self.block_pattern[k], 1))
            return out
        if self.family == "moe" or self.n_experts:
            out = []
            if self.first_dense_layers:
                out.append(("attn_mlp", self.first_dense_layers))
            out.append(("attn_moe", self.n_layers - self.first_dense_layers))
            return out
        return [("attn_mlp", self.n_layers)]

    def n_params(self) -> int:
        """Exact parameter count (embedding + stacked blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += d * v                 # head
        total += d                         # final norm
        for kind, count in self.layer_groups():
            total += count * self._block_params(kind)
        if self.mtp_depth:
            total += self.mtp_depth * (self._block_params("attn_mlp") + 2 * d * d)
        return total

    def _block_params(self, kind: str) -> int:
        d, ff = self.d_model, self.d_ff
        hd = self.hd
        if kind.startswith("unit:"):
            return sum(self._block_params(k) for k in kind[5:].split(","))
        if kind == "ssm":
            din = self.ssm_expand * d
            nheads = din // self.ssm_headdim
            # in_proj (z, x, B, C, dt) + conv + out_proj + norms (mamba2 SSD)
            conv_dim = din + 2 * self.ssm_d_state
            return (
                d * (2 * din + 2 * self.ssm_d_state + nheads)
                + conv_dim * self.ssm_d_conv
                + 2 * nheads           # A_log, D
                + din * d
                + 2 * d                # norms
            )
        if kind == "rec":
            w = self.lru_width or d
            return (
                2 * d                       # norm
                + d * w + w * d             # in/out proj
                + w * self.conv1d_width     # conv1d
                + 2 * w * w // 1            # RG-LRU input & recurrence gates
                + w                         # recurrence param a
                + self._mlp_params()
            )
        attn = 0
        if kind.startswith("attn"):
            if self.use_mla:
                qr, kr = self.q_lora_rank, self.kv_lora_rank
                nope, rope, vd = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
                h = self.n_heads
                attn = (
                    d * qr + qr * h * (nope + rope)        # q down/up
                    + d * (kr + rope)                      # kv down + shared rope
                    + kr * h * (nope + vd)                 # kv up
                    + h * vd * d                           # o proj
                    + qr + kr                              # lora norms
                )
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
                if self.qkv_bias:
                    attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        blk = attn + 2 * d  # two norms
        if kind == "attn_mlp":
            blk += self._mlp_params()
        elif kind == "attn_moe":
            ffe = self.d_ff_expert or ff
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            blk += self.n_experts * mult * d * ffe
            blk += self.n_shared_experts * mult * d * ffe
            blk += d * self.n_experts  # router
        return blk

    def _mlp_params(self) -> int:
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.block_pattern else len(self.block_pattern) + 1),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
            max_seq_len=128,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=2, d_ff_expert=64,
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16)
        if self.family == "ssm":
            kw.update(ssm_d_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.lru_width:
            kw.update(lru_width=64)
        if self.sliding_window:
            kw.update(sliding_window=32)
        if self.n_prefix_tokens:
            kw.update(n_prefix_tokens=8)
        if self.mtp_depth:
            kw.update(mtp_depth=1)
        return self.replace(**kw)
