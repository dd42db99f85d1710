"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff_expert=10752
vocab=100352, MoE 16e top-4 fine-grained [hf:databricks/dbrx-base;
unverified]."""
from ..models.config import ModelConfig
from .base import register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab_size=100352, max_seq_len=32_768,
        n_experts=16, top_k=4, d_ff_expert=10752, router_aux_coef=0.0001,
        norm="layernorm", act="swiglu", rope_theta=500_000.0,
    )
