"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 -- GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from ..models.config import ModelConfig
from .base import register


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12800, vocab_size=49155, max_seq_len=131_072,
        norm="rmsnorm", act="swiglu", rope_theta=10_000_000.0,
    )
