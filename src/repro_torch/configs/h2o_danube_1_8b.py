"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 -- llama+mistral mix, SWA [arXiv:2401.16818; hf]."""
from ..models.config import ModelConfig
from .base import register


@register("h2o-danube-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
        d_ff=6912, vocab_size=32000, max_seq_len=16_384,
        sliding_window=4096, norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
    )
