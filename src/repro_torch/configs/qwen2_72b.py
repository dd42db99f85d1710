"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- GQA, QKV bias [arXiv:2407.10671; hf]."""
from ..models.config import ModelConfig
from .base import register


@register("qwen2-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064, max_seq_len=131_072,
        qkv_bias=True, norm="rmsnorm", act="swiglu", rope_theta=1_000_000.0,
    )
