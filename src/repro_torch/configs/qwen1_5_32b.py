"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064 -- QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from ..models.config import ModelConfig
from .base import register


@register("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab_size=152064, max_seq_len=32_768,
        qkv_bias=True, norm="rmsnorm", act="swiglu", rope_theta=1_000_000.0,
    )
