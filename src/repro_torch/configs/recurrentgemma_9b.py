"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 -- RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427; unverified].  Local attention window 2048."""
from ..models.config import ModelConfig
from .base import register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, max_seq_len=1_048_576,
        block_pattern=("rec", "rec", "attn"), lru_width=4096,
        conv1d_width=4, sliding_window=2048, tie_embeddings=True,
        norm="rmsnorm", act="geglu", rope_theta=10_000.0,
    )
