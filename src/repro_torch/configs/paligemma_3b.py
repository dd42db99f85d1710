"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 -- SigLIP + gemma backbone [arXiv:2407.07726; hf].
Vision frontend is a STUB (precomputed 256 patch embeddings prepended);
prefix-LM attention (bidirectional image+prefix)."""
from ..models.config import ModelConfig
from .base import register


@register("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216, max_seq_len=8192,
        prefix_lm=True, n_prefix_tokens=256, frontend="vision",
        tie_embeddings=True, norm="rmsnorm", act="geglu", rope_theta=10_000.0,
    )
