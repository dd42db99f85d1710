"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 -- decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
EnCodec frontend is a STUB (precomputed frame embeddings); backbone
trains/serves over the 2048-entry codebook vocab."""
from ..models.config import ModelConfig
from .base import register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=2048, max_seq_len=32_768,
        frontend="audio", norm="layernorm", act="gelu", rope_theta=10_000.0,
    )
