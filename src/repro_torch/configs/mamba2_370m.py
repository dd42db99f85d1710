"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 -- SSD state-space duality [arXiv:2405.21060; unverified]."""
from ..models.config import ModelConfig
from .base import register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=50280, max_seq_len=1_048_576, tie_embeddings=True,
        ssm_d_state=128, ssm_d_conv=4, ssm_expand=2, ssm_headdim=64,
        ssm_chunk=256, norm="rmsnorm",
    )
