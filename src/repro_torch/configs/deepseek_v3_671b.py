"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff_expert=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MLA, MTP
[arXiv:2412.19437; hf].  Dense first-3-layer d_ff = 18432 (paper §4)."""
from ..models.config import ModelConfig
from .base import register


@register("deepseek-v3-671b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab_size=129280, max_seq_len=131_072,
        n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
        first_dense_layers=3, router_aux_coef=0.0001,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp_depth=1, norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
    )
