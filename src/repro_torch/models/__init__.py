"""LM architecture zoo of the port: PyTorch modules for the 10 assigned
architectures (port of ``repro.models``).

config      -- ModelConfig + layer grouping + exact param counts
blocks      -- norms, MLPs, RoPE, embeddings, the init helper
attention   -- GQA/MQA/SWA/prefix-LM flash attention, MLA, KV caches
moe         -- token-choice top-k MoE with capacity dispatch
ssm         -- Mamba-2 SSD chunked scan
rglru       -- RG-LRU recurrent block (RecurrentGemma)
model       -- init/forward/prefill/decode over the layer groups
frontends   -- vision/audio stub frontends (precomputed embeddings)
shard       -- activation-sharding hints (the identity on one card)
"""

from .config import ModelConfig  # noqa: F401
