"""Config registry + assigned input shapes (the port's own copy of
``repro.configs.base``).

Each architecture file registers its exact published config; ``get(name)``
returns it and ``get_smoke(name)`` the reduced same-family config for CPU
tests.  ``SHAPES`` are the four assigned input-shape cells; ``cells(cfg)``
enumerates the applicable (shape, kind) pairs for an arch (long_500k only
for sub-quadratic decode state: SSM, hybrid or sliding window).
"""

from __future__ import annotations

from typing import Callable

from ..models.config import ModelConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}

# (kind, seq_len, global_batch): decode_* lowers serve_step with a KV cache
# of seq_len; train lowers train_step; prefill lowers the prefill fn.
SHAPES: dict[str, tuple[str, int, int]] = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]()


def get_smoke(name: str) -> ModelConfig:
    return get(name).smoke()


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def subquadratic(cfg: ModelConfig) -> bool:
    """True if decode state is O(window)/O(1) rather than O(seq)."""
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None


def cells(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if subquadratic(cfg):
        out.append("long_500k")
    return out


def _ensure_loaded():
    # import every per-arch module exactly once
    from . import (  # noqa: F401
        granite_3_8b, qwen1_5_32b, h2o_danube_1_8b, qwen2_72b, mamba2_370m,
        deepseek_v3_671b, dbrx_132b, paligemma_3b, musicgen_large,
        recurrentgemma_9b,
    )
