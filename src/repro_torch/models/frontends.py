"""Modality frontend stubs (port of ``repro.models.frontends``): the
[vlm]/[audio] architectures are backbone-only and take precomputed
patch/frame embeddings.

``Frontend`` is a linear projection from a precomputed feature space into
d_model -- the interface of SigLIP (paligemma) and EnCodec frames
(musicgen) without the encoders.  Its output is what ``forward`` and
``prefill`` take as ``prefix_embeds``.
"""

from __future__ import annotations

from torch import nn

from .blocks import Init, Linear

__all__ = ["Frontend", "init_frontend", "apply_frontend", "SIGLIP_DIM",
           "ENCODEC_DIM"]

SIGLIP_DIM = 1152    # SigLIP-So400m feature width (paligemma-3b)
ENCODEC_DIM = 128    # EnCodec latent frame width (musicgen)


class Frontend(nn.Module):
    """``{"proj"}`` for a vision or audio config, ``{}`` otherwise."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        dim = {"vision": SIGLIP_DIM, "audio": ENCODEC_DIM}.get(cfg.frontend)
        if dim is not None:
            self.proj = Linear(dim, cfg.d_model, init)


def init_frontend(cfg, init: Init) -> Frontend:
    return Frontend(cfg, init)


def apply_frontend(p: Frontend, feats, cfg):
    """feats: (B, n_prefix_tokens, feat_dim) precomputed embeddings; None
    for a config without a frontend."""
    del cfg
    if not hasattr(p, "proj"):
        return None
    return p.proj(feats)
