"""Shared building blocks of the port's model zoo: norms, MLPs, RoPE,
embeddings and the init helper (port of ``repro.models.blocks``).

Parameters live in ``nn.Module``s whose attribute names are the JAX
package's param-tree keys (``Linear.w``/``b``, ``Norm.scale``/``bias``,
``Embed.table``), so a JAX tree maps onto ``named_parameters()`` one to one
(``convert.lm_params_from_numpy``).  Weights keep the JAX layout: a
linear's ``w`` is (d_in, d_out) and applies as ``x @ w``.  Parameters are
created with ``requires_grad=False``, so serving builds no graph; the
train step (``repro_torch.train.step``) turns gradients on for the
parameters it differentiates, for the length of its backward pass.

The arithmetic follows the JAX functions step for step (f32 statistics in
the norms, f32 RoPE angles, ``gelu`` in its tanh form as ``jax.nn.gelu``),
so the CPU tests can hold each block to the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import shard

__all__ = [
    "dtype_of", "Init", "pad_dim1", "rms_norm", "layer_norm", "Norm",
    "Linear", "MLP", "rope_freqs", "apply_rope", "Embed", "cross_entropy",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class Init:
    """Where and how parameters are drawn: ``generator`` (a
    ``torch.Generator`` on ``device``) and the param ``dtype``.  Values are
    drawn in f32 and cast, as the JAX init casts its f32 draws.  With
    ``generator=None`` tensors are left uninitialised (``torch.empty``):
    the shapes for a conversion or, on the ``meta`` device, for counting.
    ``keep``, if given, maps each drawn tensor, in the order they are
    drawn, to the part of it to keep (``model.init_params(placements=)``
    keeps a process's slice)."""

    def __init__(self, generator, device, dtype, keep=None):
        self.gen, self.device, self.dtype = generator, torch.device(device), dtype
        self.keep = keep

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        if self.keep is not None:
            t = self.keep(t)
        return nn.Parameter(t.to(self.dtype), requires_grad=False)

    def _empty(self, shape) -> nn.Parameter:
        return self._param(torch.empty(shape, device=self.device, dtype=self.dtype))

    def normal(self, shape, scale: float) -> nn.Parameter:
        if self.gen is None:
            return self._empty(shape)
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return self._param(t.mul_(scale))

    def uniform(self, shape, lo: float, hi: float) -> nn.Parameter:
        if self.gen is None:
            return self._empty(shape)
        t = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return self._param(t.mul_(hi - lo).add_(lo))

    def const(self, values: torch.Tensor) -> nn.Parameter:
        if self.gen is None:
            return self._empty(tuple(values.shape))
        return self._param(values.to(self.device))

    def ones(self, shape) -> nn.Parameter:
        return self.const(torch.ones(shape))

    def zeros(self, shape) -> nn.Parameter:
        return self.const(torch.zeros(shape))


def pad_dim1(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` zero-padded by ``n`` rows at the end of dim 1."""
    if n == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))], 1)


# -- norms ------------------------------------------------------------------


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
             whole: int | None = None):
    """RMSNorm over ``x``'s last dim.  With ``whole``, ``x`` and ``scale``
    are a rank's slice of a norm ``whole`` wide split over ``model``: the
    rank's sum of squares is added over ``model`` (``shard.model_allsum``,
    ``norm_sum``) before it divides by ``whole``."""
    dt = x.dtype
    x = x.float()
    if whole is None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        ms = shard.model_allsum(torch.sum(x * x, dim=-1, keepdim=True),
                                "norm_sum") / whole
    x = x * torch.rsqrt(ms + eps)
    return (x * scale.float()).to(dt)


def layer_norm(scale, bias, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dt)


class Norm(nn.Module):
    """``{"scale"}`` (rmsnorm) or ``{"scale", "bias"}`` (layernorm)."""

    def __init__(self, d: int, kind: str, init: Init):
        super().__init__()
        self.kind = kind
        self.scale = init.ones((d,))
        if kind == "layernorm":
            self.bias = init.zeros((d,))

    def forward(self, x):
        if self.kind == "layernorm":
            return layer_norm(self.scale, self.bias, x)
        return rms_norm(self.scale, x)


# -- linear / mlp -----------------------------------------------------------


class Linear(nn.Module):
    """``{"w": (d_in, d_out)[, "b": (d_out,)]}``; init N(0, 1/d_in) unless
    ``scale`` is given."""

    def __init__(self, d_in: int, d_out: int, init: Init, bias: bool = False,
                 scale: float | None = None):
        super().__init__()
        s = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = init.normal((d_in, d_out), s)
        if bias:
            self.b = init.zeros((d_out,))

    def forward(self, x):
        y = x @ self.w.to(x.dtype)
        if hasattr(self, "b"):
            y = y + self.b.to(x.dtype)
        return y

    def row(self, x):
        """A row-parallel application: this rank's rows of ``w`` give a
        partial product, added over ``model`` (``shard.from_model``); the
        bias, whole on every rank, is added once after the sum."""
        y = shard.from_model(x @ self.w.to(x.dtype), "tp_fwd")
        if hasattr(self, "b"):
            y = y + self.b.to(x.dtype)
        return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


class MLP(nn.Module):
    """``{"wi", "wg", "wo"}`` (swiglu / geglu) or ``{"wi", "wo"}`` (gelu).
    Given a rank's ``d_ff`` columns of ``wi``/``wg`` and rows of ``wo``
    (fewer than ``d_ff``: the train step on a ``ProcessMesh``), it runs
    them: column-parallel ``wi``/``wg`` after ``shard.to_model``,
    row-parallel ``wo``."""

    def __init__(self, d: int, d_ff: int, act: str, init: Init):
        super().__init__()
        self.act = act
        self.d_ff = d_ff
        self.wi = Linear(d, d_ff, init)
        if act in ("swiglu", "geglu"):
            self.wg = Linear(d, d_ff, init)
        self.wo = Linear(d_ff, d, init)

    def forward(self, x):
        split = self.wi.w.shape[1] < self.d_ff
        if split:
            x = shard.to_model(x)
        h = self.wi(x)
        if self.act == "swiglu":
            h = F.silu(self.wg(x)) * h
        elif self.act == "geglu":
            h = _gelu(self.wg(x)) * h
        else:
            h = _gelu(h)
        return self.wo.row(h) if split else self.wo(h)


# -- RoPE -------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); pos: (..., S) integer absolute positions."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)               # (D/2,)
    ang = pos[..., None].float() * inv                 # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- embedding / loss -------------------------------------------------------


class Embed(nn.Module):
    """``{"table": (vocab, d)}``, init N(0, 0.02^2)."""

    def __init__(self, vocab: int, d: int, init: Init):
        super().__init__()
        self.table = init.normal((vocab, d), 0.02)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL; logits (..., V) f32-upcast for the softmax; with
    ``mask`` the masked mean over ``max(sum(mask), 1)``.  On a
    ``ProcessMesh`` a rank's share of the whole batch's mean (the count is
    the whole batch's, ``shard.batch_sum``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(shard.batch_sum(torch.sum(mask)),
                                                   min=1.0)
    return torch.mean(nll) / shard.batch_shards()
