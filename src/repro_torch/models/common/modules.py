"""Shared building blocks (port of ``repro.models.common.modules``).

Each reference ``*_init`` / ``*_apply`` pair is an ``nn.Module``:

- ``Dense``: ``x @ w``, no bias (``dense_init``); weights uniform in
  [-1/sqrt(d_in), 1/sqrt(d_in)].
- ``MLP``: ``nn.Linear`` layers (``mlp_init`` / ``mlp_apply``) with ``act``
  between them and, with ``final_act``, after the last; ``bias=False``
  drops the biases. Weights as ``Dense``, biases zero.
- ``RMSNorm`` (eps 1e-6) and ``LayerNorm`` (eps 1e-5): computed in
  float32, the variance in two passes as the reference takes it (mean of
  the squares; mean of the centred squares), cast back to the input's type.
- ``Embedding``: a (vocab, d) table drawn normal * 0.02.

``init_`` draws the reference's law from an explicit generator. The
numbers differ from the reference's threefry draws;
``interop.recsys_params_from_reference`` carries the reference's own
weights across. ``nn.Linear`` keeps its weight as (out, in), the
transpose of the reference's ``w``. ``Dense``, the norms and
``Embedding`` take a ``dtype`` (float32 by default; the LM keeps bf16).

RoPE (``rope_frequencies``, ``apply_rope``) turns pairs of the two
halves of the last axis by angles computed in float32, as the reference
does. ``chunked_attention`` is the online-softmax attention of
``models/common/flash.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from repro_torch.common.device import resolve_device


def _uniform_(weight, generator: torch.Generator, d_in: int):
    scale = 1.0 / math.sqrt(d_in)
    return weight.uniform_(-scale, scale, generator=generator)


class Dense(nn.Module):
    """``dense_apply``: ``x @ w`` with no bias; ``weight`` is (d_out, d_in)."""

    def __init__(self, d_in: int, d_out: int, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((d_out, d_in), dtype=dtype,
                                               device=resolve_device(device)))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Dense":
        _uniform_(self.weight, generator, self.weight.shape[1])
        return self

    def forward(self, x):
        return x @ self.weight.T.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, dims: Sequence[int], *, final_act: bool = False, bias: bool = True,
                 act: Callable = torch.relu, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        # skip_init: no draw from torch's global generator; init_ fills them.
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, bias=bias, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        self.final_act = final_act
        self.act = act

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "MLP":
        for layer in self.layers:
            _uniform_(layer.weight, generator, layer.in_features)
            if layer.bias is not None:
                layer.bias.zero_()
        return self

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.final_act:
                x = self.act(x)
        return x


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-6, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=resolve_device(device)))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-5, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros((d,), dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        centred = x32 - mu
        var = (centred * centred).mean(-1, keepdim=True)
        y = centred * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class Embedding(nn.Module):
    """``embedding_apply``: rows of ``table`` (vocab, d) at ``ids``."""

    def __init__(self, vocab: int, d: int, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.table = nn.Parameter(torch.empty((vocab, d), dtype=dtype,
                                              device=resolve_device(device)))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Embedding":
        self.table.normal_(generator=generator).mul_(0.02)
        return self

    def forward(self, ids):
        return self.table[ids.long()]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(d_rot: int, theta: float = 10_000.0, device="cuda"):
    """(d_rot / 2,) float32 inverse frequencies 1 / theta^(2i / d_rot)."""
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=resolve_device(device)) / d_rot
    return 1.0 / (theta ** exps)


def rotate_halves(x, cos, sin):
    """[x1 cos - x2 sin, x2 cos + x1 sin] over the two halves of the last
    axis, in float32, cast back to ``x``'s dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, d_rot); positions: (S,) -- head axis required."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = (positions[:, None].float() * freqs)[:, None, :]  # (S, 1, d_rot / 2)
    return rotate_halves(x, torch.cos(angles), torch.sin(angles))


# ---------------------------------------------------------------------------
# Memory-bounded attention: the online-softmax flash attention with its
# FA2 backward (models/common/flash.py).
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0, chunk: int = 512,
                      logit_soft_cap: float = 0.0):
    """q: (B, Sq, H, dh), k / v: (B, Skv, Hkv, dh[v]) -> (B, Sq, H, dhv).

    GQA-aware (H % Hkv == 0) online-softmax attention with a
    FlashAttention-2 backward; never materialises (Sq, Skv) scores. The
    reference's ``mi`` only constrains layouts, which one controller does
    not have."""
    from repro_torch.models.common.flash import AttnMeta, flash_attention

    meta = AttnMeta(causal=causal, q_offset=int(q_offset), chunk=chunk,
                    soft_cap=logit_soft_cap)
    return flash_attention(q, k, v, meta)
