"""Decoder-only transformer LM (port of the dense GQA serving half of
``repro.models.transformer.model``): ``TransformerConfig``, the model's
parameters, ``forward_hidden`` / ``prefill_logits``, and the KV-cache
decode step.

The reference stacks its layers on a leading axis and scans over them;
the port keeps one module a layer in ``dense_layers`` (an
``nn.ModuleList``), and ``interop.lm_params_from_reference`` unstacks the
reference's layers in order. The cache is one (L, B, S, Hkv, dh) tensor
for k and one for v; ``decode_step`` writes each layer's new row into
them in place and returns the same tensors, so one step never copies the
cache (at long_500k one copy is 42.9 GB).

A layer is pre-norm: RMSNorm, GQA attention, residual; RMSNorm, the
SwiGLU feed-forward silu(h w1) * (h w3) w2, residual. Products run in
``cfg.compute_dtype`` (bf16 for the published configs: one bf16 product
rounds its output to bf16, as the reference's does); attention runs in
float32 (``models/common/flash.py``; the decode step's chunks,
``attention.py``). Logits are (B, vocab_padded) float32.

MLA, MoE and MTP configs raise ``NotImplementedError`` (ROADMAP item
14c), as do ``lm_loss`` and training. ``cfg.remat``,
``sequence_parallel``, ``ce_chunk`` and the MoE / MLA / MTP fields are
kept so every config ports whole; the first three shape training and
layouts over a mesh and do nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.models.common.modules import (
    Dense,
    Embedding,
    RMSNorm,
    rope_frequencies,
    rotate_halves,
)
from repro_torch.models.recsys.models import fill_normal_
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer.attention import NEXT_ITEM


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn_type: str = "gqa"  # gqa | mla
    rope_theta: float = 10_000.0
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = -1  # -1 -> all dense (no MoE)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.0
    # MTP (DeepSeek-V3)
    mtp: bool = False
    mtp_coef: float = 0.3
    # numerics / memory
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    attn_chunk: int = 512
    ce_chunk: int = 1024
    remat: str = "full"  # full | dots | none
    sequence_parallel: bool = True

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512 (logical ids stay <
        vocab_size)."""
        return ((self.vocab_size + 511) // 512) * 512

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_dense(self) -> int:
        if not self.is_moe:
            return self.n_layers
        return max(self.n_dense_layers, 0)

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.n_dense

    def param_count(self) -> int:
        """Total parameter count, from the model's shapes on the meta device
        (nothing is allocated)."""
        return sum(p.numel() for p in Transformer(self, device="meta").parameters())

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed only)."""
        total = self.param_count()
        if not self.is_moe:
            return total
        e, fe, d = self.n_experts, self.d_ff_expert, self.d_model
        return total - self.n_moe * 3 * d * fe * e + self.n_moe * 3 * d * fe * self.top_k


def check_supported(cfg: TransformerConfig) -> None:
    """Raises for the configs whose layers the port lacks."""
    missing = [what for what, on in (("MoE", cfg.is_moe), ("MLA", cfg.attn_type == "mla"),
                                     ("MTP", cfg.mtp)) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {' / '.join(missing)} is {NEXT_ITEM}")


class DenseFFN(nn.Module):
    """``_dense_ffn_init``: ``w1`` / ``w3`` (D -> d_ff), ``w2`` (d_ff -> D)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.w1 = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.w3 = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.w2 = Dense(cfg.d_ff, cfg.d_model, **kw)

    def init_(self, generator: torch.Generator) -> "DenseFFN":
        for w in (self.w1, self.w3, self.w2):
            w.init_(generator)
        return self

    def forward(self, h):
        return self.w2(torch.nn.functional.silu(self.w1(h)) * self.w3(h))


class Layer(nn.Module):
    """``_layer_init(kind="dense")``: ``ln1``, ``ln2`` (RMSNorm), ``attn``,
    ``ffn``."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        kw = dict(eps=cfg.norm_eps, dtype=cfg.param_dtype, device=device)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        self.attn = attn.GQAttention(cfg, device)
        self.ffn = DenseFFN(cfg, device)


class Transformer(nn.Module):
    """``init_params``' parameters: ``embed`` (vocab_padded, D) table,
    ``final_norm``, ``lm_head`` (D -> vocab_padded) and ``dense_layers``.
    Built uninitialised; fill it with ``init_params`` or
    ``interop.lm_params_from_reference``."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_padded, **kw)
        self.dense_layers = nn.ModuleList(Layer(cfg, device) for _ in range(cfg.n_dense))


def init_params(generator: torch.Generator, cfg: TransformerConfig, device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` with the reference's init laws, drawn
    from ``generator`` in the reference's order: the embedding normal * 0.02,
    ``lm_head``, then each layer's wq, wk, wv, wo, w1, w3, w2 (uniform in
    +-1 / sqrt(d_in)); the norms at ones."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = Transformer(cfg, device=dev)
    fill_normal_(model.embed.table, generator, 0.02)
    model.lm_head.init_(generator)
    for layer in model.dense_layers:
        layer.attn.init_(generator)
        layer.ffn.init_(generator)
    return model


def _layer_apply(cfg: TransformerConfig, lp: Layer, x, positions):
    x = x + attn.gqa_train(lp.attn, cfg, lp.ln1(x), positions)
    return x + lp.ffn(lp.ln2(x))


def forward_hidden(model: Transformer, tokens):
    """tokens (B, S) int32 -> hidden states (B, S, D) in the compute dtype."""
    cfg = model.cfg
    x = model.embed.table[tokens.long()].to(cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in model.dense_layers:
        x = _layer_apply(cfg, lp, x, positions)
    return model.final_norm(x)


def prefill_logits(model: Transformer, tokens):
    """Full-sequence prefill -> the last position's logits (B, vocab_padded)
    float32."""
    last = forward_hidden(model, tokens)[:, -1]
    return model.lm_head(last).float()


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------
def cache_shape(cfg: TransformerConfig, batch: int, s_max: int) -> dict:
    """The cache's entries as (shape, dtype): ``k`` and ``v`` (L, B, S, Hkv,
    dh) in the compute dtype, ``pos`` a 0-d int32."""
    check_supported(cfg)
    kv = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (kv, cfg.compute_dtype), "v": (kv, cfg.compute_dtype), "pos": ((), torch.int32)}


def init_cache(cfg: TransformerConfig, batch: int, s_max: int, device="cuda") -> dict:
    """A zero cache at position 0 on ``device``."""
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dtype, device=dev)
            for k, (shape, dtype) in cache_shape(cfg, batch, s_max).items()}


def _rope_one(x, pos, theta: float):
    """RoPE at one position: x (B, H, d), pos a 0-d tensor."""
    angles = pos.float() * rope_frequencies(x.shape[-1], theta, device=x.device)  # (d / 2,)
    return rotate_halves(x, torch.cos(angles), torch.sin(angles))


def _gqa_decode_sharded(ap, cfg: TransformerConfig, h, k_cache, v_cache, pos):
    """The ``seq_axis is None`` branch: projections, RoPE at ``pos``, the
    cache write and attention, ``wo`` -> ((B, D), k_cache, v_cache)."""
    b = h.shape[0]
    hds, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _rope_one(ap.wq(h).reshape(b, hds, dh), pos, cfg.rope_theta)
    k_new = _rope_one(ap.wk(h).reshape(b, hkv, dh), pos, cfg.rope_theta)
    v_new = ap.wv(h).reshape(b, hkv, dh)
    out, k_c, v_c = attn.gqa_decode_attend(q, k_cache, v_cache, k_new, v_new, pos)
    return ap.wo(out.reshape(b, hds * dh).to(h.dtype)), k_c, v_c


def decode_step(model: Transformer, cache: dict, tokens):
    """One greedy decode step: tokens (B,) int32 at ``cache["pos"]`` ->
    (logits (B, vocab_padded) float32, the cache with ``pos`` + 1). Layer
    l's k / v rows are written into ``cache["k"][l]`` / ``cache["v"][l]`` in
    place; the returned cache holds the same tensors."""
    cfg = model.cfg
    pos = cache["pos"]
    x = model.embed.table[tokens.long()].to(cfg.compute_dtype)  # (B, D)
    for i, lp in enumerate(model.dense_layers):
        a, _, _ = _gqa_decode_sharded(lp.attn, cfg, lp.ln1(x), cache["k"][i], cache["v"][i], pos)
        x = x + a
        x = x + lp.ffn(lp.ln2(x))
    logits = model.lm_head(model.final_norm(x)).float()
    return logits, dict(cache, pos=pos + 1)
