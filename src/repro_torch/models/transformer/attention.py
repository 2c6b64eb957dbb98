"""GQA attention (port of the GQA half of
``repro.models.transformer.attention``): the prefill path through the
chunked flash attention, and one decode step over a KV cache with an
online softmax over 8,192-row cache chunks.

The decode step writes the new token's k / v row into the cache in
place (the reference donates its cache and writes with
``dynamic_update_slice``), then scores every cache chunk. The reference
multiplies the cache's bf16 operands with a float32 result
(``preferred_element_type``); ``torch.matmul`` on bf16 rounds its output
to bf16, so each chunk's slice is upcast to float32 first, which is exact
(the product of two bf16 values is exact in float32) and never upcasts the
whole cache. The probabilities are rounded to the cache's dtype before the
value product, as the reference rounds them.

Only the one-controller case is ported: ``seq_axis=None`` and
``shard_idx=0``. The sequence-sharded cache over a device mesh, with its
log-sum-exp combination across shards, and MLA are ROADMAP item 14c.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.common.modules import Dense, apply_rope, chunked_attention

DECODE_CHUNK = 8192  # cache rows a chunk of the decode softmax: bounds the f32 score slice
NEXT_ITEM = "ROADMAP item 14c"


class GQAttention(nn.Module):
    """``gqa_init``'s parameters: ``wq`` (D -> H dh), ``wk`` / ``wv`` (D ->
    Hkv dh), ``wo`` (H dh -> D), no biases, in ``cfg.param_dtype``."""

    def __init__(self, cfg, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wq = Dense(d, h * dh, **kw)
        self.wk = Dense(d, hkv * dh, **kw)
        self.wv = Dense(d, hkv * dh, **kw)
        self.wo = Dense(h * dh, d, **kw)

    def init_(self, generator: torch.Generator) -> "GQAttention":
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.init_(generator)
        return self


def gqa_qkv(ap: GQAttention, cfg, x, positions):
    """x (B, S, D) -> q (B, S, H, dh), k / v (B, S, Hkv, dh), RoPE applied to
    q and k."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ap.wq(x).reshape(b, s, h, dh)
    k = ap.wk(x).reshape(b, s, hkv, dh)
    v = ap.wv(x).reshape(b, s, hkv, dh)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_train(ap: GQAttention, cfg, x, positions):
    """The prefill / training path: causal chunked attention with chunk
    ``cfg.attn_chunk``, then ``wo`` -> (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(ap, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return ap.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim))


def _lse_combine(m, lsum, o, axis: Optional[str]):
    """The partial softmax (m, lsum, o) -> the attention output. With no
    shard axis this is o / max(lsum, 1e-30)."""
    if axis is not None:
        raise NotImplementedError(f"combining a sequence-sharded cache is {NEXT_ITEM}")
    return o / lsum.clamp_min(1e-30)[..., None]


def _chunked_partial_softmax(score_fn, value_fn, s_local: int, init_o_shape, device):
    """Online softmax over cache chunks -> the partial (m, lsum, o).

    score_fn(start, size) -> (..., size) float32 scores of that cache slice,
    -inf where masked; value_fn(p, start, size) -> (..., d) the p-weighted
    value contraction. The score slice stays (..., chunk) instead of
    (..., s_local)."""
    chunk = min(DECODE_CHUNK, s_local)
    if s_local % chunk:
        raise ValueError(f"cache length {s_local} is not a multiple of {chunk}")
    m = torch.full(init_o_shape[:-1], -math.inf, dtype=torch.float32, device=device)
    lsum = torch.zeros(init_o_shape[:-1], dtype=torch.float32, device=device)
    o = torch.zeros(init_o_shape, dtype=torch.float32, device=device)
    for start in range(0, s_local, chunk):
        s = score_fn(start, chunk)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + value_fn(p, start, chunk)
        m = m_new
    return m, lsum, o


def gqa_decode_attend(q, k_cache, v_cache, k_new, v_new, pos, *, seq_axis: Optional[str] = None,
                      shard_idx: int = 0):
    """One decode step on a cache. q (B, H, dh): the current token's queries;
    k_cache / v_cache (B, S, Hkv, dh); k_new / v_new (B, Hkv, dh); pos: a
    0-d int tensor, the position being written. Writes k_new / v_new into
    the caches at ``pos`` in place (no write where ``pos`` lies outside the
    cache) and attends over positions <= pos -> (out (B, H, dh) float32,
    k_cache, v_cache)."""
    if seq_axis is not None or shard_idx != 0:
        raise NotImplementedError(f"the sequence-sharded decode is {NEXT_ITEM}")
    b, s_local, hkv, dh = k_cache.shape
    h = q.shape[1]
    g = h // hkv
    local_pos = pos - shard_idx * s_local
    in_range = (local_pos >= 0) & (local_pos < s_local)
    row = local_pos.clamp(0, s_local - 1).reshape(1).long()
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        keep = cache.index_select(1, row)
        cache.index_copy_(1, row, torch.where(in_range, new[:, None].to(cache.dtype), keep))

    # q in the cache's dtype, as the reference casts it before the product
    qg = q.reshape(b, hkv, g, dh).float().to(k_cache.dtype).float()
    scale = 1.0 / math.sqrt(dh)
    seen = shard_idx * s_local + torch.arange(s_local, device=q.device) <= pos

    def score_fn(start, size):
        kc = k_cache[:, start : start + size].permute(0, 2, 3, 1)  # (B, Hkv, dh, size)
        s = torch.matmul(qg, kc.to(torch.float32, memory_format=torch.contiguous_format))
        s = s * scale
        return torch.where(seen[start : start + size], s, -math.inf)

    def value_fn(p, start, size):
        vc = v_cache[:, start : start + size].permute(0, 2, 1, 3)  # (B, Hkv, size, dh)
        vc = vc.to(torch.float32, memory_format=torch.contiguous_format)
        return torch.matmul(p.to(v_cache.dtype).float(), vc)

    m, lsum, o = _chunked_partial_softmax(score_fn, value_fn, s_local, (b, hkv, g, dh),
                                          q.device)
    out = _lse_combine(m, lsum, o, seq_axis)  # (B, Hkv, G, dh)
    return out.reshape(b, h, dh), k_cache, v_cache
