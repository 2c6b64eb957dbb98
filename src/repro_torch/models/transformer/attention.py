"""GQA and MLA attention (port of ``repro.models.transformer.attention``):
each has a prefill path through the chunked flash attention and a decode
step over a sequence-sharded KV cache, with an online softmax over
8,192-row cache chunks and a log-sum-exp combination across the shards.

The decode step writes the new token's row into the cache in place (the
reference donates its cache and writes with ``dynamic_update_slice``),
then scores every cache chunk. The reference multiplies the cache's bf16
operands with a float32 result (``preferred_element_type``);
``torch.matmul`` on bf16 rounds its output to bf16, so each chunk's slice
is upcast to float32 first, which is exact (the product of two bf16 values
is exact in float32) and never upcasts the whole cache. The probabilities
are rounded to the cache's dtype before the value product, as the
reference rounds them.

A cache argument of the decode step is one tensor (the whole sequence) or
a sequence of tensors, the sequence shards in order, each on its own
device (the reference's ``shard_map`` over ``seq_axis``: shard i holds
positions [i * S_local, (i + 1) * S_local)). Every shard computes its
partial softmax (m, lsum, o) on its device; only the shard whose range
holds ``pos`` writes the new row. ``_lse_combine`` then moves the
partials to the first shard's device and combines them there: m_g the
max over the shards, lsum and o each corrected and summed in shard order
0..n-1 (the port's collective rule, ``distributed/meshinfo.py``). The
reference's ``seq_axis`` is the length of that sequence.

MLA (DeepSeek-V2 / V3 multi-head latent attention) caches one latent row
[c_kv ; RoPE(k_rope)] (r + dr values, no head axis) a token. Prefill
expands it (``mla_train``: k = [k_nope ; k_rope broadcast over the
heads], v of width d_v); decode absorbs W_uk into the query and applies
W_uv after attention (``mla_decode_attend``), both in float32 as the
reference does. ``wkv_b``'s (r, H (dn + dv)) matrix is the transpose of
the port's ``Dense`` weight.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
from torch import nn

from repro_torch.models.common.modules import Dense, RMSNorm, apply_rope, chunked_attention
from repro_torch.roofline import collectives

DECODE_CHUNK = 8192  # cache rows a chunk of the decode softmax: bounds the f32 score slice

Cache = Union[torch.Tensor, Sequence[torch.Tensor]]


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


def gqa_specs(cfg, mi) -> dict:
    """The reference's layout of a GQA block over ``mi``: q / k / v (in, out)
    split (data, model), o (model, data)."""
    fs, tp = mi.fsdp_axis, mi.tp_axis
    return {"wq": {"w": (fs, tp)}, "wk": {"w": (fs, tp)}, "wv": {"w": (fs, tp)},
            "wo": {"w": (tp, fs)}}


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


# ---------------------------------------------------------------------------
# Split-KV decode with the LSE combine (shared by GQA and MLA)
# ---------------------------------------------------------------------------
def _shards(cache: Cache) -> list:
    return [cache] if isinstance(cache, torch.Tensor) else list(cache)


def _lse_combine(parts):
    """The partial softmaxes (m, lsum, o) of the sequence shards, in shard
    order -> the attention output on the first shard's device. One shard:
    o / max(lsum, 1e-30)."""
    if len(parts) == 1:
        _, lsum, o = parts[0]
        return o / lsum.clamp_min(1e-30)[..., None]
    dev = parts[0][0].device
    ms = [m.to(dev) for m, _, _ in parts]
    m_g = ms[0]
    for m in ms[1:]:
        m_g = torch.maximum(m_g, m)
    m_safe = torch.where(torch.isfinite(m_g), m_g, 0.0)
    l_g = o_g = None
    for m, (_, lsum, o) in zip(ms, parts):
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        lc, oc = lsum.to(dev) * corr, o.to(dev) * corr[..., None]
        l_g = lc if l_g is None else l_g + lc
        o_g = oc if o_g is None else o_g + oc
    collectives.record("all-reduce", m_g, l_g, o_g)  # one pmax, two psums
    return o_g / l_g.clamp_min(1e-30)[..., None]


def _chunked_partial_softmax(chunk_fn, s_local: int, init_o_shape, device):
    """Online softmax over cache chunks -> the partial (m, lsum, o).

    chunk_fn(start, size) -> (s, value_fn): s the (..., size) float32
    scores of that cache slice, -inf where masked, and value_fn(p) -> (...,
    d) the p-weighted value contraction of the same slice. The score slice
    stays (..., chunk) instead of (..., s_local)."""
    chunk = min(DECODE_CHUNK, s_local)
    if s_local % chunk:
        raise ValueError(f"cache length {s_local} is not a multiple of {chunk}")
    m = torch.full(init_o_shape[:-1], -math.inf, dtype=torch.float32, device=device)
    lsum = torch.zeros(init_o_shape[:-1], dtype=torch.float32, device=device)
    o = torch.zeros(init_o_shape, dtype=torch.float32, device=device)
    for start in range(0, s_local, chunk):
        s, value_fn = chunk_fn(start, chunk)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + value_fn(p)
        m = m_new
    return m, lsum, o


def _write_row(cache, new, local_pos) -> None:
    """Writes ``new`` (B, ...) into row ``local_pos`` of ``cache`` (B,
    S_local, ...) in place; no write where ``local_pos`` lies outside the
    shard. ``local_pos`` is a 0-d tensor: no host sync."""
    s_local = cache.shape[1]
    in_range = (local_pos >= 0) & (local_pos < s_local)
    row = local_pos.clamp(0, s_local - 1).reshape(1).long()
    keep = cache.index_select(1, row)
    cache.index_copy_(1, row, torch.where(in_range, new[:, None].to(cache.dtype), keep))


def _seen(pos, shard_idx: int, s_local: int):
    """(S_local,) bool: the shard's global positions <= pos."""
    return shard_idx * s_local + torch.arange(s_local, device=pos.device) <= pos


def _gqa_partial(q, k_cache, v_cache, k_new, v_new, pos, shard_idx: int):
    """One sequence shard's write and partial softmax (m, lsum, o), each
    (B, Hkv, G[, dh]) float32."""
    b, s_local, hkv, dh = k_cache.shape
    g = q.shape[1] // hkv
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        _write_row(cache, new, pos - shard_idx * s_local)
    # q in the cache's dtype, as the reference casts it before the product
    qg = q.reshape(b, hkv, g, dh).float().to(k_cache.dtype).float()
    scale = 1.0 / math.sqrt(dh)
    seen = _seen(pos, shard_idx, s_local)

    def chunk_fn(start, size):
        kc = k_cache[:, start : start + size].permute(0, 2, 3, 1)  # (B, Hkv, dh, size)
        s = torch.matmul(qg, kc.to(torch.float32, memory_format=torch.contiguous_format))
        s = torch.where(seen[start : start + size], s * scale, -math.inf)

        def value_fn(p):
            vc = v_cache[:, start : start + size].permute(0, 2, 1, 3)  # (B, Hkv, size, dh)
            vc = vc.to(torch.float32, memory_format=torch.contiguous_format)
            return torch.matmul(p.to(v_cache.dtype).float(), vc)

        return s, value_fn

    return _chunked_partial_softmax(chunk_fn, s_local, (b, hkv, g, dh), q.device)


def gqa_decode_attend(q, k_cache: Cache, v_cache: Cache, k_new, v_new, pos):
    """One decode step on a cache. q (B, H, dh): the current token's queries;
    k_cache / v_cache (B, S, Hkv, dh), or their sequence shards (B,
    S_local, Hkv, dh) in order; k_new / v_new (B, Hkv, dh); pos: a 0-d int
    tensor, the global position being written. Writes k_new / v_new at
    ``pos`` in place (in the shard that holds it) and attends over
    positions <= pos -> (out (B, H, dh) float32 on the first shard's
    device, k_cache, v_cache)."""
    b, h, dh = q.shape
    parts = []
    for i, (kc, vc) in enumerate(zip(_shards(k_cache), _shards(v_cache))):
        dev = kc.device
        parts.append(_gqa_partial(q.to(dev), kc, vc, k_new.to(dev), v_new.to(dev), pos.to(dev),
                                  i))
    return _lse_combine(parts).reshape(b, h, dh), k_cache, v_cache


# ===========================================================================
# MLA (DeepSeek-V2 / V3 multi-head latent attention)
# ===========================================================================
class MLAttention(nn.Module):
    """``mla_init``'s parameters, no biases, in ``cfg.param_dtype``:
    ``wkv_a`` (D -> r + dr), ``kv_norm`` (RMSNorm over r), ``wkv_b`` (r ->
    H (dn + dv)), ``wo`` (H dv -> D); with ``cfg.q_lora_rank`` also
    ``wq_a`` (D -> q_lora), ``q_norm``, ``wq_b`` (q_lora -> H (dn + dr)),
    else ``wq`` (D -> H (dn + dr))."""

    def __init__(self, cfg, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv, r = cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wkv_a = Dense(d, r + dr, **kw)
        self.kv_norm = RMSNorm(r, eps=cfg.norm_eps, **kw)
        self.wkv_b = Dense(r, h * (dn + dv), **kw)
        self.wo = Dense(h * dv, d, **kw)
        if cfg.q_lora_rank:
            self.wq_a = Dense(d, cfg.q_lora_rank, **kw)
            self.q_norm = RMSNorm(cfg.q_lora_rank, eps=cfg.norm_eps, **kw)
            self.wq_b = Dense(cfg.q_lora_rank, h * (dn + dr), **kw)
        else:
            self.wq = Dense(d, h * (dn + dr), **kw)

    def init_(self, generator: torch.Generator) -> "MLAttention":
        """Uniform in +-1 / sqrt(d_in), in the reference's order: wkv_a,
        wkv_b, wo, then wq_a, wq_b (or wq); the norms stay at ones."""
        qs = (self.wq_a, self.wq_b) if hasattr(self, "wq_a") else (self.wq,)
        for w in (self.wkv_a, self.wkv_b, self.wo) + qs:
            w.init_(generator)
        return self


def mla_specs(cfg, mi) -> dict:
    """The reference's layout of an MLA block over ``mi``."""
    fs, tp = mi.fsdp_axis, mi.tp_axis
    p = {"wkv_a": {"w": (fs, tp)}, "kv_norm": {"scale": (None,)}, "wkv_b": {"w": (fs, tp)},
         "wo": {"w": (tp, fs)}}
    if cfg.q_lora_rank:
        p.update(wq_a={"w": (fs, tp)}, q_norm={"scale": (None,)}, wq_b={"w": (fs, tp)})
    else:
        p["wq"] = {"w": (fs, tp)}
    return p


def _mla_q(ap: MLAttention, cfg, x):
    """(B, S, D) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr), RoPE not yet
    applied."""
    b, s, _ = x.shape
    if cfg.q_lora_rank:
        q = ap.wq_b(ap.q_norm(ap.wq_a(x)))
    else:
        q = ap.wq(x)
    q = q.reshape(b, s, cfg.n_heads, cfg.d_nope + cfg.d_rope)
    return q[..., : cfg.d_nope], q[..., cfg.d_nope :]


def _mla_kv_latent(ap: MLAttention, cfg, x):
    """(B, S, D) -> c_kv (B, S, r) normalised, k_rope (B, S, dr) (no RoPE
    yet)."""
    r = cfg.kv_lora_rank
    kv = ap.wkv_a(x)
    return ap.kv_norm(kv[..., :r]), kv[..., r:]


def mla_train(ap: MLAttention, cfg, x, positions):
    """The expanded (not absorbed) MLA of prefill / training: q = [q_nope ;
    RoPE(q_rope)], k = [k_nope ; RoPE(k_rope) broadcast over the heads], v
    of width d_v, causal chunked attention with chunk ``cfg.attn_chunk``,
    then ``wo`` -> (B, S, D)."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.d_nope, cfg.d_rope, cfg.d_v
    q_nope, q_rope = _mla_q(ap, cfg, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_kv_latent(ap, cfg, x)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)  # (B, S, 1, dr)
    kv = ap.wkv_b(c_kv).reshape(b, s, h, dn + dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope.expand(b, s, h, dr)], dim=-1)
    out = chunked_attention(q, k, kv[..., dn:], causal=True, chunk=cfg.attn_chunk)
    return ap.wo(out.reshape(b, s, h * dv))


def _mla_partial(q_eff, q_rope, entry, c_cache, pos, shard_idx: int, r: int, scale: float):
    """One sequence shard of the latent cache (B, S_local, r + dr): the
    write of ``entry`` and the partial softmax (m, lsum, o_lat), o_lat (B,
    H, r) float32. q_eff (B, H, r) and q_rope (B, H, dr) are already in the
    cache's dtype."""
    b, s_local, _ = c_cache.shape
    _write_row(c_cache, entry, pos - shard_idx * s_local)
    q_lat, q_rot = q_eff.float(), q_rope.float()
    seen = _seen(pos, shard_idx, s_local)

    def chunk_fn(start, size):
        # one row-contiguous upcast of the slice serves the scores and the values
        cc = c_cache[:, start : start + size].float()  # (B, size, r + dr)
        s_lat = torch.matmul(q_lat, cc[..., :r].transpose(1, 2))
        s_rope = torch.matmul(q_rot, cc[..., r:].transpose(1, 2))
        s = torch.where(seen[start : start + size], (s_lat + s_rope) * scale, -math.inf)

        def value_fn(p):
            return torch.matmul(p.to(c_cache.dtype).float(), cc[..., :r])

        return s, value_fn

    return _chunked_partial_softmax(chunk_fn, s_local, (b, q_eff.shape[1], r), c_cache.device)


def mla_decode_attend(ap: MLAttention, cfg, x_tok, c_cache: Cache, pos):
    """The absorbed-matrix MLA decode step. x_tok (B, D): the current
    token's hidden state; c_cache (B, S, r + dr), or its sequence shards
    in order; pos a 0-d int tensor. Writes [c_kv ; RoPE(k_rope)] at ``pos``
    in place (in the shard that holds it) and attends with q_eff = q_nope
    W_uk (float32, then the cache's dtype) over the latent rows -> (out (B,
    D) in x_tok's dtype, c_cache)."""
    b = x_tok.shape[0]
    h, dn, dr, dv, r = cfg.n_heads, cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank
    x = x_tok[:, None, :]  # (B, 1, D)
    at = pos.reshape(1).to(x.device)
    q_nope, q_rope = _mla_q(ap, cfg, x)  # (B, 1, H, dn), (B, 1, H, dr)
    q_rope = apply_rope(q_rope, at, cfg.rope_theta)
    c_new, k_rope_new = _mla_kv_latent(ap, cfg, x)  # (B, 1, r), (B, 1, dr)
    k_rope_new = apply_rope(k_rope_new[..., None, :], at, cfg.rope_theta)[..., 0, :]
    entry = torch.cat([c_new, k_rope_new], dim=-1)[:, 0]  # (B, r + dr)

    # W_uk / W_uv from the reference's (r, H (dn + dv)) wkv_b, in float32
    wkv_b = ap.wkv_b.weight.T.float().reshape(r, h, dn + dv)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wkv_b[..., :dn])
    scale = 1.0 / math.sqrt(dn + dr)
    parts = []
    for i, cc in enumerate(_shards(c_cache)):
        dev, dt = cc.device, cc.dtype
        parts.append(_mla_partial(q_eff.to(dt).to(dev), q_rope[:, 0].to(dt).to(dev),
                                  entry.to(dev), cc, pos.to(dev), i, r, scale))
    o_lat = _lse_combine(parts).to(x_tok.device)  # (B, H, r)
    out = torch.einsum("bhr,rhd->bhd", o_lat, wkv_b[..., dn:])  # (B, H, dv)
    return ap.wo(out.reshape(b, h * dv).to(x_tok.dtype)), c_cache
