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

Over a mesh whose parameters are resident (``gqa_decode_tp``,
``mla_decode_tp``) the cache is a grid of blocks [data group][sequence
shard], block [g][m] on the device of grid position (g, m), where the
group's position m works: the projections are tensor-parallel, the new
token's heads gathered over the model positions, each position writes and
scores its own shard for every head, the shards' partials are combined by
the same rule and placed on each position, and ``wo`` is row-parallel.

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

from repro_torch.models.common.modules import (
    Dense,
    RMSNorm,
    apply_rope,
    chunked_attention,
    rope_frequencies,
    rotate_halves,
)
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


def gqa_project(ap: GQAttention, x):
    """x (B, S, D) -> the q, k, v products (B, S, H dh), (B, S, Hkv dh) twice."""
    return ap.wq(x), ap.wk(x), ap.wv(x)


def gqa_heads(cfg, q, k, v, positions):
    """The products (N, S, heads dh) -> (N, S, heads, dh) each, RoPE applied
    to q and k."""
    q, k, v = (t.reshape(t.shape[0], t.shape[1], -1, cfg.head_dim) for t in (q, k, v))
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_qkv(ap: GQAttention, cfg, x, positions):
    """x (B, S, D) -> q (B, S, H, dh), k / v (B, S, Hkv, dh), RoPE applied to
    q and k."""
    return gqa_heads(cfg, *gqa_project(ap, x), positions)


def gqa_train(ap: GQAttention, cfg, x, positions):
    """The prefill / training path: causal chunked attention with chunk
    ``cfg.attn_chunk``, then ``wo`` -> (B, S, D)."""
    q, k, v = gqa_qkv(ap, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return ap.wo(out.flatten(-2))


def _head_span(m: int, tp: int, h: int, d: int) -> tuple:
    """Model position m's block of an (H d)-wide head-major activation split
    ``tp`` ways: (its first head, one past its last, the block's first
    column within those heads' columns, its width)."""
    width = h * d // tp
    lo = m * width
    first = lo // d
    return first, -(-(lo + width) // d), lo - first * d, width


def _position_heads(grid, i: int, h: int, d: int, group: int, device):
    """The heads each model position of part i attends where the model
    axis does not divide the heads: those that its block of ``wo``'s rows
    (of width d a head) reads, padded to one count (the last head
    repeated). -> (q heads (Mp, n); kv heads (Mp, nkv), q head j reading
    kv head j // (n / nkv), where ``group`` q heads read one kv head; the
    columns (Mp, width) of the n heads' outputs that its block reads), made
    on ``device`` (no copy from the host to wait for)."""
    spans = [_head_span(m, grid.tp, h, d) for m in grid.parts[i].ms]
    n = max(last - first for first, last, _, _ in spans)
    width = spans[0][3]
    lo = grid.model_index(i, device) * width
    first = lo // d
    q = torch.clamp(first[:, None] + torch.arange(n, device=device), max=h - 1)
    cols = (lo - first * d)[:, None] + torch.arange(width, device=device)
    rows = [[min(f + j, h - 1) // group for j in range(n)] for f, _, _, _ in spans]
    per = [list(dict.fromkeys(r)) for r in rows]
    nkv = len(per[0])
    if all(len(r) == nkv for r in per) and n % nkv == 0 and all(
            [x for x in r for _ in range(n // nkv)] == row for r, row in zip(per, rows)):
        kv = (first // group)[:, None] + torch.arange(nkv, device=device)  # whole groups
    else:
        kv = q // group  # one kv head a q head
    return q, kv, cols


def _select(grid, i: int, t, idx):
    """Part i's group value (G B, S, H, d) -> its position value (G M B, S,
    n, d) of each position's heads ``idx`` (Mp, n)."""
    p = grid.parts[i]
    g, s, d = len(p.gs), t.shape[1], t.shape[-1]
    mp, n = idx.shape
    sel = t.index_select(2, idx.reshape(-1))
    return sel.reshape(g, -1, s, mp, n, d).permute(0, 3, 1, 2, 4, 5).reshape(-1, s, n, d)


def _columns(grid, i: int, o, cols):
    """Part i's position value (G M B, S, c) -> each position's ``cols``
    (Mp, width) of it."""
    p = grid.parts[i]
    g, mp, s = len(p.gs), len(p.ms), o.shape[1]
    o = o.reshape(g, mp, -1, s, o.shape[-1])
    idx = cols.reshape(1, mp, 1, 1, -1).expand(g, mp, o.shape[2], s, -1)
    return torch.gather(o, -1, idx).reshape(-1, s, cols.shape[1])


def gqa_train_tp(views, cfg, hs, grid) -> list:
    """``gqa_train`` over a mesh, tensor-parallel: ``views`` the block as
    each part of ``grid`` holds it (``tensor_parallel.Grid.views``), ``hs``
    the normed inputs (a group value) -> the output (a group value).
    ``wq`` / ``wk`` / ``wv`` are column-parallel, so a position holds H /
    tp heads; where tp does not divide the heads (or the kv heads) their
    blocks are gathered over the model positions first, and a position
    attends with the heads that its block of ``wo``'s rows reads. ``wo``
    is row-parallel."""
    tp, h, hkv, dh = grid.tp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (list(t) for t in zip(*grid.each(gqa_project, views, hs)))
    split_q = h % tp == 0
    split_kv = split_q and hkv % tp == 0
    if not split_q:
        q = grid.gather(q)
    if not split_kv:
        k, v = grid.gather(k), grid.gather(v)
    out = []
    for i, ap in enumerate(views):
        positions = torch.arange(hs[i].shape[1], device=hs[i].device)
        qi, ki, vi = gqa_heads(cfg, q[i], k[i], v[i], positions)
        cols = None
        if not split_kv:
            qh, kvh, cols = _position_heads(grid, i, h, dh, h // hkv, qi.device)
            ki, vi = _select(grid, i, ki, kvh), _select(grid, i, vi, kvh)
            if split_q:  # q holds each position's heads already
                cols = None
            else:
                qi = _select(grid, i, qi, qh)
        o = chunked_attention(qi, ki, vi, causal=True, chunk=cfg.attn_chunk).flatten(-2)
        if cols is not None:
            o = _columns(grid, i, o, cols)
        out.append(ap.wo(o))
    return grid.row_sum(out)


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


def rope_one(x, pos, theta: float):
    """RoPE at one position: x (B, H, d), pos a 0-d tensor."""
    angles = pos.float() * rope_frequencies(x.shape[-1], theta, device=x.device)  # (d / 2,)
    return rotate_halves(x, torch.cos(angles), torch.sin(angles))


def _cache_block(entry, g: int, m: int, groups: int):
    """Data group g's block of sequence shard m of a layer's cache entry: its
    grid's block [g][m], or the group's rows of a one-device tensor (a model
    axis of one position: one shard; a view, so writes land in place)."""
    if isinstance(entry, torch.Tensor):
        bl = entry.shape[0] // groups
        return entry[g * bl : (g + 1) * bl]
    return entry[g][m]


def _attend_shards_tp(grid, inputs: list, partial, caches) -> list:
    """Each data group's decode attention over its sequence shards, on a
    ``tensor_parallel.Grid``: ``inputs`` each part's tuple of group values
    (the new token's rows), ``partial(rows, blocks, m)`` sequence shard m's
    write and partial softmax (m, lsum, o) on its blocks' device (the
    blocks of ``caches``, a layer's entries). Each group's partials are
    combined in shard order (``_lse_combine``: the reference's pmax and
    psums, reported for group 0) and the row's groups placed on every part
    of the row -> the output, a group value."""
    out = [None] * len(grid.parts)
    for row in grid.rows:
        gs = grid.parts[row[0]].gs
        totals = []
        for j, g in enumerate(gs):
            parts = []
            for i in row:
                rows = [t.reshape(len(gs), -1, *t.shape[1:])[j] for t in inputs[i]]
                for m in grid.parts[i].ms:
                    blocks = [_cache_block(c, g, m, grid.groups) for c in caches]
                    dev = blocks[0].device
                    parts.append(partial([t.to(dev) for t in rows], blocks, m))
            with collectives.group(g):
                totals.append(_lse_combine(parts))
        dev = grid.parts[row[0]].device
        total = torch.cat([t.to(dev) for t in totals], dim=0)
        for i, x in zip(row, grid.place(row, total)):
            out[i] = x
    return out


def _own_block(grid, i: int, x):
    """Part i's group value (G B, S, tp w) -> its position value (G M B, S,
    w): each of its model positions' block of the last dimension."""
    p = grid.parts[i]
    g, s = len(p.gs), x.shape[1]
    x = x.reshape(g, -1, s, grid.tp, x.shape[-1] // grid.tp)[:, :, :, p.ms[0] : p.ms[-1] + 1]
    return x.permute(0, 3, 1, 2, 4).reshape(-1, s, x.shape[-1])


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


def gqa_decode_tp(views, cfg, hs, k_cache, v_cache, pos, grid) -> list:
    """``gqa_decode_attend`` with its projections over a mesh whose
    parameters are resident: ``views`` the block as each part of ``grid``
    holds it, ``hs`` the normed new tokens (a group value (G B, 1, D)),
    ``k_cache`` / ``v_cache`` a layer's grid of blocks [g][m] (or, over a
    model axis of one position, its one-device tensors), ``pos`` the 0-d
    position -> the output (a group value). ``wq`` / ``wk`` / ``wv`` are
    column-parallel and their blocks gathered over the model positions (one
    all-gather), so every position holds every head of the new token,
    whatever tp divides; RoPE at ``pos``; each position writes k / v into its
    shard and scores it for every head (``_gqa_partial``); the combined
    output's columns that a position's block of ``wo``'s rows reads go
    through ``wo``, row-parallel."""
    tp, hds, hkv, dh = grid.tp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = (hds * dh // tp, hkv * dh // tp, hkv * dh // tp)
    joined = grid.gather(grid.each(lambda ap, x: torch.cat([ap.wq(x), ap.wk(x), ap.wv(x)], -1),
                                   views, hs))
    heads = []
    for x in joined:  # (G B, 1, tp (q + k + v) columns), position-major
        n, at = x.shape[0], pos.to(x.device)
        q, k, v = (t.reshape(n, -1, dh) for t in x.reshape(n, tp, -1).split(split, -1))
        heads.append((rope_one(q, at, cfg.rope_theta), rope_one(k, at, cfg.rope_theta), v))

    def partial(rows, blocks, m):
        q, k_new, v_new = rows
        return _gqa_partial(q, blocks[0], blocks[1], k_new, v_new, pos.to(q.device), m)

    o = _attend_shards_tp(grid, heads, partial, (k_cache, v_cache))
    cols = [_own_block(grid, i, x.reshape(x.shape[0], 1, -1).to(h.dtype))
            for i, (x, h) in enumerate(zip(o, hs))]
    return grid.row_sum(grid.each(lambda ap, x: ap.wo(x), views, cols))


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


def _mla_q_heads(cfg, q):
    """The q product (N, S, heads (dn + dr)) -> q_nope (N, S, heads, dn),
    q_rope (N, S, heads, dr), RoPE not yet applied."""
    q = q.reshape(q.shape[0], q.shape[1], -1, cfg.d_nope + cfg.d_rope)
    return q[..., : cfg.d_nope], q[..., cfg.d_nope :]


def _mla_q(ap: MLAttention, cfg, x):
    """(B, S, D) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr), RoPE not yet
    applied."""
    if cfg.q_lora_rank:
        return _mla_q_heads(cfg, ap.wq_b(ap.q_norm(ap.wq_a(x))))
    return _mla_q_heads(cfg, ap.wq(x))


def _mla_kv_split(ap: MLAttention, cfg, kv):
    """The wkv_a product (N, S, r + dr) -> c_kv (N, S, r) normalised, k_rope
    (N, S, dr) (no RoPE yet)."""
    r = cfg.kv_lora_rank
    return ap.kv_norm(kv[..., :r]), kv[..., r:]


def _mla_kv_latent(ap: MLAttention, cfg, x):
    """(B, S, D) -> c_kv (B, S, r) normalised, k_rope (B, S, dr) (no RoPE
    yet)."""
    return _mla_kv_split(ap, cfg, ap.wkv_a(x))


def _mla_attend(cfg, q_nope, q_rope, kv, k_rope, positions):
    """q = [q_nope ; RoPE(q_rope)], k = [k_nope ; RoPE(k_rope) broadcast over
    the heads], v of width d_v (kv (N, S, heads, dn + dv) the wkv_b
    product's heads, k_rope (N, S, dr)): causal chunked attention with
    chunk ``cfg.attn_chunk`` -> (N, S, heads, dv)."""
    n, s, heads = q_nope.shape[:3]
    dn, dr = cfg.d_nope, cfg.d_rope
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)  # (N, S, 1, dr)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope.expand(n, s, heads, dr)], dim=-1)
    return chunked_attention(q, k, kv[..., dn:], causal=True, chunk=cfg.attn_chunk)


def mla_train(ap: MLAttention, cfg, x, positions):
    """The expanded (not absorbed) MLA of prefill / training
    (``_mla_attend``), then ``wo`` -> (B, S, D)."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(ap, cfg, x)
    c_kv, k_rope = _mla_kv_latent(ap, cfg, x)
    kv = ap.wkv_b(c_kv).reshape(b, s, cfg.n_heads, cfg.d_nope + cfg.d_v)
    return ap.wo(_mla_attend(cfg, q_nope, q_rope, kv, k_rope, positions).flatten(-2))


def mla_train_tp(views, cfg, hs, grid) -> list:
    """``mla_train`` over a mesh, tensor-parallel (``gqa_train_tp``'s
    arguments). ``wq_a`` and ``wkv_a`` are column-parallel and their
    outputs gathered over the model positions before ``q_norm`` /
    ``kv_norm``, which need the whole rank (``wkv_a``'s r + dr columns split
    across the r / dr boundary); ``wq_b`` (or ``wq``) and ``wkv_b`` are
    column-parallel, so a position holds H / tp heads (gathered where tp
    does not divide H, each position then taking the heads its block of
    ``wo``'s rows reads); ``wo`` is row-parallel."""
    h, dn, dv = cfg.n_heads, cfg.d_nope, cfg.d_v
    if cfg.q_lora_rank:
        a = grid.gather(grid.each(lambda ap, x: ap.wq_a(x), views, hs))
        q = grid.each(lambda ap, x: ap.wq_b(ap.q_norm(x)), views, a)
    else:
        q = grid.each(lambda ap, x: ap.wq(x), views, hs)
    lat = grid.each(lambda ap, x: _mla_kv_split(ap, cfg, x), views,
                    grid.gather(grid.each(lambda ap, x: ap.wkv_a(x), views, hs)))
    kv = grid.each(lambda ap, c: ap.wkv_b(c[0]), views, lat)
    split = h % grid.tp == 0
    if not split:
        q, kv = grid.gather(q), grid.gather(kv)
    out = []
    for i, ap in enumerate(views):
        s = hs[i].shape[1]
        positions = torch.arange(s, device=hs[i].device)
        q_nope, q_rope = _mla_q_heads(cfg, q[i])
        kvi = kv[i].reshape(kv[i].shape[0], s, -1, dn + dv)
        if not split:
            heads, _, cols = _position_heads(grid, i, h, dv, 1, q_nope.device)
            q_nope, q_rope, kvi = (_select(grid, i, t, heads) for t in (q_nope, q_rope, kvi))
        o = _mla_attend(cfg, q_nope, q_rope, kvi, grid.spread(i, lat[i][1]), positions)
        o = o.flatten(-2)
        if not split:
            o = _columns(grid, i, o, cols)
        out.append(ap.wo(o))
    return grid.row_sum(out)


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


def _wkv_b_blocks(ap):
    """A part's model shards of ``wkv_b`` as one float32 (Mp, n, r) tensor
    (n = H (dn + dv) / tp rows of the port's weight, r its input)."""
    return torch.stack([w.float() for w in ap.wkv_b.ws])


def _padded_heads(w, m: int, tp: int, h: int, d: int):
    """Position m's (n, r) block of a head-major (H d, r) weight -> (its
    first head, the block zero-padded to whole heads (heads, d, r))."""
    first, last, off, width = _head_span(m, tp, h, d)
    pad = w.new_zeros(((last - first) * d, w.shape[-1]))
    pad[off : off + width] = w
    return first, pad.reshape(last - first, d, -1)


def _mla_q_tp(views, cfg, hs, at, grid) -> list:
    """The queries of the new token over a mesh -> a group value (G B, H, r +
    dr) float32: [q_nope W_uk ; RoPE(q_rope)] of every head. Where tp
    divides H each position's heads of q (column-parallel) meet its head
    block of ``wkv_b`` and the results are gathered (one all-gather); else q
    is gathered first and each position's ``wkv_b`` rows, padded to whole
    heads, give partial products summed over the positions (one
    all-reduce)."""
    h, dn, dr, dv, r, tp = (cfg.n_heads, cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank,
                            grid.tp)
    if cfg.q_lora_rank:
        a = grid.gather(grid.each(lambda ap, x: ap.wq_a(x), views, hs))
        q = grid.each(lambda ap, x: ap.wq_b(ap.q_norm(x)), views, a)
    else:
        q = grid.each(lambda ap, x: ap.wq(x), views, hs)
    if h % tp == 0:
        out = []
        for i, (ap, qi) in enumerate(zip(views, q)):
            p, hl = grid.parts[i], h // tp
            q_nope, q_rope = _mla_q_heads(cfg, qi)  # (G M B, 1, hl, dn), (..., dr)
            q_rope = apply_rope(q_rope, at.to(qi.device), cfg.rope_theta)[:, 0].float()
            w = _wkv_b_blocks(ap).reshape(len(p.ms), hl, dn + dv, r)
            qn = q_nope[:, 0].float().reshape(len(p.gs), len(p.ms), -1, hl, dn)
            q_eff = torch.einsum("gmbhd,mhdr->gmbhr", qn, w[:, :, :dn]).reshape(-1, hl, r)
            out.append(torch.cat([q_eff, q_rope], -1).flatten(1))
        return [x.reshape(x.shape[0], h, r + dr) for x in grid.gather(out)]
    q = grid.gather(q)
    rope, partials = [], []
    for i, (ap, qi) in enumerate(zip(views, q)):
        p = grid.parts[i]
        q_nope, q_rope = _mla_q_heads(cfg, qi)  # (G B, 1, H, dn), (..., dr)
        rope.append(apply_rope(q_rope, at.to(qi.device), cfg.rope_theta)[:, 0].float())
        qn = q_nope[:, 0].float().reshape(len(p.gs), -1, h, dn)
        eff = qn.new_zeros((len(p.gs), len(p.ms), qn.shape[1], h, r))
        for j, (m, w) in enumerate(zip(p.ms, _wkv_b_blocks(ap))):
            first, wp = _padded_heads(w, m, tp, h, dn + dv)
            span = slice(first, first + wp.shape[0])
            eff[:, j, :, span] = torch.einsum("gbhd,hdr->gbhr", qn[:, :, span], wp[:, :dn])
        partials.append(eff.reshape(-1, h, r))
    return grid.each(lambda e, x: torch.cat([e, x], -1), grid.row_sum(partials), rope)


def mla_decode_tp(views, cfg, hs, c_cache, pos, grid) -> list:
    """``mla_decode_attend`` over a mesh whose parameters are resident
    (``gqa_decode_tp``'s arguments, ``c_cache`` a layer's grid of latent
    blocks). ``wkv_a`` / ``wq_a`` are column-parallel and gathered before
    ``kv_norm`` / ``q_norm``; q_eff = q_nope W_uk from each position's head
    block of ``wkv_b`` (``_mla_q_tp``); each position writes the latent row
    [c_kv ; RoPE(k_rope)] into its shard and scores it for every head
    (``_mla_partial``); the combined o_lat meets W_uv on each position's own
    heads (where tp does not divide H: on its rows of ``wkv_b`` padded to
    whole heads, the products summed over the positions and each position
    taking the columns its block of ``wo``'s rows reads); ``wo`` is
    row-parallel."""
    h, dn, dr, dv, r, tp = (cfg.n_heads, cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank,
                            grid.tp)
    at = pos.reshape(1)
    entries = []
    for ap, x in zip(views, grid.gather(grid.each(lambda ap, x: ap.wkv_a(x), views, hs))):
        c_new, k_rope = _mla_kv_split(ap, cfg, x)  # (G B, 1, r), (G B, 1, dr)
        k_rope = apply_rope(k_rope[..., None, :], at.to(x.device), cfg.rope_theta)[..., 0, :]
        entries.append(torch.cat([c_new, k_rope], dim=-1)[:, 0])
    q = _mla_q_tp(views, cfg, hs, at, grid)
    scale = 1.0 / math.sqrt(dn + dr)

    def partial(rows, blocks, m):
        qm, entry = rows
        dt = blocks[0].dtype
        return _mla_partial(qm[..., :r].to(dt), qm[..., r:].to(dt), entry, blocks[0],
                            pos.to(entry.device), m, r, scale)

    o_lat = _attend_shards_tp(grid, [(a, b) for a, b in zip(q, entries)], partial, (c_cache,))
    outs = []
    for i, (ap, o, x) in enumerate(zip(views, o_lat, hs)):
        p = grid.parts[i]
        ws = _wkv_b_blocks(ap)
        o = o.reshape(len(p.gs), -1, h, r)  # (G, B, H, r) float32
        if h % tp == 0:
            hl = h // tp
            w = ws.reshape(len(p.ms), hl, dn + dv, r)[:, :, dn:]
            own = o.reshape(len(p.gs), -1, tp, hl, r)[:, :, p.ms[0] : p.ms[-1] + 1]
            out = torch.einsum("gbmhr,mhdr->gmbhd", own, w).reshape(-1, 1, hl * dv)
        else:
            out = o.new_zeros((len(p.gs), len(p.ms), o.shape[1], h, dv))
            for j, (m, w) in enumerate(zip(p.ms, ws)):
                first, wp = _padded_heads(w, m, tp, h, dn + dv)
                span = slice(first, first + wp.shape[0])
                out[:, j, :, span] = torch.einsum("gbhr,hdr->gbhd", o[:, :, span], wp[:, dn:])
            out = out.reshape(-1, 1, h * dv)
        outs.append(out)
    if h % tp:
        outs = [_own_block(grid, i, x) for i, x in enumerate(grid.row_sum(outs))]
    return grid.row_sum(grid.each(lambda ap, o, x: ap.wo(o.to(x.dtype)), views, outs, hs))
