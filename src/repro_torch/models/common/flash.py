"""FlashAttention-2-style chunked attention with its own backward (port of
``repro.models.common.flash``).

Forward: the online-softmax scan over KV chunks (never materialises the
(Sq, Skv) score matrix); it saves only (q, k, v, out, lse). Backward:
recomputes p per chunk from the saved lse and accumulates dq / dk / dv,
the FA2 recompute schedule (``torch.autograd.Function``).

The reference's order of operations is kept where it decides the
numbers: q, k and v are cast to float32 before the score and PV products,
``scale`` multiplies the product, a soft cap is applied before the mask,
the padded tail is masked by ``kv_pos < skv`` and the causal mask by
``kv_pos <= q_offset + arange(sq)``, ``m_safe`` and ``corr`` go through
``isfinite``, fully masked rows get ``lse = -inf`` and the output is
``acc / max(lsum, 1e-30)``. Products are plain float32 products
(``torch.matmul``): on the card they must run with TF32 off.

This is the port's attention on every device: no TPU kernel stands behind
the reference (plain JAX with a custom VJP), and no library attention
takes its place. The reference's layout constraints (``_constrainer``)
do nothing on one controller.

Layout: heads are grouped as (B, Hkv, G, Sq) with G = H / Hkv, and the
(G, Sq) rows of a KV head are one matrix of the products, so each chunk
is two batched matmuls over (B, Hkv).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AttnMeta:
    causal: bool
    q_offset: int
    chunk: int
    soft_cap: float


@dataclasses.dataclass(frozen=True)
class _Shape:
    b: int
    sq: int
    skv: int
    hkv: int
    g: int
    dh: int
    dhv: int
    chunk: int
    n_chunks: int

    @classmethod
    def of(cls, q, k, v, meta: AttnMeta) -> "_Shape":
        b, sq, h, dh = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        chunk = min(meta.chunk, skv)
        return cls(b=b, sq=sq, skv=skv, hkv=hkv, g=h // hkv, dh=dh, dhv=v.shape[-1],
                   chunk=chunk, n_chunks=-(-skv // chunk))


def _heads_first(x, sh: _Shape, d: int):
    """(B, S, H, d) -> float32 (B, Hkv, G * S, d), contiguous."""
    x = x.float().reshape(sh.b, -1, sh.hkv, sh.g, d).permute(0, 2, 3, 1, 4)
    return x.reshape(sh.b, sh.hkv, -1, d)


def _kv_padded(x, sh: _Shape):
    """(B, Skv, Hkv, d) -> float32 (B, Hkv, n_chunks * chunk, d), the tail
    zero-padded."""
    pad = sh.n_chunks * sh.chunk - sh.skv
    return F.pad(x.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).contiguous()


def _valid(idx: int, sh: _Shape, meta: AttnMeta, device):
    """(1 or Sq, chunk) bool: the chunk's keys inside Skv (and, causal, at
    or before each query's position)."""
    kv_pos = idx * sh.chunk + torch.arange(sh.chunk, device=device)
    valid = kv_pos[None, :] < sh.skv
    if meta.causal:
        q_pos = meta.q_offset + torch.arange(sh.sq, device=device)
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    return valid


def _scores(qt, kc, sh: _Shape, scale: float):
    """(B, Hkv, G, Sq, chunk) float32 scores of one chunk, times ``scale``."""
    s = torch.matmul(qt, kc.transpose(-1, -2))
    return s.mul_(scale).view(sh.b, sh.hkv, sh.g, sh.sq, sh.chunk)


def _fwd_core(q, k, v, meta: AttnMeta):
    """-> (out (B, Sq, H, dhv) in q's dtype, lse (B, Hkv, G, Sq) float32)."""
    sh = _Shape.of(q, k, v, meta)
    dev = q.device
    scale = 1.0 / math.sqrt(sh.dh)
    qt = _heads_first(q, sh, sh.dh)
    kt, vt = _kv_padded(k, sh), _kv_padded(v, sh)
    rows = (sh.b, sh.hkv, sh.g, sh.sq)
    m = torch.full(rows, -math.inf, dtype=torch.float32, device=dev)
    lsum = torch.zeros(rows, dtype=torch.float32, device=dev)
    acc = torch.zeros(rows + (sh.dhv,), dtype=torch.float32, device=dev)
    for idx in range(sh.n_chunks):
        cols = slice(idx * sh.chunk, (idx + 1) * sh.chunk)
        s = _scores(qt, kt[:, :, cols], sh, scale)
        if meta.soft_cap > 0:
            s = torch.tanh(s / meta.soft_cap).mul_(meta.soft_cap)
        invalid = ~_valid(idx, sh, meta, dev)
        s.masked_fill_(invalid, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = s.sub_(m_safe[..., None]).exp_().masked_fill_(invalid, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        lsum = lsum * corr + p.sum(-1)
        pv = torch.matmul(p.view(sh.b, sh.hkv, sh.g * sh.sq, sh.chunk), vt[:, :, cols])
        acc = acc * corr[..., None] + pv.view(rows + (sh.dhv,))
        m = m_new
    lsum_safe = lsum.clamp_min(1e-30)
    out5 = acc / lsum_safe[..., None]
    lse = torch.where((lsum > 0) & torch.isfinite(m), m + torch.log(lsum_safe), -math.inf)
    out = out5.permute(0, 3, 1, 2, 4).reshape(sh.b, sh.sq, sh.hkv * sh.g, sh.dhv)
    return out.to(q.dtype), lse


def _fa_bwd(meta: AttnMeta, q, k, v, out, lse, dout):
    """FA2's backward from the saved (q, k, v, out, lse) -> (dq, dk, dv) in
    their inputs' dtypes."""
    sh = _Shape.of(q, k, v, meta)
    dev = q.device
    scale = 1.0 / math.sqrt(sh.dh)
    qt = _heads_first(q, sh, sh.dh)
    kt, vt = _kv_padded(k, sh), _kv_padded(v, sh)
    og = _heads_first(out, sh, sh.dhv)
    dog = _heads_first(dout, sh, sh.dhv)
    dmass = (dog * og).sum(-1)  # (B, Hkv, G * Sq): FA2's D term
    lse_rows = lse.reshape(sh.b, sh.hkv, sh.g, sh.sq)
    lse_finite = torch.isfinite(lse_rows)
    lse_safe = torch.where(lse_finite, lse_rows, 0.0)
    flat = (sh.b, sh.hkv, sh.g * sh.sq, sh.chunk)
    dq = torch.zeros_like(qt)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    for idx in range(sh.n_chunks):
        cols = slice(idx * sh.chunk, (idx + 1) * sh.chunk)
        kc, vc = kt[:, :, cols], vt[:, :, cols]
        s = _scores(qt, kc, sh, scale)
        dtanh = None
        if meta.soft_cap > 0:
            t = torch.tanh(s / meta.soft_cap)
            s = meta.soft_cap * t
            dtanh = 1.0 - t * t
        p = s.sub_(lse_safe[..., None]).exp_()
        p.masked_fill_(~_valid(idx, sh, meta, dev), 0.0)
        p.masked_fill_(~lse_finite[..., None], 0.0)
        p = p.view(flat)
        dv[:, :, cols] = torch.matmul(p.transpose(-1, -2), dog)
        dp = torch.matmul(dog, vc.transpose(-1, -2))
        ds = p * (dp - dmass[..., None])
        if dtanh is not None:
            ds = ds * dtanh.view(flat)
        dq = dq + torch.matmul(ds, kc) * scale
        dk[:, :, cols] = torch.matmul(ds.transpose(-1, -2), qt) * scale
    dq = dq.view(sh.b, sh.hkv, sh.g, sh.sq, sh.dh).permute(0, 3, 1, 2, 4)
    dq = dq.reshape(q.shape).to(q.dtype)
    dk = dk[:, :, : sh.skv].permute(0, 2, 1, 3).to(k.dtype)
    dv = dv[:, :, : sh.skv].permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, meta: AttnMeta):
        out, lse = _fwd_core(q, k, v, meta)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = meta
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa_bwd(ctx.meta, q, k, v, out, lse, dout)
        return dq, dk, dv, None


def flash_attention(q, k, v, meta: AttnMeta):
    """q: (B, Sq, H, dh), k / v: (B, Skv, Hkv, dh[v]) -> (B, Sq, H, dhv) in
    q's dtype; differentiable in q, k and v through FA2's backward."""
    return _FlashAttention.apply(q, k, v, meta)
