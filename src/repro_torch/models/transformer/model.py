"""Decoder-only transformer LM (port of ``repro.models.transformer.model``):
``TransformerConfig``, the model's parameters (dense GQA or MLA layers,
dense or MoE feed-forwards, the MTP block), ``forward_hidden`` /
``prefill_logits``, the training loss ``lm_loss`` (chunked cross-entropy,
MTP, the router's aux loss), and the KV-cache decode step, on one device
or over a ``DeviceMesh``.

The reference stacks its layers on a leading axis and scans over them;
the port keeps one module a layer in ``dense_layers`` and ``moe_layers``
(``StackedLayers``; the layers run dense first, then MoE), each
parameter of a list a row of one stacked tensor, so
the optimizer sees the reference's stacked leaves;
``interop.lm_params_from_reference`` loads the reference's layers in
order. The cache is one (L, B, S, Hkv, dh) tensor for k and one for v
(GQA), or one (L, B, S, r + dr) latent tensor ``c`` (MLA);
``decode_step`` writes each layer's new row into it in place and returns
the same tensors, so one step never copies the cache.

A layer is pre-norm: RMSNorm, attention, residual; RMSNorm, the SwiGLU
feed-forward silu(h w1) * (h w3) w2 or the MoE (``moe.py``), residual.
Products run in ``cfg.compute_dtype`` (bf16 for the published configs: one
bf16 product rounds its output to bf16, as the reference's does);
attention runs in float32 (``models/common/flash.py``; the decode step's
chunks, ``attention.py``). Logits are (B, vocab_padded) float32.

Over a mesh (``mi``, a ``MeshInfo`` whose model axis is > 1), the cache is
laid out as ``cache_specs`` lays it: the batch split over the data axes
where they divide it, the sequence over the model axis. ``init_cache``
and ``shard_cache`` give it as a grid of blocks, ``[batch block][sequence
shard]``, each (L, B_g, S_m, ...) on its mesh position's device; a batch
the data axes do not divide is one block, held by the first data group
(the reference replicates it over the groups, each computing the same).
Each block is scored and written in place on its own device, and the
shards combine by the log-sum-exp rule (``attention.py``). The
projections run on the model's device. The MoE runs its expert-parallel
branch (``moe.py``). A mesh whose model axis is 1 runs the one-device
path, as the reference's does.

Training (``lm_loss``) runs on one device. ``cfg.remat`` rematerialises
each layer and each cross-entropy chunk in the backward where autograd
records (``"full"``: nothing saved; ``"dots"``: the products without
batch dimensions saved; ``"none"``: everything saved), as the reference's
``jax.checkpoint`` policies do; the serving paths run under
``inference_mode`` and never checkpoint. ``sequence_parallel`` shapes the
reference's layouts and does nothing here.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.models.common.modules import (
    Dense,
    Embedding,
    RMSNorm,
    StackedLayers,
    rope_frequencies,
    rotate_halves,
)
from repro_torch.models.recsys.models import fill_normal_
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer.moe import MoE, SwiGLU, router_aux_loss


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


class Layer(nn.Module):
    """``_layer_init(kind)``: ``ln1``, ``ln2`` (RMSNorm), ``attn`` (GQA or MLA
    by ``cfg.attn_type``) and ``ffn`` (a SwiGLU of width d_ff, or the MoE
    where ``kind`` is "moe")."""

    def __init__(self, cfg: TransformerConfig, device, kind: str = "dense"):
        super().__init__()
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.kind = kind
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.attn = (attn.MLAttention if cfg.attn_type == "mla" else attn.GQAttention)(cfg, device)
        self.ffn = MoE(cfg, device) if kind == "moe" else SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def init_(self, generator: torch.Generator) -> "Layer":
        self.attn.init_(generator)
        self.ffn.init_(generator)
        return self

    def feed_forward(self, h, mi=None):
        return self.ffn(h, mi) if self.kind == "moe" else self.ffn(h)


class MTP(nn.Module):
    """The multi-token-prediction block's parameters (DeepSeek-V3): ``proj``
    (2D -> D), a dense ``layer`` and ``norm``."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.proj = Dense(2 * cfg.d_model, cfg.d_model, **kw)
        self.layer = Layer(cfg, device, "dense")
        self.norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)


class Transformer(nn.Module):
    """``init_params``' parameters: ``embed`` (vocab_padded, D) table,
    ``final_norm``, ``lm_head`` (D -> vocab_padded), ``dense_layers``,
    ``moe_layers`` and, with ``cfg.mtp``, ``mtp``. Built uninitialised;
    fill it with ``init_params`` or ``interop.lm_params_from_reference``."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_padded, **kw)
        self.dense_layers = StackedLayers(Layer(cfg, device) for _ in range(cfg.n_dense))
        self.moe_layers = StackedLayers(Layer(cfg, device, "moe") for _ in range(cfg.n_moe))
        if cfg.mtp:
            self.mtp = MTP(cfg, device)

    def layers(self):
        """The layers in the order they run: dense, then MoE."""
        return itertools.chain(self.dense_layers, self.moe_layers)


def init_params(generator: torch.Generator, cfg: TransformerConfig, device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` with the reference's init laws, drawn
    from ``generator`` in the reference's order: the embedding normal * 0.02,
    ``lm_head``, the dense layers, the MoE layers, then MTP's proj and
    layer; each layer's attention before its feed-forward (``Layer.init_``);
    the norms at ones."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = Transformer(cfg, device=dev)
    fill_normal_(model.embed.table, generator, 0.02)
    model.lm_head.init_(generator)
    for layer in model.layers():
        layer.init_(generator)
    if cfg.mtp:
        model.mtp.proj.init_(generator)
        model.mtp.layer.init_(generator)
    return model


def _layer_apply(cfg: TransformerConfig, lp: Layer, x, positions, mi):
    h = lp.ln1(x)
    if cfg.attn_type == "mla":
        x = x + attn.mla_train(lp.attn, cfg, h, positions)
    else:
        x = x + attn.gqa_train(lp.attn, cfg, h, positions)
    return x + lp.feed_forward(lp.ln2(x), mi)


# The products a "dots" remat saves: jax's dots_with_no_batch_dims_saveable.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn, *args):
    """fn(*args), under ``cfg.remat``'s checkpoint where autograd records."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def forward_hidden(model: Transformer, tokens, mi=None):
    """tokens (B, S) int32 -> hidden states (B, S, D) in the compute dtype.
    ``mi`` (a ``MeshInfo``) decides the MoE's branch."""
    cfg = model.cfg
    x = model.embed.table[tokens.long()].to(cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in model.layers():
        x = _remat(cfg, functools.partial(_layer_apply, cfg, lp, positions=positions, mi=mi), x)
    return model.final_norm(x)


def _ce_chunk(lm_head: nn.Module, hc, lc, wc):
    """sum((logsumexp - label logit) * w) over one chunk, float32: the logits
    ``hc @ lm_head`` in the compute dtype, then float32."""
    logits = lm_head(hc).float()
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]  # the masked max's value
    return ((torch.logsumexp(logits, dim=-1) - ll) * wc).sum()


def _chunked_ce(cfg: TransformerConfig, h, lm_head: nn.Module, labels, weights):
    """Cross-entropy over ``cfg.ce_chunk`` positions at a time, never the
    whole (B, S, V) logits: sum((lse - ll) * w) / max(sum(w), 1), the sums
    float32 in chunk order; each chunk under ``cfg.remat``'s checkpoint, so
    its float32 logits live one chunk at a time in the backward too."""
    s = h.shape[1]
    chunk = min(cfg.ce_chunk, s)
    if s % chunk:
        raise ValueError(f"a sequence of {s} does not split into chunks of {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    wsum = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        part = slice(lo, lo + chunk)
        tot = tot + _remat(cfg, functools.partial(_ce_chunk, lm_head), h[:, part],
                           labels[:, part], weights[:, part])
        wsum = wsum + weights[:, part].sum()
    return tot / torch.clamp_min(wsum, 1.0)


def _shifted(tokens, k: int):
    """(tokens shifted left by k, the first k wrapped to the end; float32
    weights 1, 0 on the last k positions)."""
    labels = torch.cat([tokens[:, k:], tokens[:, :k]], dim=1)
    weights = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    weights[:, -k:] = 0.0
    return labels, weights


def lm_loss(model: Transformer, batch: dict, mi=None):
    """batch {"tokens": (B, S) int32} -> (loss, metrics): next-token CE,
    plus ``mtp_coef`` x the MTP block's CE of the token after next (with
    ``cfg.mtp``), plus ``router_aux_coef`` x the last MoE layer's router
    aux loss on the final normed hidden states (the reference's cheap
    proxy). metrics: ``ce``, ``mtp_ce``, ``router_aux`` where they apply,
    and ``loss``."""
    cfg = model.cfg
    tokens = batch["tokens"]
    h = forward_hidden(model, tokens, mi)
    labels, weights = _shifted(tokens, 1)
    loss = _chunked_ce(cfg, h, model.lm_head, labels, weights)
    metrics = {"ce": loss}
    if cfg.mtp:
        # Token t + 2 from [h_t ; emb(token_{t+1})] through one dense block.
        emb_next = model.embed.table[labels.long()].to(cfg.compute_dtype)
        h2 = model.mtp.proj(torch.cat([h.to(cfg.compute_dtype), emb_next], dim=-1))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h2 = model.mtp.norm(_layer_apply(cfg, model.mtp.layer, h2, positions, mi))
        labels2, weights2 = _shifted(tokens, 2)
        mtp_loss = _chunked_ce(cfg, h2, model.lm_head, labels2, weights2)
        metrics["mtp_ce"] = mtp_loss
        loss = loss + cfg.mtp_coef * mtp_loss
    if cfg.is_moe and cfg.router_aux_coef > 0:
        aux = router_aux_loss(model.moe_layers[-1].ffn, cfg, h)
        metrics["router_aux"] = aux
        loss = loss + cfg.router_aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics


def prefill_logits(model: Transformer, tokens, mi=None):
    """Full-sequence prefill -> the last position's logits (B, vocab_padded)
    float32."""
    last = forward_hidden(model, tokens, mi)[:, -1]
    return model.lm_head(last).float()


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------
def cache_shape(cfg: TransformerConfig, batch: int, s_max: int) -> dict:
    """The cache's entries as (shape, dtype), in the compute dtype: MLA's
    latent ``c`` (L, B, S, r + dr), or GQA's ``k`` and ``v`` (L, B, S, Hkv,
    dh); ``pos`` a 0-d int32."""
    pos = ((), torch.int32)
    if cfg.attn_type == "mla":
        entry = (cfg.n_layers, batch, s_max, cfg.kv_lora_rank + cfg.d_rope)
        return {"c": (entry, cfg.compute_dtype), "pos": pos}
    kv = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (kv, cfg.compute_dtype), "v": (kv, cfg.compute_dtype), "pos": pos}


def _cache_layout(mi, batch: int, s_max: int) -> Optional[tuple[int, int]]:
    """(batch blocks, sequence shards) of a cache over ``mi``, or None where
    the one-device layout applies (no mesh, or a model axis of 1)."""
    if mi is None or mi.tp_size == 1:
        return None
    if s_max % mi.tp_size:
        raise ValueError(f"a {s_max}-token cache does not split into {mi.tp_size} shards")
    return (mi.dp_size if mi.axes_if_divisible(batch, mi.dp_axes) else 1), mi.tp_size


def _blocks(t, mi, layout, make):
    """The grid [g][m] of ``make(block of t, device)`` over ``layout``."""
    n_b, n_s = layout
    bl, sl = t.shape[1] // n_b, t.shape[2] // n_s
    devs = mi.mesh.groups(mi.tp_axis)
    return tuple(tuple(make(t[:, g * bl : (g + 1) * bl, m * sl : (m + 1) * sl], devs[g, m])
                       for m in range(n_s)) for g in range(n_b))


def init_cache(cfg: TransformerConfig, batch: int, s_max: int, device="cuda", mi=None) -> dict:
    """A zero cache at position 0. Without a mesh (or with a model axis of
    1) its tensors are on ``device`` (with ``mi``, the mesh's first
    device); over a mesh, as ``shard_cache`` lays it out, each block
    allocated on its own device."""
    if mi is not None:
        device = mi.mesh.devices[0]
    dev = resolve_device(device)
    shapes = cache_shape(cfg, batch, s_max)
    layout = _cache_layout(mi, batch, s_max)
    out = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for k, (shape, dtype) in shapes.items():
        if k == "pos":
            continue
        if layout is None:
            out[k] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            meta = torch.empty(shape, dtype=dtype, device="meta")
            out[k] = _blocks(meta, mi, layout,
                             lambda blk, d: torch.zeros(blk.shape, dtype=dtype, device=d))
    return out


def shard_cache(cache: dict, mi) -> dict:
    """A one-device cache -> a copy laid out over ``mi`` (the grid [batch
    block][sequence shard] of blocks on their devices); ``pos`` on the
    mesh's first device."""
    some = next(v for k, v in cache.items() if k != "pos")
    layout = _cache_layout(mi, some.shape[1], some.shape[2])
    if layout is None:
        raise ValueError("the mesh's model axis is 1: the cache keeps its one-device layout")
    out = {k: _blocks(v, mi, layout, lambda blk, d: blk.to(d, copy=True))
           for k, v in cache.items() if k != "pos"}
    out["pos"] = cache["pos"].to(mi.mesh.devices[0], copy=True)
    return out


def gather_cache(cache: dict) -> dict:
    """A cache laid out over a mesh -> one-device tensors on its first
    block's device (a copy)."""
    def cat(grid):
        dev = grid[0][0].device
        return torch.cat([torch.cat([b.to(dev) for b in row], dim=2) for row in grid], dim=1)

    return {k: (v.clone() if k == "pos" else cat(v)) for k, v in cache.items()}


def _layer_cache(entry, i: int):
    """Layer i of a cache entry: a tensor's row, or the grid of its blocks'
    rows."""
    if isinstance(entry, torch.Tensor):
        return entry[i]
    return [[blk[i] for blk in row] for row in entry]


def _rope_one(x, pos, theta: float):
    """RoPE at one position: x (B, H, d), pos a 0-d tensor."""
    angles = pos.float() * rope_frequencies(x.shape[-1], theta, device=x.device)  # (d / 2,)
    return rotate_halves(x, torch.cos(angles), torch.sin(angles))


def _by_batch_block(fn, x, caches):
    """fn(x rows, the block's caches) for each batch block of a grid, the
    outputs concatenated on x's device; a one-device cache is one block."""
    if isinstance(caches[0], torch.Tensor):
        return fn(x, *caches).to(x.device)
    bl = x.shape[0] // len(caches[0])
    return torch.cat([fn(x[g * bl : (g + 1) * bl], *blocks).to(x.device)
                      for g, blocks in enumerate(zip(*caches))], dim=0)


def _gqa_decode_sharded(ap, cfg: TransformerConfig, h, k_cache, v_cache, pos):
    """Projections, RoPE at ``pos``, the cache write and attention, ``wo`` ->
    (B, D). The caches are a layer's tensors or its grid of blocks."""
    b = h.shape[0]
    hds, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    posh = pos.to(h.device)
    q = _rope_one(ap.wq(h).reshape(b, hds, dh), posh, cfg.rope_theta)
    k_new = _rope_one(ap.wk(h).reshape(b, hkv, dh), posh, cfg.rope_theta)
    qkv = torch.cat([q, k_new, ap.wv(h).reshape(b, hkv, dh)], dim=1)  # (B, H + 2 Hkv, dh)

    def attend(rows, kc, vc):
        q, k_new, v_new = rows.split((hds, hkv, hkv), dim=1)
        return attn.gqa_decode_attend(q, kc, vc, k_new, v_new, pos)[0]

    out = _by_batch_block(attend, qkv, (k_cache, v_cache))
    return ap.wo(out.reshape(b, hds * dh).to(h.dtype))


def _mla_decode_sharded(ap, cfg: TransformerConfig, h, c_cache, pos):
    """``mla_decode_attend`` on each batch block of a layer's latent cache
    (its tensor, or its grid of blocks) -> (B, D)."""
    return _by_batch_block(lambda x, c: attn.mla_decode_attend(ap, cfg, x, c, pos)[0], h,
                           (c_cache,))


def decode_step(model: Transformer, cache: dict, tokens, mi=None):
    """One greedy decode step: tokens (B,) int32 at ``cache["pos"]`` ->
    (logits (B, vocab_padded) float32, the cache with ``pos`` + 1). Layer
    l's rows are written into the cache in place; the returned cache holds
    the same tensors. With ``mi`` (model axis > 1) the cache must be laid
    out over it (``init_cache`` / ``shard_cache``)."""
    cfg = model.cfg
    pos = cache["pos"]
    keys = ("c",) if cfg.attn_type == "mla" else ("k", "v")
    sharded = mi is not None and mi.tp_size > 1
    if sharded != (not isinstance(cache[keys[0]], torch.Tensor)):
        raise ValueError("the cache's layout does not match the mesh: lay it out with "
                         "init_cache(..., mi=mi) or shard_cache")
    x = model.embed.table[tokens.long()].to(cfg.compute_dtype)  # (B, D)
    for i, lp in enumerate(model.layers()):
        layer = [_layer_cache(cache[k], i) for k in keys]
        h = lp.ln1(x)
        if cfg.attn_type == "mla":
            a = _mla_decode_sharded(lp.attn, cfg, h, layer[0], pos)
        else:
            a = _gqa_decode_sharded(lp.attn, cfg, h, layer[0], layer[1], pos)
        x = x + a
        x = x + lp.feed_forward(lp.ln2(x)[:, None], mi)[:, 0]
    logits = model.lm_head(model.final_norm(x)).float()
    return logits, dict(cache, pos=pos + 1)
