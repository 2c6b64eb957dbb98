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

Training (``lm_loss``) runs on one device or over a mesh. Over a mesh of
more than one position every leaf is resident as the reference's blocks
(``make_resident``, by ``param_specs``: the (fs, tp) and (tp, fs) products,
the embedding (tp, fs), ``lm_head`` and MTP's ``proj`` (fs, tp), the
experts by ``moe_specs``; the norms' scales and the router one replica a
device; stacked layer lists with a leading whole layer axis), and
``lm_loss`` refuses a model with a whole leaf there. The step then runs
tensor-parallel (``distributed/tensor_parallel.py``): each data group on
its own row of devices, the residual stream whole on each model position
of a group, each position computing its own heads (``attention.py``), its
own feed-forward columns (the dense FFN and the shared experts: ``w1`` /
``w3`` column-parallel, ``w2`` row-parallel), its own experts
(``moe.py``) and its own vocabulary block (the embedding's rows, summed
over the positions; the cross-entropy's logits, combined by the
log-sum-exp rule). The positions that one device holds (a mesh that
repeats a device) run as one batched call: a dense model's step over a
(g, 1) mesh of one device is one device's, bit for bit. ``prefill_logits``
and ``decode_step`` take the same path on a resident model (the decode
step: each model position scores its own sequence shard of the cache,
which lies on its device; ``attention.py``). Over a (g, 1) mesh a resident
MoE takes each data group's capacity, where the reference's decode and
train step take one over all tokens (its expert-parallel branch needs a
model axis > 1): the MoE's routes may differ there (ROADMAP Queue 3).
``cfg.remat`` rematerialises
each layer and each cross-entropy chunk in the backward where autograd
records (``"full"``: nothing saved; ``"dots"``: the products without
batch dimensions saved; ``"none"``: everything saved), as the reference's
``jax.checkpoint`` policies do; the serving paths run under
``inference_mode`` and never checkpoint. ``sequence_parallel`` shapes the
reference's layouts and does nothing here: the residual stream is whole on
every model position of a group.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Optional

import torch
import torch.nn.functional as F
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
)
from repro_torch.models.recsys.models import fill_normal_
from repro_torch.models.transformer import attention as attn
from repro_torch.distributed import layout
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.layout import Resident, flat_specs, stacked
from repro_torch.distributed.meshinfo import sum_in_order
from repro_torch.models.transformer.moe import (
    MoE,
    SwiGLU,
    aux_of_probs,
    moe_ffn_tp,
    moe_specs,
    router_aux_loss,
)
from repro_torch.roofline import collectives


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


def _dense_ffn_specs(cfg: TransformerConfig, mi) -> dict:
    fs, tp = mi.fsdp_axis, mi.tp_axis
    return {"w1": {"w": (fs, tp)}, "w3": {"w": (fs, tp)}, "w2": {"w": (tp, fs)}}


def _layer_specs(cfg: TransformerConfig, mi, kind: str) -> dict:
    return {"ln1": {"scale": (None,)}, "ln2": {"scale": (None,)},
            "attn": attn.mla_specs(cfg, mi) if cfg.attn_type == "mla" else attn.gqa_specs(cfg, mi),
            "ffn": moe_specs(cfg, mi) if kind == "moe" else _dense_ffn_specs(cfg, mi)}


def param_specs(cfg: TransformerConfig, mi) -> dict:
    """The reference's layout (``param_specs``) of every parameter over
    ``mi``: {the port's name, as ``train.reference_layout`` gives it: a
    spec, one entry a dimension of that (reference-layout) leaf}. The
    embedding (model, data), ``lm_head`` (data, model), the stacked layer
    lists with a leading whole layer axis."""
    fs, tp = mi.fsdp_axis, mi.tp_axis
    p = {"embed": {"table": (tp, fs)}, "final_norm": {"scale": (None,)},
         "lm_head": {"w": (fs, tp)}}
    if cfg.n_dense:
        p["dense_layers"] = stacked(_layer_specs(cfg, mi, "dense"))
    if cfg.n_moe:
        p["moe_layers"] = stacked(_layer_specs(cfg, mi, "moe"))
    if cfg.mtp:
        p["mtp"] = {"proj": {"w": (fs, tp)}, "layer": _layer_specs(cfg, mi, "dense"),
                    "norm": {"scale": (None,)}}
    return flat_specs(p)


def resident_names(cfg: TransformerConfig, mi) -> list:
    """The leaves that a train step over ``mi`` holds as their blocks: every
    leaf of ``param_specs`` where ``mi`` has more than one position, else
    none."""
    if mi is None or len(mi.mesh.devices) == 1:
        return []
    return list(param_specs(cfg, mi))


def make_resident(model: Transformer, mi) -> Transformer:
    """Over ``mi``, every leaf of the model becomes resident as its blocks
    (``resident_names``), in place, and its whole tensor is let go; a leaf
    already resident is left as it is. A dimension that the mesh does not
    divide raises (``layout.shard_shape``)."""
    names = resident_names(model.cfg, mi)
    if names:
        layout.make_resident(model, param_specs(model.cfg, mi), mi, names)
    return model


def _check_layout(model: Transformer, mi) -> None:
    """A train step over a mesh of more than one position reads every leaf
    as its blocks: a whole leaf there raises (it is never copied
    quietly)."""
    if resident_names(model.cfg, mi):
        whole = layout.whole_leaves(model)
        if whole:
            raise ValueError(f"{len(whole)} leaves ({whole[0]}, ...) are whole over a mesh whose "
                             f"layout holds them as blocks: make the model resident first "
                             f"(models.transformer.model.make_resident)")


def _resident(model: Transformer, mi) -> bool:
    """Whether ``model`` is resident (the mesh path); it must be resident on
    ``mi``'s mesh."""
    if not isinstance(model.embed.table, Resident):
        return False
    if mi is None or model.embed.table.layout.mesh != mi.mesh:
        raise ValueError("a resident model runs over the mesh it was laid out on")
    return True


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
    ``mi`` (a ``MeshInfo``) decides the MoE's branch; a resident model runs
    over it tensor-parallel (``_hidden_tp``), its groups' rows joined on the
    mesh's first device."""
    cfg = model.cfg
    if _resident(model, mi):
        grid = _grid(tokens, mi)
        return grid.join_groups(_hidden_tp(model, tokens, grid))
    x = model.embed.table[tokens.long()].to(cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in model.layers():
        x = _remat(cfg, functools.partial(_layer_apply, cfg, lp, positions=positions, mi=mi), x)
    return model.final_norm(x)


def _ce_terms(logits, labels):
    """Each token's float32 logsumexp - label logit of its whole-vocabulary
    ``logits``."""
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]  # the masked max's value
    return torch.logsumexp(logits, dim=-1) - ll


def _ce_chunk(lm_head: nn.Module, hc, lc, wc):
    """sum((logsumexp - label logit) * w) over one chunk, float32: the logits
    ``hc @ lm_head`` in the compute dtype, then float32."""
    return (_ce_terms(lm_head(hc).float(), lc) * wc).sum()


def _chunked_ce(cfg: TransformerConfig, h, lm_head: nn.Module, labels, weights):
    """Cross-entropy over ``cfg.ce_chunk`` positions at a time, never the
    whole (B, S, V) logits: sum((lse - ll) * w) / max(sum(w), 1), the sums
    float32 in chunk order; each chunk under ``cfg.remat``'s checkpoint, so
    its float32 logits live one chunk at a time in the backward too."""
    s = h.shape[1]
    chunk = _ce_chunk_size(cfg, s)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    wsum = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        part = slice(lo, lo + chunk)
        tot = tot + _remat(cfg, functools.partial(_ce_chunk, lm_head), h[:, part],
                           labels[:, part], weights[:, part])
        wsum = wsum + weights[:, part].sum()
    return tot / torch.clamp_min(wsum, 1.0)


def _ce_chunk_size(cfg: TransformerConfig, s: int) -> int:
    chunk = min(cfg.ce_chunk, s)
    if s % chunk:
        raise ValueError(f"a sequence of {s} does not split into chunks of {chunk}")
    return chunk


# ---------------------------------------------------------------------------
# over a mesh: resident blocks, tensor-parallel (distributed/tensor_parallel.py)
# ---------------------------------------------------------------------------
def _grid(tokens, mi) -> tpar.Grid:
    return tpar.Grid(mi, tpar.n_groups(mi, tokens.shape[0]))


def _embed_tp(model: Transformer, tokens, grid) -> list:
    """The vocabulary-parallel embedding: ``tokens`` (B, S) -> a group value
    (Bl, S, D) in the compute dtype. Each model position reads the rows of
    its vocabulary block (zeros for the other ids) from its blocks over the
    data positions, joined in position order where the data axes split D
    (one all-gather); the reads are summed over the model positions (one
    all-reduce), as ``models/recsys/models.py::mesh_lookup`` reads a
    table's row blocks."""
    table, mi = model.embed.table, grid.mi
    blocks = table.grid(mi)  # (data positions, model shards)
    split = tpar.data_dim(table.layout, mi) is not None
    vb = table.shape[0] // grid.tp
    reads = []
    for i, (p, ids) in enumerate(zip(grid.parts, grid.split(tokens))):
        g, mp = len(p.gs), len(p.ms)
        first = grid.model_index(i, ids.device)[:, None, None] * vb
        local = ids.long()[None] - first  # (Mp, G B, S)
        hit = (local >= 0) & (local < vb)
        local = local.clamp(0, vb - 1)
        at = torch.arange(mp, device=ids.device)[:, None, None]
        read = []
        for d in range(blocks.shape[0]) if split else [p.gs[0]]:
            blk = tpar.stacked([blocks[d, m] for m in p.ms])  # (Mp, V / tp, D / data)
            read.append(blk[at.to(blk.device), local.to(blk.device)].to(p.device))
        if split:
            tallies = collectives.open_tallies() if 0 in p.gs and 0 in p.ms else ()
            read = tpar.gather_into(tallies, p.device, read, g * mp)
        else:
            read = read[0]
        read = torch.where(hit[..., None], read, 0.0)  # (Mp, G B, S, D)
        reads.append(read.reshape(mp, g, -1, *read.shape[2:]).transpose(0, 1)
                     .reshape(-1, *read.shape[2:]))
    return grid.each(lambda x: x.to(model.cfg.compute_dtype), grid.row_sum(reads))


def _layer_tp(cfg: TransformerConfig, lp: Layer, xs: list, grid, attend=None) -> list:
    """``_layer_apply`` over a mesh: the residual stream (a group value) ->
    the same after the layer. Each part reads its blocks (gathered over the
    data positions where those split them) and its norms' replicas;
    attention and the feed-forward are tensor-parallel, their outputs
    summed over the model positions. ``attend(views, h)``: the attention
    (the decode step's); by default the causal prefill / training one."""
    views = grid.views(lp)
    h = grid.each(lambda v, x: v.ln1(x), views, xs)
    at = [v.attn for v in views]
    if attend is None:
        a = (attn.mla_train_tp if cfg.attn_type == "mla" else attn.gqa_train_tp)(at, cfg, h, grid)
    else:
        a = attend(at, h)
    xs = grid.each(torch.add, xs, a)
    h = grid.each(lambda v, x: v.ln2(x), views, xs)
    ffn = [v.ffn for v in views]
    if lp.kind == "moe":
        f = moe_ffn_tp(ffn, cfg, h, grid)
    else:  # w1 / w3 column-parallel, w2 row-parallel
        f = grid.row_sum(grid.each(lambda v, x: v(x), ffn, h))
    return grid.join(grid.each(torch.add, xs, f))  # one node recomputes the layer


def _apply_tp(module: nn.Module, xs: list, grid) -> list:
    """``module`` (a norm) as each part holds it, applied to its entry of
    ``xs``."""
    return grid.each(lambda v, x: v(x), grid.views(module), xs)


def _hidden_tp(model: Transformer, tokens, grid) -> list:
    """``forward_hidden`` of a resident model over ``grid``: the final
    normed hidden states, a group value."""
    cfg = model.cfg
    xs = _embed_tp(model, tokens, grid)
    for lp in model.layers():
        xs = _remat(cfg, functools.partial(_layer_tp, cfg, lp, grid=grid), xs)
    return _apply_tp(model.final_norm, xs, grid)


def _ce_terms_tp(cfg: TransformerConfig, grid, heads: list, hs: list, ls: list) -> list:
    """A chunk's float32 terms lse - label logit, (Bl, chunk) for each row
    of ``grid`` on its first device: each model position computes its
    vocabulary block's float32 logits (``heads``: ``lm_head``'s
    column-parallel ``Product``), their max, its sum of exponentials and the
    label's logit where its block holds the label (0 elsewhere); the
    maxima are combined over the positions, each sum corrected to the
    combined max, and the sums and label logits added in position order
    (``attention._lse_combine``'s rule: one pmax and two psums). On one
    model position the terms are ``_ce_chunk``'s."""
    vb = cfg.vocab_padded // grid.tp
    stats = []
    for i, (p, head, h, lab) in enumerate(zip(grid.parts, heads, hs, ls)):
        logits = head(h).float()  # a position value (G Mp Bl, chunk, V / tp)
        first = grid.model_index(i, h.device).reshape(1, -1, 1)
        first = first.expand(len(p.gs), -1, h.shape[0] // len(p.gs)).reshape(-1, 1) * vb
        local = grid.spread(i, lab).long() - first
        if grid.tp == 1:
            stats.append(_ce_terms(logits, local))
            continue
        mx = logits.detach().amax(-1)
        hit = (local >= 0) & (local < vb)
        ll = torch.gather(logits, -1, local.clamp(0, vb - 1)[..., None])[..., 0]
        stats.append((mx, torch.exp(logits - mx[..., None]).sum(-1), torch.where(hit, ll, 0.0)))
    out = []
    for row in grid.rows:
        if grid.tp == 1:
            out.append(stats[row[0]])
            continue
        mx, se, ll = (grid.slices(row, [stats[i][k] for i in range(len(stats))])
                      for k in range(3))  # (G, Bl, chunk) a model position
        dev = mx[0].device
        maxima = [x.to(dev) for x in mx]
        m_g = maxima[0]
        for x in maxima[1:]:
            m_g = torch.maximum(m_g, x)
        l_g = ll_g = None
        for x, sx, lx in zip(maxima, se, ll):
            t = sx.to(dev) * torch.exp(x - m_g)
            l_g = t if l_g is None else l_g + t
            ll_g = lx.to(dev) if ll_g is None else ll_g + lx.to(dev)
        collectives.record_into(grid.tallies(row), "all-reduce", m_g[0], l_g[0], ll_g[0])
        out.append((torch.log(l_g) + m_g - ll_g).reshape(-1, m_g.shape[-1]))
    return grid.join(out)


def _chunked_ce_tp(cfg: TransformerConfig, grid, hs: list, heads: list, labels, weights):
    """``_chunked_ce`` over a mesh, vocabulary-parallel: ``hs`` the hidden
    states (a group value), ``heads`` ``lm_head``'s column-parallel products,
    ``labels`` / ``weights`` (B, S) on the mesh's first device. Each chunk's
    per-token terms come under ``cfg.remat``'s checkpoint
    (``_ce_terms_tp``); the rows' terms are joined in group order on the
    first device (one all-gather where there are rows to join) and the
    chunk sums taken there in chunk order, as on one device."""
    s = hs[0].shape[1]
    chunk = _ce_chunk_size(cfg, s)
    lab = grid.split(labels)
    dev = weights.device
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    wsum = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, s, chunk):
        part = slice(lo, lo + chunk)
        terms = _remat(cfg, functools.partial(_ce_terms_tp, cfg, grid, heads),
                       [h[:, part] for h in hs], [x[:, part] for x in lab])
        joined = torch.cat([t.to(dev) for t in terms], dim=0)
        if grid.groups > 1:
            collectives.record("all-gather", tpar.one(joined, grid.groups))
        tot = tot + (joined * weights[:, part]).sum()
        wsum = wsum + weights[:, part].sum()
    return tot / torch.clamp_min(wsum, 1.0)


def _router_aux_tp(mp: MoE, grid, hs: list):
    """``router_aux_loss`` over a mesh: each row's tokens through the
    router's replica on its first part; with more than one data group the
    groups' top-1 counts and probabilities are summed in group order (one
    all-reduce each) and divided by the token count."""
    router = grid.views(mp.router)
    probs = [torch.softmax(router[row[0]](hs[row[0]].float()), dim=-1) for row in grid.rows]
    if grid.groups == 1:
        return aux_of_probs(probs[0])
    e = probs[0].shape[-1]
    per_group = [g for p, row in zip(probs, grid.rows)
                 for g in p.reshape(len(grid.parts[row[0]].gs), -1, e)]
    counts = [F.one_hot(g.argmax(-1), e).float().sum(0) for g in per_group]
    sums = [g.sum(0) for g in per_group]
    dev, n = probs[0].device, sum(g.shape[0] for g in per_group)
    frac_tokens, frac_probs = sum_in_order(counts, dev) / n, sum_in_order(sums, dev) / n
    return e * (frac_tokens * frac_probs).sum()


def _lm_loss_tp(model: Transformer, tokens, mi):
    """``lm_loss`` of a resident model over ``mi``: the same terms, each
    data group on its row of devices and each model position on its
    blocks; the MTP block's ``proj`` is column-parallel, its output
    gathered over the model positions before ``mtp.layer``."""
    cfg = model.cfg
    grid = _grid(tokens, mi)
    hs = _hidden_tp(model, tokens, grid)
    heads = grid.products(model.lm_head)
    labels, weights = _shifted(tokens, 1)
    loss = _chunked_ce_tp(cfg, grid, hs, heads, labels, weights)
    metrics = {"ce": loss}
    if cfg.mtp:
        emb_next = _embed_tp(model, labels, grid)
        both = grid.each(lambda h, e: torch.cat([h.to(cfg.compute_dtype), e], dim=-1), hs,
                         emb_next)
        h2 = grid.gather(grid.each(lambda f, x: f(x), grid.products(model.mtp.proj), both))
        h2 = _apply_tp(model.mtp.norm, _layer_tp(cfg, model.mtp.layer, h2, grid), grid)
        labels2, weights2 = _shifted(tokens, 2)
        mtp_loss = _chunked_ce_tp(cfg, grid, h2, heads, labels2, weights2)
        metrics["mtp_ce"] = mtp_loss
        loss = loss + cfg.mtp_coef * mtp_loss
    if cfg.is_moe and cfg.router_aux_coef > 0:
        aux = _router_aux_tp(model.moe_layers[-1].ffn, grid, hs)
        metrics["router_aux"] = aux
        loss = loss + cfg.router_aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics


def _last_logits_tp(model: Transformer, grid, hs: list):
    """The last position's float32 logits of the final hidden states ``hs``
    (a group value): each position's vocabulary block, gathered over the
    model positions, the groups' rows joined on the mesh's first device."""
    logits = grid.each(lambda f, h: f(h[:, -1]).float(), grid.products(model.lm_head), hs)
    return grid.join_groups(grid.gather(logits))


def _prefill_tp(model: Transformer, tokens, mi):
    """``prefill_logits`` of a resident model over ``mi``."""
    grid = _grid(tokens, mi)
    return _last_logits_tp(model, grid, _hidden_tp(model, tokens, grid))


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
    _check_layout(model, mi)
    if _resident(model, mi):
        return _lm_loss_tp(model, tokens, mi)
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
    float32; a resident model's over its mesh (``_prefill_tp``)."""
    if _resident(model, mi):
        return _prefill_tp(model, tokens, mi)
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


def _by_batch_block(fn, x, caches):
    """fn(x rows, the block's caches) for each batch block of a grid, the
    outputs concatenated on x's device; a one-device cache is one block."""
    if isinstance(caches[0], torch.Tensor):
        return fn(x, *caches).to(x.device)
    bl = x.shape[0] // len(caches[0])

    def block(g, blocks):
        with collectives.group(g):
            return fn(x[g * bl : (g + 1) * bl], *blocks).to(x.device)

    return torch.cat([block(g, blocks) for g, blocks in enumerate(zip(*caches))], dim=0)


def _gqa_decode_sharded(ap, cfg: TransformerConfig, h, k_cache, v_cache, pos):
    """Projections, RoPE at ``pos``, the cache write and attention, ``wo`` ->
    (B, D). The caches are a layer's tensors or its grid of blocks."""
    b = h.shape[0]
    hds, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    posh = pos.to(h.device)
    q = attn.rope_one(ap.wq(h).reshape(b, hds, dh), posh, cfg.rope_theta)
    k_new = attn.rope_one(ap.wk(h).reshape(b, hkv, dh), posh, cfg.rope_theta)
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


def _decode_tp(model: Transformer, cache: dict, tokens, mi, keys: tuple):
    """``decode_step`` of a resident model over ``mi``, tensor-parallel: the
    vocabulary-parallel embedding of the new tokens, each layer as
    ``_layer_tp`` runs it with the decode attention (``attention.py``:
    ``gqa_decode_tp`` / ``mla_decode_tp``, each position on its own
    sequence shard of the cache, which lies on its device), the final norm
    and the head as the resident prefill's -> the logits on the mesh's
    first device."""
    cfg = model.cfg
    grid = _grid(tokens, mi)
    entry = cache[keys[0]]
    if not isinstance(entry, torch.Tensor) and (
            len(entry) != grid.groups or any(len(row) != grid.tp for row in entry)):
        raise ValueError("the cache's layout does not match the mesh: lay it out with "
                         "init_cache(..., mi=mi) or shard_cache")
    pos = cache["pos"]
    xs = _embed_tp(model, tokens[:, None], grid)  # (G B, 1, D) a part
    for i, lp in enumerate(model.layers()):
        layer = [_layer_cache(cache[k], i) for k in keys]
        if cfg.attn_type == "mla":
            def attend(views, h, c=layer[0]):
                return attn.mla_decode_tp(views, cfg, h, c, pos, grid)
        else:
            def attend(views, h, k=layer[0], v=layer[1]):
                return attn.gqa_decode_tp(views, cfg, h, k, v, pos, grid)
        xs = _layer_tp(cfg, lp, xs, grid, attend)
    return _last_logits_tp(model, grid, _apply_tp(model.final_norm, xs, grid))


def decode_step(model: Transformer, cache: dict, tokens, mi=None):
    """One greedy decode step: tokens (B,) int32 at ``cache["pos"]`` ->
    (logits (B, vocab_padded) float32, the cache with ``pos`` + 1). Layer
    l's rows are written into the cache in place; the returned cache holds
    the same tensors. With ``mi`` (model axis > 1) the cache must be laid
    out over it (``init_cache`` / ``shard_cache``). A resident model
    decodes over its mesh tensor-parallel (``_decode_tp``)."""
    cfg = model.cfg
    pos = cache["pos"]
    keys = ("c",) if cfg.attn_type == "mla" else ("k", "v")
    sharded = mi is not None and mi.tp_size > 1
    if sharded != (not isinstance(cache[keys[0]], torch.Tensor)):
        raise ValueError("the cache's layout does not match the mesh: lay it out with "
                         "init_cache(..., mi=mi) or shard_cache")
    if _resident(model, mi):
        return _decode_tp(model, cache, tokens, mi, keys), dict(cache, pos=pos + 1)
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
