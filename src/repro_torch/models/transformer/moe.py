"""DeepSeek-style MoE feed-forward with expert parallelism over the
``model`` axis (port of ``repro.models.transformer.moe``).

Dispatch, as the reference's (fixed shapes, capacity drops):
  * the router runs over all experts: softmax of ``x.float() @ router``
    in float32, cast to x's dtype (bf16 at the published configs);
  * a token's threshold is the top_k-th largest of its cast
    probabilities, and its gate on an expert is the probability where it
    is >= the threshold, else 0: ties select more than top_k experts;
  * gates are renormalised by their sum over all experts (summed across
    the shards under expert parallelism);
  * each expert keeps its best C = max(1, int(capacity_factor * T *
    top_k / E)) tokens by gate weight, ties in ``lax.top_k``'s order (a
    stable descending sort; zero gates tie in bulk), ``valid`` where the
    kept weight is > 0, runs its SwiGLU on them as batched products, and
    adds gate * output into the token rows in x's dtype, expert after
    expert (``out.at[idx].add`` adds in update order; ``index_add_`` one
    expert at a time keeps that order on the card, where one launch over
    all experts would add colliding rows in no fixed order);
  * the always-on shared experts are a dense SwiGLU added last.

Expert parallelism (``moe_ffn`` with a mesh whose model axis divides E):
model shard m holds experts [m E / tp, (m + 1) E / tp) on its mesh
position's device. The tokens split over the data axes where those
divide the batch, and each data group computes its own capacity from its
own token count, so a (2, 2) mesh drops other tokens than a (1, 1) one:
the reference's semantics, kept. The gate sums and the outputs are summed
across the shards in shard order on the group's first device.

A train cell over a mesh holds every parameter resident as the
reference's blocks (``moe_specs``: the experts ``w1`` / ``w3`` (tp, fs,
None), ``w2`` (tp, None, fs); the shared experts (fs, tp) / (tp, fs); the
router one replica a device) and runs ``moe_ffn_tp`` on each data group's
row of devices: position (g, m) routes the group's tokens it holds with
its router replica and runs model shard m's experts in place, gathered
over the data positions where the data axes split D
(``distributed/tensor_parallel.py::Grid.shards``). A model whose experts
are whole (serving) reads model shard m's slice of them (a view on the
parameter's device, else a copy made for the call).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.layout import Resident
from repro_torch.distributed.meshinfo import sum_in_order
from repro_torch.models.common.modules import Dense
from repro_torch.models.recsys.models import stable_topk
from repro_torch.roofline import collectives


class SwiGLU(nn.Module):
    """``w2(silu(x w1) * (x w3))``: ``w1`` / ``w3`` (D -> F), ``w2`` (F -> D),
    no biases (the dense FFN of ``_dense_ffn_init`` and the shared experts
    of ``moe_init``)."""

    def __init__(self, d: int, d_ff: int, *, dtype, device):
        super().__init__()
        self.w1 = Dense(d, d_ff, dtype=dtype, device=device)
        self.w3 = Dense(d, d_ff, dtype=dtype, device=device)
        self.w2 = Dense(d_ff, d, dtype=dtype, device=device)

    def init_(self, generator: torch.Generator) -> "SwiGLU":
        for w in (self.w1, self.w3, self.w2):
            w.init_(generator)
        return self

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Experts(nn.Module):
    """The routed experts' stacked weights: ``w1`` / ``w3`` (E, D, Fe) and
    ``w2`` (E, Fe, D), in the reference's layout."""

    def __init__(self, cfg, device):
        super().__init__()
        e, d, fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.w1 = nn.Parameter(torch.empty((e, d, fe), **kw))
        self.w3 = nn.Parameter(torch.empty((e, d, fe), **kw))
        self.w2 = nn.Parameter(torch.empty((e, fe, d), **kw))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Experts":
        """All three uniform in +-1 / sqrt(D), as the reference draws them."""
        scale = 1.0 / math.sqrt(self.w1.shape[1])
        for w in (self.w1, self.w3, self.w2):
            w.uniform_(-scale, scale, generator=generator)
        return self


class MoE(nn.Module):
    """``moe_init``'s parameters: ``router`` (D -> E, float32 whatever the
    param dtype), ``experts``, and with ``cfg.n_shared_experts`` a
    ``shared`` SwiGLU of width n_shared_experts * d_ff_expert. Calling it
    runs ``moe_ffn``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.router = Dense(cfg.d_model, cfg.n_experts, dtype=torch.float32, device=device)
        self.experts = Experts(cfg, device)
        if cfg.n_shared_experts:
            self.shared = SwiGLU(cfg.d_model, cfg.n_shared_experts * cfg.d_ff_expert,
                                 dtype=cfg.param_dtype, device=device)

    def init_(self, generator: torch.Generator) -> "MoE":
        """The reference's order: router, w1, w3, w2, then the shared w1, w3,
        w2."""
        self.router.init_(generator)
        self.experts.init_(generator)
        if self.cfg.n_shared_experts:
            self.shared.init_(generator)
        return self

    def forward(self, x, mi=None):
        return moe_ffn(self, self.cfg, x, mi)


def moe_specs(cfg, mi) -> dict:
    """The reference's layout of an MoE block over ``mi``: the experts split
    over the model axis (expert parallelism) and their d_model dimension
    over the data axes; the router whole."""
    fs, tp = mi.fsdp_axis, mi.tp_axis
    p = {"router": {"w": (None, None)},
         "experts": {"w1": (tp, fs, None), "w3": (tp, fs, None), "w2": (tp, None, fs)}}
    if cfg.n_shared_experts:
        p["shared"] = {"w1": {"w": (fs, tp)}, "w3": {"w": (fs, tp)}, "w2": {"w": (tp, fs)}}
    return p


def capacity(cfg, t: int, e: int) -> int:
    """Tokens an expert keeps of ``t``: the reference's Python arithmetic."""
    return max(1, int(cfg.capacity_factor * t * cfg.top_k / e))


def _router_probs(mp: MoE, x):
    """(B, S, E) float32 router probabilities of x."""
    return torch.softmax(mp.router(x.float()), dim=-1)


def _gates(pf, top_k: int, lo: int, n: int):
    """pf (T, E): the cast probabilities -> (gate (T, n) of experts [lo, lo +
    n), unnormalised, and its sum over those experts in pf's dtype, taken
    in float32 as ``jnp.sum`` takes a bf16 sum)."""
    thresh = pf.topk(top_k, dim=-1).values[:, -1:]
    local_p = pf[:, lo : lo + n]
    gate = torch.where(local_p >= thresh, local_p, 0.0)
    return gate, gate.float().sum(-1).to(gate.dtype)


def _dispatch(xf, gate, w1, w3, w2, c: int):
    """One shard's experts: each keeps its top-``c`` tokens of ``gate`` (T,
    E_local) in ``lax.top_k``'s tie order, runs its SwiGLU and adds gate *
    output into (T, D) rows in x's dtype, expert after expert."""
    top_w, top_idx = stable_topk(gate.T, c)  # (E_local, C)
    top_idx = top_idx.long()
    valid = top_w > 0
    xg = xf[top_idx]  # (E_local, C, D)
    h = F.silu(torch.bmm(xg, w1.to(xg.dtype))) * torch.bmm(xg, w3.to(xg.dtype))
    y = torch.bmm(h, w2.to(xg.dtype))
    y = y * (top_w * valid)[..., None].to(y.dtype)
    return _scatter_add(top_idx, y, xf.shape[0])


def _scatter_add(top_idx, y, t: int):
    """y (E_local, C, D) added into the (t, D) rows ``top_idx`` (E_local, C)
    in y's dtype, expert after expert: each add rounds, in the order of
    ``out.at[idx].add``. An expert's C tokens are distinct, so one
    ``index_add_`` an expert has no colliding rows."""
    out = torch.zeros((t, y.shape[-1]), dtype=y.dtype, device=y.device)
    for i in range(y.shape[0]):
        out.index_add_(0, top_idx[i], y[i])
    return out


def _moe_local(xs, probs, shards, *, cfg):
    """One data group: ``xs`` its tokens (Bl, S, D) and ``probs`` (Bl, S, E)
    in x's dtype, one copy a model shard on that shard's device;
    ``shards``: (w1, w3, w2) of each model shard's experts, in shard order
    -> (Bl, S, D) on the first shard's device."""
    bl, s, d = xs[0].shape
    e = probs[0].shape[-1]
    t = bl * s
    e_local = shards[0][0].shape[0]
    c = min(capacity(cfg, t, e), t)
    gates, sums = [], []
    for i, p in enumerate(probs):
        gate, local_sum = _gates(p.reshape(t, e), cfg.top_k, i * e_local, e_local)
        gates.append(gate)
        sums.append(local_sum)
    dev0 = xs[0].device
    denom = sum_in_order(sums, dev0)
    outs = []
    for x, gate, (w1, w3, w2) in zip(xs, gates, shards):
        gate = gate / denom.to(x.device).clamp_min(1e-9)[:, None]
        outs.append(_dispatch(x.reshape(t, d), gate, w1, w3, w2, c))
    return sum_in_order(outs, dev0).reshape(bl, s, d)


def _expert_parallel(mp: MoE, cfg, mi, x, probs):
    """The ``shard_map`` branch: the tokens of each data group (the data
    axes split the batch where they divide it, else one group holds it)
    against the experts of each model shard on that group's devices."""
    b = x.shape[0]
    tp = mi.tp_size
    e_local = cfg.n_experts // tp
    devs = mi.mesh.groups(mi.tp_axis)  # (data groups, tp)
    n_groups = mi.dp_size if mi.axes_if_divisible(b, mi.dp_axes) else 1
    bl = b // n_groups
    ex = mp.experts
    outs = []
    for g in range(n_groups):
        rows = slice(g * bl, (g + 1) * bl)
        shards = [tuple(w[m * e_local : (m + 1) * e_local].to(devs[g, m])
                        for w in (ex.w1, ex.w3, ex.w2)) for m in range(tp)]
        xs = [x[rows].to(devs[g, m]) for m in range(tp)]
        ps = [probs[rows].to(devs[g, m]) for m in range(tp)]
        with collectives.group(g):  # the gate sums' and outputs' psums
            outs.append(_moe_local(xs, ps, shards, cfg=cfg).to(x.device))
    return torch.cat(outs, dim=0)


def moe_ffn(mp: MoE, cfg, x, mi=None):
    """(B, S, D) -> (B, S, D) in x's dtype, for a model whose parameters are
    whole. With ``mi`` whose model axis is > 1 and divides E, the
    expert-parallel branch; otherwise every expert over every token on x's
    device. A resident MoE runs ``moe_ffn_tp``."""
    ex = mp.experts
    if isinstance(ex.w1, Resident):
        raise ValueError("resident experts run through moe_ffn_tp (the model's mesh path)")
    probs = _router_probs(mp, x).to(x.dtype)
    if mi is not None and mi.tp_size > 1 and cfg.n_experts % mi.tp_size == 0:
        out = _expert_parallel(mp, cfg, mi, x, probs)
    else:
        out = _moe_local([x], [probs], [(ex.w1, ex.w3, ex.w2)], cfg=cfg)
    if cfg.n_shared_experts:
        out = out + mp.shared(x)
    return out


def moe_ffn_tp(views, cfg, xs, grid) -> list:
    """A resident MoE over a mesh: ``views`` the MoE as each part of
    ``grid`` holds it (``tensor_parallel.Grid.views``: its router's
    replica, its positions' experts as a list of model shards, its columns
    of the shared experts), ``xs`` the tokens (a group value) -> the output
    (a group value). Each data group routes its tokens with the router's
    replica on each part, and each model position's experts take them in
    place (``_moe_local``: each group its own capacity, the gate sums and
    the outputs summed over the positions in position order); the shared
    experts are a tensor-parallel SwiGLU (``w1`` / ``w3`` column-parallel,
    ``w2`` row-parallel), its partials' sum added to the routed outputs
    before the sum is placed on every model position."""
    routed = []
    for row in grid.rows:
        gs = grid.parts[row[0]].gs
        groups = []
        for j, g in enumerate(gs):
            with collectives.group(g):
                toks, probs, shards = [], [], []
                for i in row:
                    x = xs[i].reshape(len(gs), -1, *xs[i].shape[1:])[j]
                    p = _router_probs(views[i], x).to(x.dtype)
                    ex = views[i].experts
                    for w in zip(ex.w1, ex.w3, ex.w2):
                        toks.append(x)
                        probs.append(p)
                        shards.append(w)
                groups.append(_moe_local(toks, probs, shards, cfg=cfg))
        routed.append(torch.cat(groups) if len(groups) > 1 else groups[0])
    if cfg.n_shared_experts:
        return grid.row_sum(grid.each(lambda v, x: v.shared(x), views, xs), base=routed)
    out = [None] * len(grid.parts)
    for row, total in zip(grid.rows, routed):
        for i, x in zip(row, grid.place(row, total)):
            out[i] = x
    return out


def router_aux_loss(mp: MoE, cfg, x):
    """The Switch-style load-balancing loss E * sum(frac_tokens *
    frac_probs) over x's (B, S) tokens, float32 (top-1 by ``argmax``: the
    first of equal maxima)."""
    return aux_of_probs(_router_probs(mp, x))


def aux_of_probs(probs):
    """``router_aux_loss`` of (B, S, E) float32 router probabilities."""
    e = probs.shape[-1]
    frac_tokens = F.one_hot(probs.argmax(-1), e).float().mean(dim=(0, 1))
    return e * (frac_tokens * probs.mean(dim=(0, 1))).sum()


@torch.no_grad()
def routed_experts(mp: MoE, cfg, x):
    """(T, E) bool: the experts each of x's (B, S) tokens selects, by the
    threshold rule on the cast probabilities (ties included)."""
    pf = _router_probs(mp, x).to(x.dtype).reshape(-1, cfg.n_experts)
    return _gates(pf, cfg.top_k, 0, cfg.n_experts)[0] > 0


@torch.no_grad()
def capacity_drops(mp: MoE, cfg, x) -> tuple[int, int]:
    """(routed (token, expert) pairs, pairs dropped by capacity) of one
    ``moe_ffn`` call over x's tokens as one group: an expert keeps min(C,
    its routed tokens), since its top-C by gate weight take the positive
    gates first."""
    per_expert = routed_experts(mp, cfg, x).sum(0)
    t = x.shape[0] * x.shape[1]
    kept = per_expert.clamp_max(min(capacity(cfg, t, cfg.n_experts), t))
    routed = int(per_expert.sum())
    return routed, routed - int(kept.sum())
