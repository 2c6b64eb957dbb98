"""AdamW and Adafactor (port of ``repro.train.optimizer``) as plain functions
on a name-to-tensor dict.

Parameters, gradients and state are dicts keyed by the port's parameter
names (``train_step.reference_layout``), each tensor in the reference's
layout (a linear layer's weight as (in, out)), so that Adafactor factors
the same dimensions as the reference and state carries across
(``interop.adamw_state_from_reference``). State keys are the reference's:
``m``, ``v`` and ``count`` (AdamW), ``vr``, ``vc``, ``count`` and, with
momentum, ``m`` (Adafactor).

Each element goes through the reference's arithmetic in its order;
scalars of the step (``count``, the bias corrections, ``beta2``) are
float32 tensors on the parameters' device, so that a division by one is a
division on the card too (PyTorch's CUDA kernels multiply by the
reciprocal of a host scalar). Unlike the reference's pure functions,
``update`` writes the new moments into the state's tensors and returns
that state, and AdamW writes each update into its gradient's buffer where
that is a float32 tensor of its own (the gradients are consumed), so the
step holds params, grads and two moments and no more than two more
tensors of one leaf's size; Adafactor computes its step in vhat's buffer
and squares it into g^2's, so it holds at most three float32 tensors of
one leaf's size beside the state. ``apply_updates`` adds in place.
``state_specs`` derives the state's layout over a mesh from the
parameters' specs (``distributed/layout.py``), as the reference's ZeRO
layout does: a moment as its parameter, Adafactor's row statistics
``vr`` by the spec without its last entry and its column statistics
``vc`` by the spec without its second-to-last.

A leaf may be a ``Blocks`` (a resident leaf over a mesh): its gradient,
state and update are ``Blocks`` then, each part computed on its device
(``train_step.init_state`` lays the state out). AdamW updates each part
alone (every element's update reads only that element). Adafactor's
reductions cross the blocks, and each sums the blocks' partial sums in
part order, taking one part of each block (its first replica), the order
``train_step.global_norm`` adds in:

  * ``vr``: the mean over the last dimension, the row sums of the blocks
    that split it added in part order, then divided by its length;
  * ``vc``: the mean over the second-to-last dimension likewise, from the
    column sums;
  * the mean of ``vr`` over its last dimension (vhat's denominator), from
    ``vr``'s blocks' row sums;
  * the update's RMS for the clip: every block's sum of squares in part
    order, divided by the leaf's size.

Each sum is taken on the device of its first block's part and moved to
the others; a block's replicas take the first replica's statistics and
update (copies), so they stay equal bit for bit. A whole leaf takes
``mean`` instead (its own reduction order), so a leaf split into blocks
is updated within rounding of the whole leaf's update, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.distributed.layout import Blocks
from repro_torch.distributed.meshinfo import sum_in_order

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], dict]
    update: Callable[[Tree, dict, Tree], tuple]  # (grads, state, params) -> (updates, state)
    state_specs: Callable[[dict, Tree], dict]  # (param specs, params) -> the state's specs


def _device(params: Tree) -> torch.device:
    return next(iter(params.values())).device


def _first_replicas(b: Blocks) -> list:
    """One part of each block of ``b`` (its first), in part order."""
    return [group[0] for group in b.layout.replicas()]


def _total(xs: list, dev) -> torch.Tensor:
    """``xs`` added in order on ``dev`` (one tensor: itself, no move)."""
    return xs[0].to(dev) if len(xs) == 1 else sum_in_order(xs, dev)


def _writable(g: torch.Tensor, dtype) -> bool:
    """``g`` can take its own update: the state's dtype, and no two elements
    on one address (an expanded gradient has a stride of 0)."""
    return g.dtype == dtype and all(st > 0 or n == 1 for st, n in zip(g.stride(), g.shape))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {
            "m": {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=_device(params)),
        }

    def one(g, m, v, p, c1, c2):
        g32 = g.to(state_dtype)
        m.mul_(b1).add_(g32 * (1 - b1))
        t = g32 * (1 - b2)
        v.mul_(b2).add_(t.mul_(g32))
        step = g32 if _writable(g, state_dtype) else torch.empty_like(m)
        torch.div(m, c1, out=step)  # mhat, into the gradient's buffer
        t = torch.div(v, c2, out=t).sqrt_().add_(eps)  # sqrt(vhat) + eps
        step.div_(t)
        del t
        if weight_decay:
            step.add_(p.to(state_dtype) * weight_decay)
        return step.mul_(-lr).to(p.dtype)

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c1 = 1.0 - torch.pow(_f32(b1, count), count.float())
        c2 = 1.0 - torch.pow(_f32(b2, count), count.float())
        updates = {}
        for k, g in grads.items():
            m, v, p = state["m"][k], state["v"][k], params[k]
            if isinstance(g, Blocks):  # each part alone, on its device
                updates[k] = Blocks(g.layout, [
                    one(gp, mp, vp, pp, c1.to(pp.device), c2.to(pp.device))
                    for gp, mp, vp, pp in zip(g.parts, m.parts, v.parts, p.parts)])
            else:
                updates[k] = one(g, m, v, p, c1, c2)
        return updates, dict(state, count=count)

    def state_specs(specs, params):
        return {"m": dict(specs), "v": dict(specs), "count": ()}

    return Optimizer(init=init, update=update, state_specs=state_specs)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored over the last two dims
# ---------------------------------------------------------------------------
def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, momentum: Optional[float] = None,
              momentum_dtype=torch.bfloat16) -> Optimizer:
    def factored(p) -> bool:
        return len(p.shape) >= 2

    def init(params):
        def vr(p):
            shape = p.shape[:-1] if factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = p.shape[:-2] + p.shape[-1:] if factored(p) else (1,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        state = {
            "vr": {k: vr(p) for k, p in params.items()},
            "vc": {k: vc(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=_device(params)),
        }
        if momentum is not None:
            state["m"] = {k: torch.zeros(p.shape, dtype=momentum_dtype, device=p.device)
                          for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        beta2 = 1.0 - torch.pow(count.float(), -decay)
        one_minus = 1 - beta2
        updates = {}
        for k, g in grads.items():
            p, vr, vc = params[k], state["vr"][k], state["vc"][k]
            if isinstance(g, Blocks):
                m = state["m"][k] if momentum is not None else None
                updates[k] = blocks_update(g, p, vr, vc, m, beta2, one_minus)
                continue
            g32 = g.float()
            g2 = torch.mul(g32, g32).add_(eps)
            if factored(p):
                vr.copy_(beta2 * vr + one_minus * g2.mean(-1))
                vc.copy_(beta2 * vc + one_minus * g2.mean(-2))
                denom = torch.maximum(vr.mean(-1, keepdim=True), _f32(eps, vr))
                step = (vr[..., None] / denom[..., None]) * vc[..., None, :]  # vhat
            else:
                vr.copy_(beta2 * vr + one_minus * g2)
                step = vr.clone()
            step = torch.div(g32, step.add_(eps).sqrt_(), out=step)
            # Update clipping (RMS-based), per Adafactor; the square into g2's
            # buffer.
            rms = torch.sqrt(torch.mul(step, step, out=g2).mean() + 1e-30)
            del g2
            step.div_(torch.maximum(_f32(1.0, rms), rms / _f32(clip_threshold, rms)))
            if momentum is not None:
                m = state["m"][k]
                step.add_(m.float().mul_(momentum))  # momentum * m + step
                m.copy_(step)  # rounds to momentum_dtype
            updates[k] = step.mul_(-lr).to(p.dtype)
        return updates, dict(state, count=count)

    def refresh(stat: Blocks, g2: dict, lay, dim: int, n: int, beta2, one_minus) -> None:
        """A statistic's blocks <- beta2 s + (1 - beta2) mean(g2, dim): each
        block's mean from the sums of the parameter blocks that split ``dim``,
        added in part order on the statistic's first part of that block, its
        other parts copies."""
        rows: dict = {}
        for i in g2:  # the parameter's first replicas, in part order
            rows.setdefault(lay.block[i][:dim] + lay.block[i][dim + 1:], []).append(i)
        for key, idx in rows.items():
            held = [j for j, b in enumerate(stat.layout.block) if b == key]
            s0 = stat.parts[held[0]]
            mean = _total([g2[i].sum(dim) for i in idx], s0.device) / n
            s0.copy_(beta2.to(s0.device) * s0 + one_minus.to(s0.device) * mean)
            for j in held[1:]:
                stat.parts[j].copy_(s0)

    def blocks_update(g: Blocks, p: Blocks, vr: Blocks, vc: Blocks, m, beta2, one_minus):
        """One resident leaf's update (the module docstring's reductions)."""
        lay = p.layout
        first = _first_replicas(p)
        at = {i: lay.index.index(i) for i in first}  # a position that holds part i

        def held(stat: Blocks, i: int) -> torch.Tensor:
            return stat.parts[stat.layout.index[at[i]]]

        g32 = {i: g.parts[i].float() for i in first}
        g2 = {i: torch.mul(g32[i], g32[i]).add_(eps) for i in first}
        nd = len(p.shape)
        steps = {}
        if nd >= 2:
            refresh(vr, g2, lay, nd - 1, p.shape[-1], beta2, one_minus)
            refresh(vc, g2, lay, nd - 2, p.shape[-2], beta2, one_minus)
            rows: dict = {}  # vhat's denominator: vr's mean over its last dimension
            for j in _first_replicas(vr):
                rows.setdefault(vr.layout.block[j][:-1], []).append(vr.parts[j])
            denom = {}
            for key, parts in rows.items():
                mean = _total([x.sum(-1, keepdim=True) for x in parts],
                              parts[0].device) / vr.shape[-1]
                denom[key] = torch.maximum(mean, _f32(eps, mean))
            for i in first:
                r, c = held(vr, i), held(vc, i)
                d = denom[lay.block[i][:-2]].to(r.device)
                step = (r[..., None] / d[..., None]) * c[..., None, :]  # vhat
                steps[i] = torch.div(g32[i], step.add_(eps).sqrt_(), out=step)
        else:
            for group in lay.replicas():  # vr is laid out as the parameter
                i, r = group[0], vr.parts[group[0]]
                r.copy_(beta2.to(r.device) * r + one_minus.to(r.device) * g2[i])
                for j in group[1:]:
                    vr.parts[j].copy_(r)
                step = r.clone()
                steps[i] = torch.div(g32[i], step.add_(eps).sqrt_(), out=step)
        dev = steps[first[0]].device
        squares = _total([torch.mul(steps[i], steps[i], out=g2[i]).sum() for i in first], dev)
        del g2
        rms = torch.sqrt(squares / math.prod(p.shape) + 1e-30)
        scale = torch.maximum(_f32(1.0, rms), rms / _f32(clip_threshold, rms))
        out = [None] * len(p.parts)
        for i in first:
            step = steps.pop(i).div_(scale.to(g32[i].device))
            if m is not None:
                mi = held(m, i)
                step.add_(mi.float().mul_(momentum))  # momentum * m + step
                mi.copy_(step)  # rounds to momentum_dtype
            out[i] = step.mul_(-lr).to(p.dtype)
        for group in lay.replicas():  # a block's replicas: the first's update and moment
            for j in group[1:]:
                out[j] = out[group[0]].to(p.parts[j].device)
                if m is not None:
                    m.parts[m.layout.index[lay.index.index(j)]].copy_(held(m, group[0]))
        return Blocks(lay, out)

    def state_specs(specs, params):
        def full(k):
            return tuple(specs[k]) + (None,) * (len(params[k].shape) - len(specs[k]))

        out = {"vr": {k: full(k)[:-1] if factored(p) else full(k) for k, p in params.items()},
               "vc": {k: full(k)[:-2] + full(k)[-1:] if factored(p) else (None,)
                      for k, p in params.items()},
               "count": ()}
        if momentum is not None:
            out["m"] = dict(specs)
        return out

    return Optimizer(init=init, update=update, state_specs=state_specs)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """p <- p + u, in place, a ``Blocks`` leaf part by part (the reference
    returns new arrays of the same values)."""
    for k, p in params.items():
        u = updates[k]
        for pp, up in (zip(p.parts, u.parts) if isinstance(p, Blocks) else ((p, u),)):
            pp.add_(up.to(pp.dtype))
    return params
