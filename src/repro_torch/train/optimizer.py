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
layout does: a moment as its parameter, Adafactor's row and column
statistics from the parameter's leading and last entries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], dict]
    update: Callable[[Tree, dict, Tree], tuple]  # (grads, state, params) -> (updates, state)
    state_specs: Callable[[dict, Tree], dict]  # (param specs, params) -> the state's specs
    elementwise: bool = True  # each element's update reads only that element (a block may go alone)


def _device(params: Tree) -> torch.device:
    return next(iter(params.values())).device


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

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c1 = 1.0 - torch.pow(_f32(b1, count), count.float())
        c2 = 1.0 - torch.pow(_f32(b2, count), count.float())
        updates = {}
        for k, g in grads.items():
            m, v, p = state["m"][k], state["v"][k], params[k]
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
            updates[k] = step.mul_(-lr).to(p.dtype)
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
        return p.dim() >= 2

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

    def state_specs(specs, params):
        def full(k):
            return tuple(specs[k]) + (None,) * (params[k].dim() - len(specs[k]))

        out = {"vr": {k: full(k)[:-1] if factored(p) else full(k) for k, p in params.items()},
               "vc": {k: full(k)[:-2] + full(k)[-1:] if factored(p) else (None,)
                      for k, p in params.items()},
               "count": ()}
        if momentum is not None:
            out["m"] = dict(specs)
        return out

    return Optimizer(init=init, update=update, state_specs=state_specs, elementwise=False)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """p <- p + u, in place (the reference returns new arrays of the same
    values)."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
    return params
