"""Train-step builder (port of ``repro.train.train_step``): loss and
gradients -> optional clipping -> optimizer -> in-place apply, with
optional gradient accumulation over microbatches.

A model is an ``nn.Module``; the optimizer sees its trainable parameters
as a dict in the reference's layout and order (``reference_layout``): the
names are the port's, a 2-D ``weight`` (``nn.Linear``, ``Dense``) is
presented transposed as the reference's (in, out) ``w``, and the entries
are sorted as ``jax.tree.leaves`` flattens the reference's param tree
(dict keys sorted as strings, list entries in order: ``bot``, ``tables``,
``top``; ``t0, t1, t10, t11, ...``), which is the order ``global_norm``
adds the leaves' squares in.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.train.optimizer import Optimizer, Tree, apply_updates

LossFn = Callable[[nn.Module, dict], Tuple[torch.Tensor, dict]]  # (model, batch) -> (loss, metrics)


def reference_key(name: str) -> tuple:
    """The reference's tree path of the port's parameter ``name``:
    ``bot.layers.0.weight`` -> ("bot", "layers", 0, "w"); a layer's
    ``bias`` -> "b" (a norm's ``bias`` keeps its name)."""
    parts: list[Any] = [int(p) if p.isdigit() else p for p in name.split(".")]
    if parts[-1] == "weight":
        parts[-1] = "w"
    elif parts[-1] == "bias" and len(parts) > 1 and isinstance(parts[-2], int):
        parts[-1] = "b"
    return tuple(parts)


def _as_reference(name: str, t: torch.Tensor) -> torch.Tensor:
    return t.T if t.dim() == 2 and name.endswith("weight") else t


def reference_layout(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The trainable parameters of ``model`` as views in the reference's
    layout, in ``jax.tree.leaves`` order; writing into a view writes the
    parameter."""
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    return {k: _as_reference(k, p) for k, p in sorted(named, key=lambda kv: reference_key(kv[0]))}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the leaves' sums of squares (float32), added leaf after leaf
    in the reference's leaf order."""
    total = None
    for k in sorted(tree, key=reference_key):
        x = tree[k].float()
        s = (x * x).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float):
    """(tree * min(1, max_norm / max(norm, 1e-12)), norm); the division is a
    tensor division, as the reference's."""
    norm = global_norm(tree)
    scale = torch.clamp_max(torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-12), 1.0)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, norm


def make_train_step(loss_fn: LossFn, optimizer: Optimizer, *, grad_accum: int = 1,
                    clip_norm: float = 0.0):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics):
    the model's parameters and the state are updated in place.

    With grad_accum > 1 the batch's leading axis is split into
    ``grad_accum`` microbatches run one after another; their gradients are
    summed in float32 from zeros and divided by ``grad_accum``, and so are
    the metrics. Metrics are detached 0-d tensors (``grad_norm`` added
    when ``clip_norm`` > 0).
    """

    def grads_of(model, batch):
        params = reference_layout(model)
        named = dict(model.named_parameters())
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, [named[k] for k in params])
        return ({k: v.detach() for k, v in metrics.items()},
                {k: _as_reference(k, g) for k, g in zip(params, grads)})

    def step(model, opt_state, batch):
        params = reference_layout(model)
        if grad_accum > 1:
            size = next(iter(batch.values())).shape[0] // grad_accum
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for k, p in params.items()}
            msum = None
            for i in range(grad_accum):
                mb = {k: x[i * size : (i + 1) * size] for k, x in batch.items()}
                metrics, g = grads_of(model, mb)
                acc = {k: a + g[k].float() for k, a in acc.items()}
                if msum is None:
                    msum = {k: torch.zeros_like(m, dtype=torch.float32) for k, m in metrics.items()}
                msum = {k: a + metrics[k].float() for k, a in msum.items()}
            n = torch.tensor(float(grad_accum), device=next(iter(acc.values())).device)
            grads = {k: a / n for k, a in acc.items()}
            metrics = {k: m / n for k, m in msum.items()}
        else:
            metrics, grads = grads_of(model, batch)
        if clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        return model, opt_state, metrics

    return step
