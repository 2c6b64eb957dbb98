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

The reference stacks some layer lists on a leading axis (the LM's
``dense_layers`` and ``moe_layers``), and its optimizer sees each stacked
array as one leaf: Adafactor factors and clips it whole. A
``StackedLayers`` list holds each of its layers' parameters as row i of
one (L, ...) tensor; the layout then presents that tensor as one leaf, named ``<list>.<parameter>`` (``dense_layers.attn.wq.weight``), and
the step stacks the layers' gradients to match.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.models.common.modules import StackedLayers
from repro_torch.train.optimizer import Optimizer, Tree, _writable, apply_updates

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


def _as_reference(name: str, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    return t.transpose(-1, -2) if t.dim() == 2 + stacked and name.endswith("weight") else t


def _layout(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, list, bool]]:
    """name -> (view in the reference's layout, the names of the parameters
    it holds, stacked or not), in ``jax.tree.leaves`` order."""
    lists = {k + ".": m for k, m in model.named_modules() if isinstance(m, StackedLayers)}
    out: Dict[str, Tuple[torch.Tensor, list, bool]] = {}
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        prefix = next((pre for pre in lists if k.startswith(pre)), None)
        if prefix is None:
            out[k] = (_as_reference(k, p), [k], False)
            continue
        rest = k[len(prefix):].partition(".")[2]
        key = prefix + rest
        if key not in out:
            out[key] = (_as_reference(key, lists[prefix].stack(rest), True), [], True)
        out[key][1].append(k)
    return dict(sorted(out.items(), key=lambda kv: reference_key(kv[0])))


def reference_layout(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The trainable parameters of ``model`` as views in the reference's
    layout, in ``jax.tree.leaves`` order, a stacked layer list's as one
    (L, ...) leaf; writing into a view writes the parameters."""
    return {k: v for k, (v, _, _) in _layout(model).items()}


def gradients(model: nn.Module, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """d loss / d each leaf of ``reference_layout(model)``, in that layout
    (a stacked list's layers' gradients stacked; each layer's freed once
    stacked)."""
    layout = _layout(model)
    named = dict(model.named_parameters())
    flat = list(torch.autograd.grad(loss, [named[n] for _, ns, _ in layout.values() for n in ns]))
    grads, i = {}, 0
    for k, (_, names, stacked) in layout.items():
        rows, flat[i : i + len(names)] = flat[i : i + len(names)], [None] * len(names)
        i += len(names)
        g = (rows[0].unsqueeze(0) if len(rows) == 1 else torch.stack(rows)) if stacked else rows[0]
        grads[k] = _as_reference(k, g, stacked)
    return grads


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
    tensor division, as the reference's. The leaves are consumed: each one
    that can take it, and shares its buffer with no other leaf (autograd may
    hand two parameters one gradient tensor), is scaled in that buffer (the
    same products)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-12), 1.0)
    owners = Counter(x.untyped_storage().data_ptr() for x in tree.values())
    return {k: (x.mul_(scale.to(x.dtype))
                if _writable(x, x.dtype) and owners[x.untyped_storage().data_ptr()] == 1
                else x * scale.to(x.dtype)) for k, x in tree.items()}, norm


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
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch)
            grads = gradients(model, loss)
        return {k: v.detach() for k, v in metrics.items()}, grads

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
                for k, a in acc.items():
                    a.add_(g.pop(k).float())  # the same sums, in place
                if msum is None:
                    msum = {k: torch.zeros_like(m, dtype=torch.float32) for k, m in metrics.items()}
                msum = {k: a + metrics[k].float() for k, a in msum.items()}
            n = torch.tensor(float(grad_accum), device=next(iter(acc.values())).device)
            grads = {k: a.div_(n) for k, a in acc.items()}  # the same quotients, in place
            metrics = {k: m / n for k, m in msum.items()}
        else:
            metrics, grads = grads_of(model, batch)
        if clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        # Leaf by leaf, each gradient freed once applied: the optimizers'
        # updates are elementwise or per leaf, and each call counts the step
        # from the same state.
        new_state = opt_state
        for k in list(grads):
            updates, new_state = optimizer.update({k: grads.pop(k)}, opt_state, {k: params[k]})
            apply_updates({k: params[k]}, updates)
        return model, new_state, metrics

    return step
