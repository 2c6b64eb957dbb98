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

Over a mesh the recsys tables are resident as their blocks
(``models.recsys.models.ResidentTable``). ``param_leaves`` presents such a
table as one leaf, its ``Blocks``; its gradient and moments are
``Blocks`` of the same layout, each part updated on its device (a block
held on several devices gets the sum of their gradients on each, in part
order: the reference's all-reduce of a replicated block's gradient), so
only an elementwise optimizer (AdamW) may update one. ``reference_layout``
presents it whole (``Blocks.whole``), a copy.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.distributed.layout import Blocks
from repro_torch.distributed.meshinfo import sum_in_order
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


def _resident_modules(model: nn.Module) -> dict:
    from repro_torch.models.recsys.models import ResidentTable

    return {k + ".": m for k, m in model.named_modules() if isinstance(m, ResidentTable)}


def _layout(model: nn.Module) -> Dict[str, Tuple[Any, list, bool]]:
    """name -> (view in the reference's layout, or a resident table's
    ``Blocks``; the names of the parameters it holds; stacked or not), in
    ``jax.tree.leaves`` order."""
    lists = {k + ".": m for k, m in model.named_modules() if isinstance(m, StackedLayers)}
    resident = _resident_modules(model)
    out: Dict[str, Tuple[Any, list, bool]] = {}
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        table = next((pre for pre in resident if k.startswith(pre)), None)
        if table is not None:
            key = table[:-1]
            if key not in out:
                out[key] = (resident[table].blocks(), [], False)
            out[key][1].append(k)
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


def param_leaves(model: nn.Module) -> Dict[str, Any]:
    """The trainable parameters of ``model`` as the step updates them: views
    in the reference's layout, in ``jax.tree.leaves`` order (writing into a
    view writes the parameters), a resident table as its ``Blocks``."""
    return {k: v for k, (v, _, _) in _layout(model).items()}


def reference_layout(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The trainable parameters of ``model`` as views in the reference's
    layout, in ``jax.tree.leaves`` order, a stacked layer list's as one
    (L, ...) leaf; writing into a view writes the parameters. A resident
    table is presented whole (a copy gathered from its blocks)."""
    return {k: v.whole() if isinstance(v, Blocks) else v for k, v in param_leaves(model).items()}


def _sum_replicas(g: Blocks) -> Blocks:
    """Each block's gradient summed over its replicas (the parts of one block
    on distinct devices) in part order, the sum on every replica."""
    parts = list(g.parts)
    for group in g.layout.replicas():
        if len(group) > 1:
            total = sum_in_order([parts[i] for i in group], parts[group[0]].device)
            for i in group:
                parts[i] = total if i == group[0] else total.to(parts[i].device)
    return Blocks(g.layout, parts)


def gradients(model: nn.Module, loss: torch.Tensor) -> Dict[str, Any]:
    """d loss / d each leaf of ``param_leaves(model)``, in that layout (a
    stacked list's layers' gradients stacked, each layer's freed once
    stacked; a resident table's as ``Blocks``)."""
    layout = _layout(model)
    named = dict(model.named_parameters())
    flat = list(torch.autograd.grad(loss, [named[n] for _, ns, _ in layout.values() for n in ns],
                                    allow_unused=True, materialize_grads=True))
    grads, i = {}, 0
    for k, (leaf, names, stacked) in layout.items():
        rows, flat[i : i + len(names)] = flat[i : i + len(names)], [None] * len(names)
        i += len(names)
        if isinstance(leaf, Blocks):
            grads[k] = _sum_replicas(Blocks(leaf.layout, rows))
            continue
        g = (rows[0].unsqueeze(0) if len(rows) == 1 else torch.stack(rows)) if stacked else rows[0]
        grads[k] = _as_reference(k, g, stacked)
    return grads


def init_state(optimizer: Optimizer, model: nn.Module) -> dict:
    """``optimizer.init`` of ``param_leaves(model)``: a resident table's
    moments as ``Blocks`` of its layout, each part beside its block."""
    leaves = param_leaves(model)
    plain = {k: v for k, v in leaves.items() if not isinstance(v, Blocks)}
    state = optimizer.init(plain)
    for k, b in leaves.items():
        if not isinstance(b, Blocks):
            continue
        if not optimizer.elementwise:
            raise ValueError(f"{k} is resident as blocks: its optimizer must be elementwise")
        per = [optimizer.init({k: p}) for p in b.parts]
        for name, sub in per[0].items():
            if isinstance(sub, dict):
                state[name][k] = Blocks(b.layout, [s[name][k] for s in per])
    for name, sub in state.items():  # the leaves' order
        if isinstance(sub, dict):
            state[name] = {k: sub[k] for k in leaves if k in sub}
    return state


def _parts(x) -> list:
    """A leaf's tensors: a ``Blocks`` leaf's parts, or the tensor itself."""
    return x.parts if isinstance(x, Blocks) else [x]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the leaves' sums of squares (float32), added leaf after leaf
    in the reference's leaf order; a ``Blocks`` leaf adds each block's sum
    once, in part order."""
    total = None
    for k in sorted(tree, key=reference_key):
        leaf = tree[k]
        parts = ([leaf.parts[g[0]] for g in leaf.layout.replicas()] if isinstance(leaf, Blocks)
                 else [leaf])
        for x in parts:
            x = x.float()
            s = (x * x).sum()
            total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float):
    """(tree * min(1, max_norm / max(norm, 1e-12)), norm); the division is a
    tensor division, as the reference's. The leaves are consumed: each one
    that can take it, and shares its buffer with no other leaf (autograd may
    hand two parameters one gradient tensor), is scaled in that buffer (the
    same products)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-12), 1.0)
    flat = [x for v in tree.values() for x in _parts(v)]
    owners = Counter(x.untyped_storage().data_ptr() for x in flat)

    def scaled(x):
        s = scale.to(x.device, x.dtype)
        return (x.mul_(s) if _writable(x, x.dtype) and owners[x.untyped_storage().data_ptr()] == 1
                else x * s)

    return {k: x.map(scaled) if isinstance(x, Blocks) else scaled(x)
            for k, x in tree.items()}, norm


def _part_state(state: dict, k: str, i: int, dev: torch.device) -> dict:
    """The optimizer's state of part ``i`` of resident leaf ``k``, the step
    count on the part's device."""
    return {name: ({k: sub[k].parts[i]} if isinstance(sub, dict) else sub.to(dev))
            for name, sub in state.items()}


def make_train_step(loss_fn: LossFn, optimizer: Optimizer, *, grad_accum: int = 1,
                    clip_norm: float = 0.0):
    """Returns step(model, opt_state, batch, skip_nonfinite=False) -> (model,
    opt_state, metrics): the model's parameters and the state are updated
    in place. With ``skip_nonfinite`` (the training driver's NaN guard) the
    step reads the loss on the host once the gradients are taken and, where
    it is not finite, returns before the first write: parameters and state
    stay as they were, bit for bit (the reference drops its functional
    result instead). Without it the step never waits on the device.

    The step takes no mesh: over one, the loss runs each position's share
    where the reference's layout puts it (the tables' blocks, the
    experts, the graph's shards) and combines the shares in shard order,
    and autograd carries each share's gradient back through the moves onto
    the whole parameters, as GSPMD's reductions carry the reference's.

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

    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    def step(model, opt_state, batch, skip_nonfinite: bool = False):
        params = param_leaves(model)
        resident = [k for k, p in params.items() if isinstance(p, Blocks)]
        if resident and not optimizer.elementwise:
            raise ValueError(f"{resident[0]} is resident as blocks: its optimizer must be "
                             f"elementwise")
        if grad_accum > 1:
            size = next(iter(batch.values())).shape[0] // grad_accum
            acc = {k: p.map(zeros) if isinstance(p, Blocks) else zeros(p)
                   for k, p in params.items()}
            msum = None
            for i in range(grad_accum):
                mb = {k: x[i * size : (i + 1) * size] for k, x in batch.items()}
                metrics, g = grads_of(model, mb)
                for k, a in acc.items():
                    for ap, gp in zip(_parts(a), _parts(g.pop(k))):
                        ap.add_(gp.float())  # the same sums, in place
                if msum is None:
                    msum = {k: torch.zeros_like(m, dtype=torch.float32) for k, m in metrics.items()}
                msum = {k: a + metrics[k].float() for k, a in msum.items()}
            n = torch.tensor(float(grad_accum), device=next(iter(msum.values())).device)
            for a in acc.values():
                for ap in _parts(a):
                    ap.div_(n.to(ap.device))  # the same quotients, in place
            grads = acc
            metrics = {k: m / n for k, m in msum.items()}
        else:
            metrics, grads = grads_of(model, batch)
        if skip_nonfinite and not bool(torch.isfinite(metrics["loss"])):
            return model, opt_state, metrics  # the NaN guard: nothing written
        if clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        # Leaf by leaf, each gradient freed once applied: the optimizers'
        # updates are elementwise or per leaf, and each call counts the step
        # from the same state.
        new_state = opt_state
        for k in list(grads):
            g, p = grads.pop(k), params[k]
            if not isinstance(p, Blocks):
                updates, new_state = optimizer.update({k: g}, opt_state, {k: p})
                apply_updates({k: p}, updates)
                continue
            for i, (gp, pp) in enumerate(zip(g.parts, p.parts)):  # each block on its device
                updates, part = optimizer.update({k: gp}, _part_state(opt_state, k, i, pp.device),
                                                 {k: pp})
                apply_updates({k: pp}, updates)
            if new_state is opt_state:
                new_state = dict(opt_state, count=part["count"].to(opt_state["count"].device))
        return model, new_state, metrics

    return step
