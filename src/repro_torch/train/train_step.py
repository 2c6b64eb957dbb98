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

Over a mesh a cell may hold some leaves as their blocks
(``distributed.layout.Resident``: the recsys tables, every leaf of the
LM, MACE's parameters). ``param_leaves`` presents such a leaf as one
``Blocks`` in the reference's layout (a stacked list's leaf as its (L,
...) blocks); its gradient and optimizer state are ``Blocks`` of that
leaf's layout and of the state's own specs (``init_state``), each part
updated on its device by the optimizer (``train/optimizer.py`` says how
Adafactor reduces across blocks). A block held on several devices gets
the sum of its replicas' gradients on each, added in part order (the
reference's all-reduce of a replicated block's gradient); where the reads
reported the rows they touched (a table's), only those rows are added,
which leaves the same bits as the sum of every row, since an untouched
row is +0.0 in every replica. ``reference_layout`` presents a resident
leaf whole (``Blocks.whole``), a copy.
"""
from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.layout import BlockLayout, Blocks, Resident, stacked_layout
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


@functools.lru_cache(maxsize=None)
def _transposed(layout: BlockLayout) -> BlockLayout:
    """``layout`` with its last two dimensions swapped."""
    shape, spec = layout.shape, tuple(layout.spec)
    return BlockLayout.of(shape[:-2] + (shape[-1], shape[-2]), spec[:-2] + (spec[-1], spec[-2]),
                          layout.mesh)


def _blocks_as_reference(name: str, b: Blocks, stacked: bool = False) -> Blocks:
    """A resident leaf's ``Blocks`` (the port's layout) in the reference's
    layout: a 2-D ``weight``'s parts transposed, and its layout."""
    if not (len(b.shape) == 2 + stacked and name.endswith("weight")):
        return b
    return Blocks(_transposed(b.layout), [p.transpose(-1, -2) for p in b.parts])


@dataclass
class _Leaf:
    """One leaf of the optimizer's view: ``value`` (a view in the reference's
    layout, or a resident leaf's ``Blocks``), the parameters it holds in the
    order ``gradients`` reads them (a stacked resident leaf's part-major:
    part 0's layers, then part 1's), the layers stacked (0: none), and the
    ``Resident`` that may report touched rows."""

    value: Any
    names: list
    stacked: int = 0
    resident: Optional[Resident] = None


def _layout(model: nn.Module) -> Dict[str, _Leaf]:
    """name -> ``_Leaf``, in ``jax.tree.leaves`` order."""
    lists = {k + ".": m for k, m in model.named_modules() if isinstance(m, StackedLayers)}
    resident = {k + ".": m for k, m in model.named_modules() if isinstance(m, Resident)}
    out: Dict[str, _Leaf] = {}
    split: Dict[str, list] = {}  # a stacked resident leaf's names, a list a part
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        lst = next((pre for pre in lists if k.startswith(pre)), None)
        res = next((pre for pre in resident if k.startswith(pre)), None)
        if lst is None and res is None:
            out[k] = _Leaf(_as_reference(k, p), [k])
        elif lst is None:
            key = res[:-1]
            if key not in out:
                r = resident[res]
                out[key] = _Leaf(_blocks_as_reference(key, r.blocks()), [], 0, r)
            out[key].names.append(k)
        elif res is None:
            rest = k[len(lst):].partition(".")[2]
            key = lst + rest
            if key not in out:
                out[key] = _Leaf(_as_reference(key, lists[lst].stack(rest), True), [], 1)
            out[key].names.append(k)
        else:
            rest = res[len(lst):].partition(".")[2][:-1]  # the layer's path to it
            key = lst + rest
            layers = lists[lst]
            if key not in out:
                r = resident[res]
                n = len(r.parts)
                parts = [layers.stack(f"{rest}.parts.{j}") for j in range(n)]
                value = Blocks(stacked_layout(r.layout, len(layers)), parts)
                out[key] = _Leaf(_blocks_as_reference(key, value, True), [], len(layers))
                split[key] = [[] for _ in range(n)]
            split[key][int(k.rpartition(".")[2])].append(k)
    for key, per_part in split.items():
        out[key].names = [n for names in per_part for n in names]
    return dict(sorted(out.items(), key=lambda kv: reference_key(kv[0])))


def param_leaves(model: nn.Module) -> Dict[str, Any]:
    """The trainable parameters of ``model`` as the step updates them: views
    in the reference's layout, in ``jax.tree.leaves`` order (writing into a
    view writes the parameters), a resident leaf as its ``Blocks``."""
    return {k: leaf.value for k, leaf in _layout(model).items()}


def reference_layout(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The trainable parameters of ``model`` as views in the reference's
    layout, in ``jax.tree.leaves`` order, a stacked layer list's as one
    (L, ...) leaf; writing into a view writes the parameters. A resident
    leaf is presented whole (a copy gathered from its blocks)."""
    return {k: v.whole() if isinstance(v, Blocks) else v for k, v in param_leaves(model).items()}


def _sum_replicas(g: Blocks, rows: Optional[dict] = None) -> Blocks:
    """Each block's gradient summed over its replicas (the parts of one block
    on distinct devices) in part order, the sum on every replica. With
    ``rows`` ({part: rows its reads touched}) only the union of the
    replicas' rows is added, written into each replica's gradient."""
    parts = list(g.parts)
    for group in g.layout.replicas():
        if len(group) < 2:
            continue
        dev = parts[group[0]].device
        if rows is None:
            total = sum_in_order([parts[i] for i in group], dev)
            for i in group:  # a copy each (a move to an equal device would not copy)
                parts[i] = total if i == group[0] else total.to(parts[i].device, copy=True)
            continue
        touched = [rows[i].to(dev) for i in group if i in rows]
        if not touched:
            continue
        idx = torch.unique(torch.cat(touched).long())
        total = sum_in_order([parts[i].index_select(0, idx.to(parts[i].device)) for i in group],
                             dev)
        for i in group:
            d = parts[i].device
            if not _writable(parts[i], parts[i].dtype):
                parts[i] = parts[i].clone()
            parts[i].index_copy_(0, idx.to(d), total.to(d))
    return Blocks(g.layout, parts)


def gradients(model: nn.Module, loss: torch.Tensor) -> Dict[str, Any]:
    """d loss / d each leaf of ``param_leaves(model)``, in that layout (a
    stacked list's layers' gradients stacked, each layer's freed once
    stacked; a resident leaf's as ``Blocks``, its replicas summed)."""
    layout = _layout(model)
    named = dict(model.named_parameters())
    flat = list(torch.autograd.grad(loss, [named[n] for leaf in layout.values()
                                           for n in leaf.names],
                                    allow_unused=True, materialize_grads=True))
    grads, i = {}, 0
    for k, leaf in layout.items():
        n = len(leaf.names)
        rows, flat[i : i + n] = flat[i : i + n], [None] * n
        i += n
        if isinstance(leaf.value, Blocks):
            if leaf.stacked:  # part-major: each part's layers stacked
                rows = [_stack(rows[j : j + leaf.stacked]) for j in range(0, n, leaf.stacked)]
            parts = [_as_reference(k, r, bool(leaf.stacked)) for r in rows]
            touched = leaf.resident.take_rows() if leaf.resident is not None else None
            grads[k] = _sum_replicas(Blocks(leaf.value.layout, parts), touched)
            continue
        g = _stack(rows) if leaf.stacked else rows[0]
        grads[k] = _as_reference(k, g, bool(leaf.stacked))
    return grads


def _stack(rows: list) -> torch.Tensor:
    return rows[0].unsqueeze(0) if len(rows) == 1 else torch.stack(rows)


def init_state(optimizer: Optimizer, model: nn.Module) -> dict:
    """``optimizer.init`` of ``param_leaves(model)``: a resident leaf's state
    as ``Blocks`` laid out by the optimizer's ``state_specs`` (zeros, each
    part beside the blocks it serves)."""
    leaves = param_leaves(model)
    plain = {k: v for k, v in leaves.items() if not isinstance(v, Blocks)}
    state = optimizer.init(plain) if plain else {}
    for k, b in leaves.items():
        if not isinstance(b, Blocks):
            continue
        meta = {k: torch.empty(b.shape, dtype=b.dtype, device="meta")}
        shapes = optimizer.init(meta)
        specs = optimizer.state_specs({k: b.layout.spec}, meta)
        for name, sub in shapes.items():
            if isinstance(sub, dict):
                state.setdefault(name, {})[k] = Blocks.zeros(sub[k].shape, specs[name][k],
                                                             b.layout.mesh, sub[k].dtype)
            elif name not in state:
                state[name] = torch.zeros_like(sub, device=b.device)
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
    where the reference's layout puts it (the tables' blocks, the LM's
    heads, columns, experts and vocabulary blocks, the graph's shards) and
    combines the shares in shard order,
    and autograd carries each share's gradient back onto the resident
    parts it read and through the moves onto the whole parameters, as
    GSPMD's reductions carry the reference's.

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
        # updates are elementwise or per leaf (a resident leaf's parts each on
        # its device), and each call counts the step from the same state.
        new_state = opt_state
        for k in list(grads):
            updates, new_state = optimizer.update({k: grads.pop(k)}, opt_state, {k: params[k]})
            apply_updates({k: params[k]}, updates)
        return model, new_state, metrics

    return step
