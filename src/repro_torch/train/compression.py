"""Int8 gradient compression with error feedback, for slow (cross-pod)
gradient reductions (port of ``repro.train.compression``).

``quantize_int8`` quantizes each row (the last axis) to int8 with a
symmetric per-row scale; ``compressed_psum_mean`` adds each position's
error-feedback residual, quantizes and dequantizes, and takes the mean
over a mesh axis of the dequantized values, 4x fewer bytes than float32
on the wire. The residual (the part the int8 payload did not carry) is
returned to be added to the next step's gradient, which keeps SGD
unbiased in expectation (1-bit Adam / EF-SGD lineage).

On one controller a mesh axis is the list of its positions' tensors, in
shard order, each on its position's device: the reference's ``psum`` is
an in-order sum of the dequantized tensors on the first position's
device, divided by the number of positions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.distributed.meshinfo import sum_in_order


def quantize_int8(x: torch.Tensor):
    """Per-row symmetric int8 quantization: x (..., D) -> (q int8, scale
    (..., 1) float32), q = clip(round(x / scale), -127, 127) with scale =
    max(|x|_inf of the row, 1e-12) / 127; ``torch.round`` and ``jnp.round``
    both round half to even."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(xs: Sequence[torch.Tensor],
                         errs: Optional[Sequence[torch.Tensor]] = None):
    """The mean over one mesh axis of ``xs`` (one tensor a position, in shard
    order) in int8 -> (the mean on the first position's device, in x's
    dtype; each position's new error-feedback residual, on its device)."""
    deqs, new_errs = [], []
    for i, x in enumerate(xs):
        if errs is not None:
            x = x + errs[i].to(x.dtype)
        q, scale = quantize_int8(x)
        deq = dequantize_int8(q, scale)
        new_errs.append((x.float() - deq).to(x.dtype))
        deqs.append(deq)
    total = sum_in_order(deqs, xs[0].device)
    n = torch.tensor(float(len(xs)), dtype=torch.float32, device=total.device)
    return (total / n).to(xs[0].dtype), new_errs


def compressed_tree_psum_mean(trees: Sequence[Dict[str, torch.Tensor]],
                              err_trees: Optional[Sequence[Dict[str, torch.Tensor]]] = None):
    """``compressed_psum_mean`` leaf by leaf over name-to-tensor dicts, one a
    position -> (the dict of means, one residual dict a position). Without
    ``err_trees`` every residual starts at zero, as the reference's."""
    if err_trees is None:
        err_trees = [{k: torch.zeros_like(x) for k, x in t.items()} for t in trees]
    reduced: Dict[str, torch.Tensor] = {}
    new_errs: List[Dict[str, torch.Tensor]] = [dict() for _ in trees]
    for k in trees[0]:
        mean, errs = compressed_psum_mean([t[k] for t in trees], [e[k] for e in err_trees])
        reduced[k] = mean
        for i, e in enumerate(errs):
            new_errs[i][k] = e
    return reduced, new_errs
