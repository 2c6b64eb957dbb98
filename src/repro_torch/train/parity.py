"""One train cell on two devices from the same start: two steps from the
same weights, optimizer state and batch on each, and the readings and
limits that hold one device to the other (``chip_smoke.py`` phases 10-11
and ``tests/test_torch_cuda_train_lm_gnn.py`` hold the card to the CPU).

- Metrics: each metric of both steps within ``LOSS_RTOL`` relative. The
  second step's loss is taken at the parameters the first step wrote, so
  it sees a wrong update. The control: the relative change of the loss
  that one whole update makes on the reference device, which the limit
  must stay below.
- Parameters after the first step: the first update of AdamW and
  Adafactor is about -lr g / |g| an element, so an element whose gradient
  is at rounding level may move the other way on one device; every element
  within 2 lr + 1e-6. An element is far when it differs by more than
  1e-3 lr + 1e-6, and at most ``LEAF_FAR_SHARE`` of each leaf's elements
  may be far. The control: each leaf that the reference's update moves
  beyond that on half of its elements or more, with its update dropped
  (the leaf left as it started) or sign-flipped (2 start - card): the
  least far share among them must exceed the limit.
"""
from __future__ import annotations

import copy
import math

import torch

from repro_torch.train.train_step import reference_layout

# Each limit sits between the largest reading of sound runs and the least
# reading of its control on an H100 (PERF.md, "card == CPU").
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
LEAF_FAR_SHARE = {"float32": 1e-2, "bfloat16": 0.3}


def tree_to(tree, dev):
    """A copy of a nested dict of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True) if isinstance(tree, torch.Tensor) else tree


def _snapshot(model) -> dict:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in reference_layout(model).items()}


def step_readings(cell, dev, seed: int, lr: float) -> dict:
    """Two steps of ``cell`` (its ``make_inputs`` on the CPU, the
    reference, then a copy on ``dev``) -> {"rel": the largest relative metric difference,
    "update_rel": the loss's relative change over the reference's first
    update, "worst": the largest parameter difference, "leaf_far" and
    "leaf_far_name": the largest far share of a leaf and its leaf,
    "far", "elements", "control", "control_name", "controlled",
    "leaves"}."""
    ref = cell.make_inputs(seed, "cpu")
    model, state, batch = copy.deepcopy(ref[0]).to(dev), tree_to(ref[1], dev), tree_to(ref[2], dev)
    start = _snapshot(ref[0])
    ref_model, ref_state, want1 = cell.fn(*ref)
    model, state, got1 = cell.fn(model, state, batch)
    want_p, got_p = _snapshot(ref_model), _snapshot(model)
    _, _, want2 = cell.fn(ref_model, ref_state, ref[2])
    _, _, got2 = cell.fn(model, state, batch)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    out = dict(rel=0.0, worst=0.0, leaf_far=0.0, leaf_far_name=None, far=0, elements=0,
               control=math.inf, control_name=None, controlled=0, leaves=len(start),
               finite=all(math.isfinite(float(v)) for v in (*got1.values(), *got2.values())))
    for got, want in ((got1, want1), (got2, want2)):
        for k in want:
            d = abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
            out["rel"] = max(out["rel"], d)
    out["update_rel"] = abs(float(want2["loss"]) - float(want1["loss"])) / abs(float(want1["loss"]))
    tol = 1e-3 * lr + 1e-6
    for k, p0 in start.items():
        d = (got_p[k] - want_p[k]).abs()
        far = int((d > tol).sum())
        out["worst"] = max(out["worst"], float(d.max()))
        out["far"] += far
        out["elements"] += d.numel()
        if far / d.numel() >= out["leaf_far"]:
            out["leaf_far"], out["leaf_far_name"] = far / d.numel(), k
        dropped = (want_p[k] - p0).abs() > tol
        if float(dropped.float().mean()) < 0.5:
            continue
        flipped = (2 * p0 - got_p[k] - want_p[k]).abs() > tol
        share = min(float(dropped.float().mean()), float(flipped.float().mean()))
        out["controlled"] += 1
        if share < out["control"]:
            out["control"], out["control_name"] = share, k
    return out


def failures(r: dict, lr: float, dtype: str) -> list:
    """What of ``step_readings``' ``r`` breaks the limits for ``dtype``
    ("float32" or "bfloat16"), the limit against its control included."""
    rtol, share = LOSS_RTOL[dtype], LEAF_FAR_SHARE[dtype]
    out = []
    if not r["finite"]:
        out.append("a metric is not finite")
    if not r["rel"] <= rtol < r["update_rel"]:
        out.append(f"metrics differ by {r['rel']:.3e} relative, the limit {rtol} and one "
                   f"update's change {r['update_rel']:.3e}")
    if not r["worst"] <= 2 * lr + 1e-6:
        out.append(f"a parameter differs by {r['worst']:.3e} (> 2 lr + 1e-6)")
    if not r["leaf_far"] <= share < r["control"]:
        out.append(f"{r['leaf_far_name']}: {r['leaf_far']:.3e} of its elements far, the limit "
                   f"{share} and the control {r['control']:.3e} ({r['control_name']})")
    return out
