"""One train cell on two devices, or two runs of a step, from the same
start: two steps from the same weights, optimizer state and batch on
each, and the readings and limits that hold one to the other
(``chip_smoke.py`` phases 10-12 and ``tests/test_torch_cuda_train_lm_gnn.py``
hold the card to the CPU, phase 12 a mesh's step to the one-device step,
``tests/test_torch_train_mesh*.py`` the port's mesh steps to the
reference's; ``readings`` takes the two runs' snapshots).

- The card's steps run under PyTorch's deterministic algorithms
  (``deterministic``): the card's segment sums (``index_add_``) otherwise
  add in no fixed order, and a bf16 cell's total energy (smoke-mace's
  ogb_products) then lands one ulp from the CPU's in some runs, which
  moves its energy term by 1e-2 of itself (``tools/mace_bf16_flips.py``).
- Metrics: each metric of both steps within ``LOSS_RTOL`` relative, or
  within a tenth of the control where that is tighter (``metric_limit``).
  The second step's loss is taken at the parameters the first step
  wrote, so it sees a wrong update. The control: the relative change of
  the loss that one whole update makes on the reference run, which the
  limit must stay below.
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

import contextlib
import copy
import math
import os

import torch

from repro_torch.train.train_step import reference_layout

# Each limit sits between the largest reading of sound runs and the least
# reading of its control on an H100 (PERF.md, "card == CPU").
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
LEAF_FAR_SHARE = {"float32": 1e-2, "bfloat16": 0.3}


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block (``warn_only``: an op
    without a deterministic version warns), then the setting as it was.
    cuBLAS's fixed workspace is requested where the process has not named
    one (``:4096:8``, an H100's default size)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def tree_to(tree, dev):
    """A copy of a nested dict of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True) if isinstance(tree, torch.Tensor) else tree


def snapshot(model) -> dict:
    """Every leaf of ``reference_layout(model)`` as a float32 CPU copy."""
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in reference_layout(model).items()}


def step_readings(cell, dev, seed: int, lr: float) -> dict:
    """Two steps of ``cell`` (its ``make_inputs`` on the CPU, the
    reference, then a copy on ``dev``) -> ``readings``."""
    ref = cell.make_inputs(seed, "cpu")
    model, state, batch = copy.deepcopy(ref[0]).to(dev), tree_to(ref[1], dev), tree_to(ref[2], dev)
    start = snapshot(ref[0])
    ref_model, ref_state, want1 = cell.fn(*ref)
    with deterministic():
        model, state, got1 = cell.fn(model, state, batch)
    want_p, got_p = snapshot(ref_model), snapshot(model)
    _, _, want2 = cell.fn(ref_model, ref_state, ref[2])
    with deterministic():
        _, _, got2 = cell.fn(model, state, batch)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return readings(start, want_p, got_p, (want1, want2), (got1, got2), lr)


def readings(start: dict, want_p: dict, got_p: dict, want_ms, got_ms, lr: float) -> dict:
    """The readings of two runs of two steps each from the same ``start``
    (float32 CPU snapshots by leaf): ``want_p`` / ``got_p`` the leaves after
    the first step of the reference run and of the run under test,
    ``want_ms`` / ``got_ms`` the metrics of both steps of each -> {"rel":
    the largest relative metric difference, "update_rel": the loss's
    relative change over the reference's first update, "worst": the
    largest parameter difference, "leaf_far" and "leaf_far_name": the
    largest far share of a leaf and its leaf, "far", "elements",
    "control", "control_name", "controlled", "leaves", "finite"}."""
    (want1, want2), (got1, got2) = want_ms, got_ms
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


def metric_limit(r: dict, dtype: str) -> float:
    """``LOSS_RTOL[dtype]``, or a tenth of the reference's first update's
    change of the loss where that is smaller: a cell whose loss one update
    barely moves (dlrm-mlperf at B 65,536: 1.1e-5 relative) is held that
    much tighter, so its limit stays below its control."""
    return min(LOSS_RTOL[dtype], r["update_rel"] / 10)


def failures(r: dict, lr: float, dtype: str) -> list:
    """What of ``step_readings``' ``r`` breaks the limits for ``dtype``
    ("float32" or "bfloat16"), the limit against its control included."""
    share = LEAF_FAR_SHARE[dtype]
    rtol = metric_limit(r, dtype)
    out = []
    if not r["finite"]:
        out.append("a metric is not finite")
    if not r["rel"] <= rtol < r["update_rel"]:
        out.append(f"metrics differ by {r['rel']:.3e} relative, the limit {rtol:.3e} and one "
                   f"update's change {r['update_rel']:.3e}")
    if not r["worst"] <= 2 * lr + 1e-6:
        out.append(f"a parameter differs by {r['worst']:.3e} (> 2 lr + 1e-6)")
    if not r["leaf_far"] <= share < r["control"]:
        out.append(f"{r['leaf_far_name']}: {r['leaf_far']:.3e} of its elements far, the limit "
                   f"{share} and the control {r['control']:.3e} ({r['control_name']})")
    return out
