"""Frontier-selection policies (port of ``repro.core.engine.policy``).

A policy maps the two frontier heads and the pop counters to a (B,) bool
``sel_sat``: True pops the satisfied frontier, False the other one.

  * ``vanilla`` / ``start``: one frontier (``oth``), constant False.
  * ``alter``: Alg. 3, hold the satisfied pop share at ``alter_ratio``.
  * ``prefer``: §2.5, ``alter`` plus an override whenever the best
    satisfied candidate already beats the best unsatisfied one.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core import queue as q

FrontierPolicy = Callable[..., torch.Tensor]


def single_queue_policy(sat, oth, cnt_sat, cnt_total, ratio):
    """vanilla / start: one frontier, always pop ``oth``."""
    return torch.zeros((oth.batch,), dtype=torch.bool, device=oth.dists.device)


def ratio_policy(sat, oth, cnt_sat, cnt_total, ratio):
    """Alg. 3 alternation: hold the satisfied pop share at ``ratio``."""
    sat_ne = q.queue_nonempty(sat)
    oth_ne = q.queue_nonempty(oth)
    rule = cnt_sat.float() <= ratio * cnt_total.float()
    return torch.where(~oth_ne, True, torch.where(~sat_ne, False, rule))


def prefer_policy(sat, oth, cnt_sat, cnt_total, ratio):
    """§2.5 biased selection: ratio rule + best-satisfied-head override."""
    sel = ratio_policy(sat, oth, cnt_sat, cnt_total, ratio)
    head_sat_d, _ = q.queue_head(sat)
    head_oth_d, _ = q.queue_head(oth)
    return sel | (q.queue_nonempty(sat) & (head_sat_d <= head_oth_d))


POLICIES: Dict[str, FrontierPolicy] = {
    "vanilla": single_queue_policy,
    "start": single_queue_policy,
    "alter": ratio_policy,
    "prefer": prefer_policy,
}


def get_policy(mode: str) -> FrontierPolicy:
    return POLICIES[mode]


def is_two_queue(mode: str) -> bool:
    """Modes that keep a separate satisfied frontier."""
    return mode in ("alter", "prefer")
