"""The sample probe shared by start-point seeding and the Eq.-1 estimator
(port of ``repro.core.estimator.sample_satisfied_mask``)."""
from __future__ import annotations

import torch

from repro_torch.core.types import SatisfiedFn


def sample_satisfied_mask(
    satisfied: SatisfiedFn, sample_ids: torch.Tensor, batch: int
) -> torch.Tensor:
    """(B, S) constraint verdicts over the pre-drawn build sample."""
    return satisfied(sample_ids[None, :].expand(batch, -1))
