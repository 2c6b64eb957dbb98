"""Selectivity estimation: every probe of "what fraction of the corpus
satisfies this constraint" (port of ``repro.core.estimator``).

  * ``scan_selectivity``: the exact chunked scan (``core.constraints.
    selectivity`` delegates here).
  * ``sample_satisfied_mask`` / ``sampled_selectivity``: the (B, S) verdict
    mask over the pre-drawn build sample, shared by start-point seeding and
    the Eq.-1 estimator (the mask) and the router's fallback (its mean).
  * ``SelectivityEstimator``: the router's front. It prefers the
    incremental label / range histograms the streaming layer maintains
    (``core/histogram.py``, O(1), no device work) and falls back to the
    sampled estimate where no histogram covers the constraint (a UDF).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import LabelSetConstraint, RangeConstraint, make_satisfied_fn
from repro_torch.core.types import Corpus, SatisfiedFn


def sample_satisfied_mask(
    satisfied: SatisfiedFn, sample_ids: torch.Tensor, batch: int
) -> torch.Tensor:
    """(B, S) constraint verdicts over the pre-drawn build sample."""
    return satisfied(sample_ids[None, :].expand(batch, -1))


def sampled_selectivity(
    satisfied: SatisfiedFn, sample_ids: torch.Tensor, batch: int
) -> torch.Tensor:
    """(B,) satisfied fraction of the build sample: an unbiased O(S)
    estimate (the sample is drawn uniformly at build time)."""
    return sample_satisfied_mask(satisfied, sample_ids, batch).float().mean(-1)


def _batch_of(constraint) -> int:
    if isinstance(constraint, LabelSetConstraint):
        return constraint.batch
    if isinstance(constraint, RangeConstraint):
        return constraint.lo.shape[0]
    return 1


def scan_selectivity(constraint, corpus: Corpus, chunk: int = 1 << 16) -> torch.Tensor:
    """(B,) EXACT fraction of the corpus satisfying each query's constraint.

    A linear scan in ``chunk``-wide windows: the working set stays at
    B * chunk verdicts (a one-shot (B, n) mask is ~1 GB at B = 256,
    n = 1M) while the counts accumulate in (B,) int32. Ids past the corpus
    in the last window report unsatisfied.
    """
    fn = make_satisfied_fn(constraint, corpus)
    n = corpus.n
    b = _batch_of(constraint)
    dev = corpus.vectors.device
    chunk = min(chunk, n)
    total = torch.zeros((b,), dtype=torch.int32, device=dev)
    offsets = torch.arange(chunk, dtype=torch.int32, device=dev)
    for start in range(0, n, chunk):
        ids = start + offsets
        ids = torch.where(ids < n, ids, -1)
        total += fn(ids[None, :].expand(b, chunk)).sum(-1, dtype=torch.int32)
    return total.float() / n


class SelectivityEstimator:
    """Host-side estimator front for the strategy router.

    ``histograms`` (``AttributeHistograms``) covers the label and range
    families in O(words) per estimate with no device work; ``corpus`` +
    ``sample_ids`` arm the sampled fallback for constraints no histogram
    covers (UDFs). Either side may be None; ``estimate`` reports the source
    it used.
    """

    def __init__(self, histograms=None, corpus: Optional[Corpus] = None,
                 sample_ids: Optional[torch.Tensor] = None):
        self.histograms = histograms
        self.corpus = corpus
        self.sample_ids = sample_ids

    def estimate_operand(self, family: str, operand) -> Tuple[Optional[float], str]:
        """(estimate, source) for one request's host-side operand: family
        "label" takes the (Lw,) uint32 bitmask row, "range" (lo, hi, col).
        (None, "none") where no histogram covers the family."""
        if self.histograms is not None:
            est = self.histograms.estimate(family, operand)
            if est is not None:
                return float(est), "histogram"
        return None, "none"

    def estimate_constraint(self, constraint, corpus: Optional[Corpus] = None
                            ) -> Tuple[np.ndarray, str]:
        """((B,) estimates, source) for a full constraint object: the
        histogram row by row on the host where it covers the family, else
        the sampled satisfied fraction over the build sample."""
        if self.histograms is not None:
            if isinstance(constraint, LabelSetConstraint):
                words = constraint.words.cpu().numpy().view(np.uint32)
                out = np.asarray([self.histograms.estimate("label", w) for w in words],
                                 np.float32)
                return out, "histogram"
            if isinstance(constraint, RangeConstraint):
                lo = constraint.lo.cpu().numpy()
                hi = constraint.hi.cpu().numpy()
                col = int(constraint.col)
                out = np.asarray(
                    [self.histograms.estimate("range", (lo[i], hi[i], col))
                     for i in range(lo.shape[0])],
                    np.float32,
                )
                return out, "histogram"
        corpus = corpus if corpus is not None else self.corpus
        if corpus is None or self.sample_ids is None:
            raise ValueError(
                "no histogram covers this constraint and no (corpus, sample_ids) were "
                "provided for the sampled fallback"
            )
        satisfied = make_satisfied_fn(constraint, corpus)
        est = sampled_selectivity(satisfied, self.sample_ids, _batch_of(constraint))
        return est.cpu().numpy(), "sampled"
