"""Query-constraint representations (port of ``repro.core.constraints``).

Three families, each lowered to a ``SatisfiedFn: (B, M) ids -> (B, M) bool``
closed over the corpus attribute tensors:

  * ``LabelSetConstraint``: per-query allowed-label bitmask words.
  * ``RangeConstraint``: per-query [lo, hi] window over one attribute column.
  * a UDF: any vectorised torch callable ``udf(labels (n,), attrs (n, a))
    -> (n,) bool`` over corpus attributes. It is called on flattened
    candidate rows, so it must work elementwise along the first axis; it
    takes the place of the reference's ``jax.vmap``-ed scalar predicate.

Label and tombstone words hold the reference's uint32 bits as int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.bits import WORD_BITS, bit_of, n_words, to_i32
from repro_torch.core.types import Corpus, SatisfiedFn

Udf = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class LabelSetConstraint:
    """Per-query allowed-label set as a bitmask: (B, ceil(L/32)) int32."""

    words: torch.Tensor

    @property
    def batch(self) -> int:
        return self.words.shape[0]


@dataclass(frozen=True)
class RangeConstraint:
    """Per-query numeric window over attribute column ``col``."""

    lo: torch.Tensor  # (B,)
    hi: torch.Tensor  # (B,)
    col: int = 0


def label_set_from_lists(
    allowed: Sequence[Sequence[int]], n_labels: int, device="cuda"
) -> LabelSetConstraint:
    """Host-side builder from explicit label lists."""
    out = np.zeros((len(allowed), n_words(n_labels)), dtype=np.uint32)
    for i, labels in enumerate(allowed):
        for lab in labels:
            out[i, lab // WORD_BITS] |= np.uint32(1) << np.uint32(lab % WORD_BITS)
    return LabelSetConstraint(words=torch.from_numpy(out.view(np.int32)).to(device))


def _words_from_labels(picked: torch.Tensor, n_labels: int) -> torch.Tensor:
    """(B, P) distinct labels per row -> (B, Lw) int32 words (add == or)."""
    picked = picked.to(torch.int64)
    words = torch.zeros((picked.shape[0], n_words(n_labels)), dtype=torch.int64,
                        device=picked.device)
    words.scatter_add_(1, picked >> 5, torch.ones_like(picked) << (picked & 31))
    return to_i32(words)


def equal_constraint(query_labels: torch.Tensor, n_labels: int) -> LabelSetConstraint:
    """Paper §3 'equal': results must share the query's label."""
    return LabelSetConstraint(words=_words_from_labels(query_labels[:, None], n_labels))


def unequal_pct_constraint(
    generator: torch.Generator, query_labels: torch.Tensor, n_labels: int, pct: float
) -> LabelSetConstraint:
    """Paper §3 'unequal-X%': allow a random X% of labels, all != query label.

    ``pct`` in (0, 100]; at least one label is allowed. Draws from
    ``generator``, which must live on the labels' device.
    """
    b = query_labels.shape[0]
    n_allowed = max(1, int(round(n_labels * pct / 100.0)))
    scores = torch.rand((b, n_labels), generator=generator, device=query_labels.device)
    scores[torch.arange(b, device=scores.device), query_labels.long()] = float("inf")
    picked = torch.sort(scores, dim=-1, stable=True).indices[:, :n_allowed]
    return LabelSetConstraint(words=_words_from_labels(picked, n_labels))


def label_satisfied_fn(constraint: LabelSetConstraint, corpus: Corpus) -> SatisfiedFn:
    labels = corpus.labels

    def satisfied(ids):
        lab = labels[ids.clamp_min(0).long()].long()
        word = constraint.words.gather(1, lab >> 5)
        return bit_of(word, lab) & (ids >= 0)

    return satisfied


def range_satisfied_fn(constraint: RangeConstraint, corpus: Corpus) -> SatisfiedFn:
    if corpus.attrs is None:
        raise ValueError("corpus has no numeric attributes")
    column = corpus.attrs[:, constraint.col]

    def satisfied(ids):
        val = column[ids.clamp_min(0).long()]
        ok = (val >= constraint.lo[:, None]) & (val <= constraint.hi[:, None])
        return ok & (ids >= 0)

    return satisfied


def _udf_attrs(corpus: Corpus) -> torch.Tensor:
    if corpus.attrs is not None:
        return corpus.attrs
    return torch.zeros((corpus.n, 0), dtype=torch.float32, device=corpus.vectors.device)


def udf_satisfied_fn(udf: Udf, corpus: Corpus) -> SatisfiedFn:
    """A vectorised predicate ``udf(labels (N,), attrs (N, a)) -> (N,) bool``
    evaluated on the candidates' label and attribute rows."""
    labels = corpus.labels
    attrs = _udf_attrs(corpus)

    def satisfied(ids):
        flat = ids.clamp_min(0).long().reshape(-1)
        ok = udf(labels[flat], attrs[flat]).reshape(ids.shape).bool()
        return ok & (ids >= 0)

    return satisfied


@dataclass(frozen=True)
class ConstraintTables:
    """Raw table views of a constraint for the fused kernel.

    family "label": meta is the (n,) int32 label column, cons the (B, Lw)
        int32 allowed-label words;
    family "range": meta is the (n,) float32 attribute column, cons the
        (B, 2) float32 [lo, hi] bounds;
    family "udf": meta is the (n,) int32 precompiled verdict column (the
        UDF evaluated over every vertex: UDFs are query-independent), cons a
        (1, 1) dummy.
    tomb: the corpus-wide (ceil(n/32),) int32 tombstone bitmap, or None.
    """

    meta: torch.Tensor
    cons: torch.Tensor
    family: str = "label"
    tomb: Optional[torch.Tensor] = None


def udf_predicate_table(udf: Udf, corpus: Corpus) -> torch.Tensor:
    """Precompile a UDF into its (n,) int32 verdict column (O(n) once)."""
    return udf(corpus.labels, _udf_attrs(corpus)).to(torch.int32)


def constraint_tables(constraint, corpus: Corpus, include_udf: bool = False):
    """Raw views for the fused kernel; None for UDFs unless ``include_udf``
    (the verdict column costs an O(n) sweep)."""
    if isinstance(constraint, LabelSetConstraint):
        return ConstraintTables(meta=corpus.labels, cons=constraint.words, family="label",
                                tomb=corpus.tombstones)
    if isinstance(constraint, RangeConstraint):
        if corpus.attrs is None:
            raise ValueError("corpus has no numeric attributes")
        return ConstraintTables(
            meta=corpus.attrs[:, constraint.col].float().contiguous(),
            cons=torch.stack([constraint.lo.float(), constraint.hi.float()], -1),
            family="range",
            tomb=corpus.tombstones,
        )
    if callable(constraint) and include_udf:
        return ConstraintTables(
            meta=udf_predicate_table(constraint, corpus),
            cons=torch.zeros((1, 1), dtype=torch.int32, device=corpus.labels.device),
            family="udf",
            tomb=corpus.tombstones,
        )
    return None


def tombstone_test(tomb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(W,) x (B, M) ids -> (B, M) bool: is each id tombstoned?
    Padding ids (< 0) report as tombstoned."""
    safe = ids.clamp_min(0).long()
    return torch.where(ids >= 0, bit_of(tomb[safe >> 5], safe), True)


def make_satisfied_fn(constraint, corpus: Corpus) -> SatisfiedFn:
    if isinstance(constraint, LabelSetConstraint):
        base = label_satisfied_fn(constraint, corpus)
    elif isinstance(constraint, RangeConstraint):
        base = range_satisfied_fn(constraint, corpus)
    elif callable(constraint):
        base = udf_satisfied_fn(constraint, corpus)
    else:
        raise TypeError(f"unsupported constraint: {type(constraint)}")
    if corpus.tombstones is None:
        return base
    # A tombstoned slot fails every family: it stays traversable (frontier
    # pushes key on freshness) but never enters a result list.
    tomb = corpus.tombstones

    def satisfied(ids):
        return base(ids) & ~tombstone_test(tomb, ids)

    return satisfied


def selectivity(constraint, corpus: Corpus, chunk: int = 1 << 16) -> torch.Tensor:
    """(B,) fraction of the corpus satisfying each query's constraint: the
    chunked scan of ``core/estimator.py`` (imported here lazily, since the
    estimator imports this module)."""
    from repro_torch.core.estimator import scan_selectivity

    return scan_selectivity(constraint, corpus, chunk=chunk)
