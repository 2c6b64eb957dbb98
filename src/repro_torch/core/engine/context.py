"""TraversalContext: everything a traversal scores and filters with,
resolved once per search (port of ``repro.core.engine.context``).

Distance backends:

  * ``ExactBackend``: gathered corpus rows + ``batched_rowwise_sqdist``.
  * ``L2KernelBackend``: the ``gather_distance`` kernel over the same rows
    (``SearchParams.use_kernel``).

Both expose ``distances(queries, ids)``, ``sample_distances(queries,
sample_ids)`` (the pairwise matmul expansion over the shared build sample)
and ``fused_expand(queries, ids, visited, tables)`` (the one-pass kernel).
The PQ backend is not ported yet. The reference's kernel tuning-table
lookup is dropped: the CUDA kernels take no block-shape parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch.common.distances import batched_rowwise_sqdist, squared_l2
from repro_torch.core.constraints import (
    ConstraintTables,
    constraint_tables,
    make_satisfied_fn,
)
from repro_torch.core.types import Corpus, SatisfiedFn, SearchParams
from repro_torch.kernels.fused_expand import fused_expand
from repro_torch.kernels.gather_distance import gather_distance

# "auto" fuses only where the fused path has been measured to win. It
# returns the same results as the unfused path; flip this once a chip
# measurement shows the fused loop faster end to end on the card.
FUSE_AUTO_ON_CUDA = False


def resolve_auto_fuse(fusable: bool, device: torch.device) -> bool:
    """fuse_expand == "auto": unfused everywhere until measured otherwise,
    the semantics of the reference (which fuses "auto" only on a TPU
    behind its own validation flag)."""
    return fusable and device.type == "cuda" and FUSE_AUTO_ON_CUDA


@dataclass(frozen=True)
class _RowBackend:
    """Backends that score full (n, d) corpus rows."""

    vectors: torch.Tensor  # (n, d)

    @property
    def fusable(self) -> bool:
        return True

    @property
    def approximate(self) -> bool:
        return False

    def sample_distances(self, queries, sample_ids):
        # One gather of the shared sample + the pairwise matmul expansion.
        return squared_l2(queries, self.vectors[sample_ids.long()])

    def fused_expand(self, queries, ids, visited, tables: ConstraintTables):
        return fused_expand(queries, self.vectors, ids, visited, tables.meta, tables.cons,
                            tables.tomb, family=tables.family)


@dataclass(frozen=True)
class ExactBackend(_RowBackend):
    """Exact squared L2 over gathered corpus rows."""

    def distances(self, queries, ids):
        return batched_rowwise_sqdist(queries, self.vectors[ids.clamp_min(0).long()])


@dataclass(frozen=True)
class L2KernelBackend(_RowBackend):
    """The ``gather_distance`` kernel over the same rows."""

    def distances(self, queries, ids):
        return gather_distance(queries, self.vectors, ids.to(torch.int32).contiguous())


DistanceBackend = Union[ExactBackend, L2KernelBackend]


@dataclass(frozen=True)
class TraversalContext:
    """backend: the distance path; tables: the constraint's raw views for
    the fused kernel (None where unfusable); satisfied: the (B, M) ids ->
    bool closure, tombstones included; fuse: the resolved fuse decision."""

    backend: DistanceBackend
    tables: Optional[ConstraintTables]
    satisfied: SatisfiedFn
    fuse: bool = False


def build_context(corpus: Corpus, constraint, queries, params: SearchParams
                  ) -> TraversalContext:
    """Resolve (params, constraint, corpus) into one TraversalContext: the
    distance backend, the constraint closure and its raw table views (the
    UDF verdict column only where the fused path is reachable), and the
    fuse decision."""
    if params.approx == "pq":
        raise NotImplementedError("the PQ path is not ported yet")
    satisfied = make_satisfied_fn(constraint, corpus)
    tables = constraint_tables(constraint, corpus, include_udf=params.fuse_expand != "off")
    backend_cls = L2KernelBackend if params.use_kernel else ExactBackend
    backend = backend_cls(vectors=corpus.vectors)
    fusable = tables is not None and backend.fusable
    if params.fuse_expand == "on" and not fusable:
        raise ValueError("fuse_expand='on' requires constraint tables (got a non-constraint "
                         "object the kernels cannot evaluate)")
    fuse = params.fuse_expand == "on" or (
        params.fuse_expand == "auto" and resolve_auto_fuse(fusable, queries.device))
    return TraversalContext(backend=backend, tables=tables, satisfied=satisfied, fuse=fuse)
