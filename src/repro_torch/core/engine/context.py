"""TraversalContext: everything a traversal scores and filters with,
resolved once per search (port of ``repro.core.engine.context``).

Distance backends:

  * ``ExactBackend``: gathered corpus rows + ``batched_rowwise_sqdist``.
  * ``L2KernelBackend``: the ``gather_distance`` kernel over the same rows
    (``SearchParams.use_kernel``).
  * ``PQBackend``: ADC lookups of m_sub code words per candidate against a
    per-query LUT (``SearchParams.approx == "pq"``); the loop re-ranks its
    survivors exactly.

Each exposes ``distances(queries, ids)``, ``sample_distances(queries,
sample_ids)`` (the exact backends use the pairwise matmul expansion over
the shared build sample), ``fused_expand(queries, ids, visited, tables)``
(the one-pass kernel: ``fused_expand`` over exact rows,
``fused_expand_adc`` over code rows) and the ``fusable`` / ``approximate``
properties. The ``gather_distance`` backend carries that kernel's block
shape (``gd_config``), which ``build_context`` resolves from the committed
tuning table (``repro_torch.tune``); the fused kernels and the PQ scan
have one shape each.
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
from repro_torch.core.pq import adc_table
from repro_torch.core.types import Corpus, SatisfiedFn, SearchParams
from repro_torch.kernels.fused_expand import fused_expand, fused_expand_adc
from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.kernels.pq_adc import adc_lookup, pq_adc_plain
from repro_torch.tune.config import DEFAULT_CONFIGS, KernelConfig
from repro_torch.tune.table import lookup as tune_lookup

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

    gd_config: KernelConfig = DEFAULT_CONFIGS["gather_distance"]  # its block shape

    def distances(self, queries, ids):
        return gather_distance(queries, self.vectors, ids.to(torch.int32).contiguous(),
                               config=self.gd_config)


@dataclass(frozen=True)
class PQBackend:
    """PQ / ADC distances: per-candidate code rows + the per-query LUT.

    The walk ranks by these; the loop re-ranks the surviving result list
    exactly (``approximate``). ``distances`` does not mask padding ids (it
    scores row 0), as the reference's does; the fused kernel writes +inf.
    """

    codes: torch.Tensor  # (n, m_sub) int32
    lut: torch.Tensor  # (B, m_sub, n_cent) float32, per-query ADC table

    @property
    def fusable(self) -> bool:
        return True

    @property
    def approximate(self) -> bool:
        return True

    def distances(self, queries, ids):
        del queries  # the LUT already encodes the query side
        return adc_lookup(self.lut, self.codes[ids.clamp_min(0).long()])

    def sample_distances(self, queries, sample_ids):
        b = self.lut.shape[0]
        return self.distances(queries, sample_ids[None, :].expand(b, -1))

    def scan_all(self):
        """ADC distances to every corpus row, (B, n): the linear-scan
        baseline's hot loop (core/pq.py), in plain PyTorch."""
        return pq_adc_plain(self.lut, self.codes)

    def fused_expand(self, queries, ids, visited, tables: ConstraintTables):
        del queries
        return fused_expand_adc(self.lut, self.codes, ids, visited, tables.meta, tables.cons,
                                tables.tomb, family=tables.family)


DistanceBackend = Union[ExactBackend, L2KernelBackend, PQBackend]


@dataclass(frozen=True)
class TraversalContext:
    """backend: the distance path; tables: the constraint's raw views for
    the fused kernel (None where unfusable); satisfied: the (B, M) ids ->
    bool closure, tombstones included; fuse: the resolved fuse decision."""

    backend: DistanceBackend
    tables: Optional[ConstraintTables]
    satisfied: SatisfiedFn
    fuse: bool = False


def build_context(corpus: Corpus, constraint, queries, params: SearchParams,
                  pq_index=None, degree: int = 0) -> TraversalContext:
    """Resolve (params, constraint, corpus) into one TraversalContext: the
    distance backend (``PQBackend`` over ``pq_index`` for approx="pq",
    which raises without one), the constraint closure and its raw table
    views (the UDF verdict column only where the fused path is reachable),
    ``gather_distance``'s block shape from the tuning table (keyed on the
    row width x ``degree`` x beam x the queries' device type; nearest-shape
    fallback, host-side Python), and the fuse decision. ``degree`` is the
    graph degree when the caller has one (0 = unknown: the lookup then
    matches on the other key dimensions)."""
    satisfied = make_satisfied_fn(constraint, corpus)
    tables = constraint_tables(constraint, corpus, include_udf=params.fuse_expand != "off")
    if params.approx == "pq":
        if pq_index is None:
            raise ValueError("approx='pq' requires pq_index")
        backend = PQBackend(codes=pq_index.codes, lut=adc_table(pq_index, queries).contiguous())
    elif params.use_kernel:
        backend = L2KernelBackend(
            vectors=corpus.vectors,
            gd_config=tune_lookup("gather_distance", d=corpus.dim, deg=degree,
                                  beam=params.beam_width, platform=queries.device.type))
    else:
        backend = ExactBackend(vectors=corpus.vectors)
    fusable = tables is not None and backend.fusable
    if params.fuse_expand == "on" and not fusable:
        raise ValueError("fuse_expand='on' requires constraint tables (got a non-constraint "
                         "object the kernels cannot evaluate)")
    fuse = params.fuse_expand == "on" or (
        params.fuse_expand == "auto" and resolve_auto_fuse(fusable, queries.device))
    return TraversalContext(backend=backend, tables=tables, satisfied=satisfied, fuse=fuse)
