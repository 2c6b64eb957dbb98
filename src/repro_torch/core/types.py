"""Core value types (port of ``repro.core.types``).

Frozen dataclasses of tensors in place of the reference's pytrees. Bitset
words (tombstones) hold the reference's uint32 bits as int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class Corpus:
    """Base vectors plus their attributes.

    vectors: (n, d) float32
    labels: (n,) int32 categorical attribute (equal / unequal-X% families)
    attrs: (n, m) float32 numeric attributes for range constraints and UDFs
    tombstones: (ceil(n/32),) int32 dead-slot bitmap; a set bit marks a slot
        that is never returned. None means every row is live.
    """

    vectors: Tensor
    labels: Tensor
    attrs: Optional[Tensor] = None
    tombstones: Optional[Tensor] = None

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


@dataclass(frozen=True)
class GraphIndex:
    """Proximity-graph index.

    neighbors: (n, deg) int32 adjacency, rows distance-ascending, -1 padded.
    sample_ids: (s,) int32 pre-drawn corpus sample for AIRSHIP-Start.
    entry_point: () int32 medoid entry vertex; (n_shards,) int32, one local
        medoid per shard, in the layout of ``build_partitioned_index``.
    """

    neighbors: Tensor
    sample_ids: Tensor
    entry_point: Tensor

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]


@dataclass(frozen=True)
class SearchParams:
    """Static search configuration; the fields and defaults of the reference."""

    mode: str = "prefer"  # vanilla | start | alter | prefer
    k: int = 10
    # Result-list capacity for the termination test; 0 -> max(k, 64).
    ef_result: int = 0
    ef_sat: int = 128
    ef_other: int = 128
    n_start: int = 32
    max_iters: int = 512
    # Vertices popped per query per lock-step iteration.
    beam_width: int = 1
    # None -> estimate per query with the Eq.-1 kNN statistic.
    alter_ratio: Optional[float] = None
    alter_ratio_k: int = 16
    # Unfused distances through the gather_distance kernel.
    use_kernel: bool = False
    # auto | on | off: one fused_expand pass per iteration plus sorted
    # merges (engine/context.py::resolve_auto_fuse decides "auto").
    fuse_expand: str = "auto"
    # exact | pq (ADC traversal over PQ codes with exact re-rank,
    # engine/context.py::PQBackend).
    approx: str = "exact"

    def __post_init__(self):
        if self.mode not in ("vanilla", "start", "alter", "prefer"):
            raise ValueError(f"unknown search mode: {self.mode}")
        if self.approx not in ("exact", "pq"):
            raise ValueError(f"unknown approx mode: {self.approx}")
        if self.beam_width < 1:
            raise ValueError(f"beam_width must be >= 1, got {self.beam_width}")
        if self.fuse_expand not in ("auto", "on", "off"):
            raise ValueError(f"unknown fuse_expand mode: {self.fuse_expand}")

    @property
    def result_capacity(self) -> int:
        return self.ef_result if self.ef_result > 0 else max(self.k, 64)


@dataclass(frozen=True)
class SearchStats:
    """Per-query instrumentation (hardware-independent cost measures)."""

    dist_evals: Tensor  # (B,) int32
    hops: Tensor  # (B,) int32
    visited: Tensor  # (B,) int32
    iters: Tensor  # () int32
    beam_expansions: Optional[Tensor] = None  # (B, beam_width) int32


@dataclass(frozen=True)
class SearchResult:
    dists: Tensor  # (B, K) float32 ascending, +inf padded
    ids: Tensor  # (B, K) int32, -1 padded
    stats: SearchStats

    @property
    def filled(self) -> Tensor:
        """(B,) int32: result slots actually filled (id >= 0)."""
        return (self.ids >= 0).sum(-1, dtype=torch.int32)


SatisfiedFn = Callable[[Tensor], Tensor]  # (B, M) ids -> (B, M) bool
