"""Batched lock-step constrained proximity-graph search (AIRSHIP core):
the facade over ``repro_torch.core.engine`` (port of ``repro.core.search``).

  * ``vanilla``: Alg. 1, single frontier, constraint checked on pop.
  * ``start``: §2.2, + satisfied starting points from the build sample.
  * ``alter``: §2.3 / Alg. 2+3, satisfied and other frontiers selected by
    ``alter_ratio`` (estimated with Eq. 1 when not given).
  * ``prefer``: §2.5, + biased selection.
"""
from __future__ import annotations

from repro_torch.core.engine.context import (
    DistanceBackend,
    ExactBackend,
    L2KernelBackend,
    PQBackend,
    TraversalContext,
    build_context,
)
from repro_torch.core.engine.loop import constrained_search, search_with_context
from repro_torch.core.pq import PQIndex, pq_constrained_search, pq_train

__all__ = [
    "DistanceBackend",
    "ExactBackend",
    "L2KernelBackend",
    "PQBackend",
    "PQIndex",
    "TraversalContext",
    "build_context",
    "constrained_search",
    "pq_constrained_search",
    "pq_train",
    "search_with_context",
]
