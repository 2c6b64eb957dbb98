"""PyTorch / CUDA port of the AIRSHIP constrained graph search (and of the
two-tower retrieval model that feeds it: ``repro_torch.models.recsys``).

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX. Tensor-creating entry points default to ``device="cuda"``;
everything else runs where its tensors are.
"""
from repro_torch.core import (
    ConstraintTables,
    Corpus,
    GraphIndex,
    LabelSetConstraint,
    PQBackend,
    PQIndex,
    RangeConstraint,
    SearchParams,
    SearchResult,
    SearchStats,
    constrained_search,
    equal_constraint,
    exact_constrained_search,
    pq_constrained_search,
    pq_train,
    recall,
    three_stage_pipeline,
    unequal_pct_constraint,
)
from repro_torch.data import make_labeled_corpus, make_queries
from repro_torch.graph import build_index, build_partitioned_index
from repro_torch.interop import (
    from_reference_arrays,
    pq_index_from_reference,
    two_tower_params_from_reference,
)

__all__ = [
    "ConstraintTables",
    "Corpus",
    "GraphIndex",
    "LabelSetConstraint",
    "PQBackend",
    "PQIndex",
    "RangeConstraint",
    "SearchParams",
    "SearchResult",
    "SearchStats",
    "build_index",
    "build_partitioned_index",
    "constrained_search",
    "equal_constraint",
    "exact_constrained_search",
    "from_reference_arrays",
    "make_labeled_corpus",
    "make_queries",
    "pq_constrained_search",
    "pq_index_from_reference",
    "pq_train",
    "recall",
    "three_stage_pipeline",
    "two_tower_params_from_reference",
    "unequal_pct_constraint",
]
