from repro_torch.core.constraints import (
    ConstraintTables,
    LabelSetConstraint,
    RangeConstraint,
    constraint_tables,
    equal_constraint,
    label_set_from_lists,
    make_satisfied_fn,
    unequal_pct_constraint,
)
from repro_torch.core.exact import exact_constrained_search, recall
from repro_torch.core.pipeline import three_stage_pipeline
from repro_torch.core.search import (
    PQBackend,
    PQIndex,
    constrained_search,
    pq_constrained_search,
    pq_train,
)
from repro_torch.core.types import (
    Corpus,
    GraphIndex,
    SearchParams,
    SearchResult,
    SearchStats,
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
    "constrained_search",
    "constraint_tables",
    "equal_constraint",
    "exact_constrained_search",
    "label_set_from_lists",
    "make_satisfied_fn",
    "pq_constrained_search",
    "pq_train",
    "recall",
    "three_stage_pipeline",
    "unequal_pct_constraint",
]
