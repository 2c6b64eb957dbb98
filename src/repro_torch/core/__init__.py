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
from repro_torch.core.search import constrained_search
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
    "recall",
    "unequal_pct_constraint",
]
