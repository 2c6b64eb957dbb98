from repro_torch.core.constraints import (
    ConstraintTables,
    LabelSetConstraint,
    RangeConstraint,
    constraint_tables,
    equal_constraint,
    label_set_from_lists,
    make_satisfied_fn,
    selectivity,
    unequal_pct_constraint,
)
from repro_torch.core.distributed import (
    ShardedIndex,
    make_distributed_search,
    merge_topk,
    shard_corpus_for_mesh,
)
from repro_torch.core.estimator import (
    SelectivityEstimator,
    sample_satisfied_mask,
    sampled_selectivity,
    scan_selectivity,
)
from repro_torch.core.exact import exact_constrained_search, recall
from repro_torch.core.histogram import AttributeHistograms
from repro_torch.core.overlay import LabelOverlay, OverlayCache, build_overlay, overlay_search
from repro_torch.core.posting import PostingLists, RangeIndex, posting_search
from repro_torch.core.pipeline import three_stage_pipeline
from repro_torch.core.router import (
    RouteDecision,
    RouterConfig,
    StrategyRouter,
    single_label_of_words,
)
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
    "AttributeHistograms",
    "ConstraintTables",
    "Corpus",
    "GraphIndex",
    "LabelOverlay",
    "LabelSetConstraint",
    "OverlayCache",
    "PQBackend",
    "PQIndex",
    "PostingLists",
    "RangeConstraint",
    "RangeIndex",
    "RouteDecision",
    "RouterConfig",
    "SearchParams",
    "SearchResult",
    "SearchStats",
    "SelectivityEstimator",
    "ShardedIndex",
    "StrategyRouter",
    "build_overlay",
    "constrained_search",
    "constraint_tables",
    "equal_constraint",
    "exact_constrained_search",
    "label_set_from_lists",
    "make_distributed_search",
    "make_satisfied_fn",
    "merge_topk",
    "overlay_search",
    "posting_search",
    "pq_constrained_search",
    "pq_train",
    "recall",
    "sample_satisfied_mask",
    "sampled_selectivity",
    "scan_selectivity",
    "selectivity",
    "shard_corpus_for_mesh",
    "single_label_of_words",
    "three_stage_pipeline",
    "unequal_pct_constraint",
]
