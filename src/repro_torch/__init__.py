"""PyTorch / CUDA port of the AIRSHIP constrained graph search, its streaming
mutable index (``repro_torch.streaming``) and hybrid execution (posting
scan, label overlays, strategy router), and of the two-tower retrieval
model that feeds it (``repro_torch.models.recsys``).

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX. Tensor-creating entry points default to ``device="cuda"``;
everything else runs where its tensors are.
"""
from repro_torch.core import (
    AttributeHistograms,
    ConstraintTables,
    Corpus,
    GraphIndex,
    LabelOverlay,
    LabelSetConstraint,
    OverlayCache,
    PostingLists,
    PQBackend,
    PQIndex,
    RangeConstraint,
    RangeIndex,
    RouterConfig,
    SearchParams,
    SearchResult,
    SearchStats,
    SelectivityEstimator,
    StrategyRouter,
    build_overlay,
    constrained_search,
    equal_constraint,
    exact_constrained_search,
    overlay_search,
    posting_search,
    pq_constrained_search,
    pq_train,
    recall,
    scan_selectivity,
    selectivity,
    three_stage_pipeline,
    unequal_pct_constraint,
)
from repro_torch.data import make_labeled_corpus, make_queries
from repro_torch.graph import build_index, build_partitioned_index
from repro_torch.interop import (
    from_reference_arrays,
    pq_index_from_reference,
    streaming_index_from_reference,
    two_tower_params_from_reference,
)
from repro_torch.streaming import IndexSnapshot, SlotPool, StreamingIndex

__all__ = [
    "AttributeHistograms",
    "ConstraintTables",
    "Corpus",
    "GraphIndex",
    "IndexSnapshot",
    "LabelOverlay",
    "LabelSetConstraint",
    "OverlayCache",
    "PQBackend",
    "PQIndex",
    "PostingLists",
    "RangeConstraint",
    "RangeIndex",
    "RouterConfig",
    "SearchParams",
    "SearchResult",
    "SearchStats",
    "SelectivityEstimator",
    "SlotPool",
    "StrategyRouter",
    "StreamingIndex",
    "build_index",
    "build_overlay",
    "build_partitioned_index",
    "constrained_search",
    "equal_constraint",
    "exact_constrained_search",
    "from_reference_arrays",
    "make_labeled_corpus",
    "make_queries",
    "overlay_search",
    "posting_search",
    "pq_constrained_search",
    "pq_index_from_reference",
    "pq_train",
    "recall",
    "scan_selectivity",
    "selectivity",
    "streaming_index_from_reference",
    "three_stage_pipeline",
    "two_tower_params_from_reference",
    "unequal_pct_constraint",
]
