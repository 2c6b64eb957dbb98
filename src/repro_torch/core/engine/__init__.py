# Lock-step traversal engine: context (distance backend, constraint views,
# fuse decision), policy (frontier selection), expand (beam pop + one
# flattened candidate batch), loop (state, termination, stats).
from repro_torch.core.engine.context import (
    FUSE_AUTO_ON_CUDA,
    DistanceBackend,
    ExactBackend,
    L2KernelBackend,
    PQBackend,
    TraversalContext,
    build_context,
    resolve_auto_fuse,
)
from repro_torch.core.engine.expand import (
    expand_beam,
    expand_beam_fused,
    mask_first_occurrence,
    mask_first_occurrence_sorted,
    pop_frontier_beam,
)
from repro_torch.core.engine.loop import (
    TraversalState,
    constrained_search,
    search_with_context,
    seed_state,
)
from repro_torch.core.engine.policy import (
    POLICIES,
    FrontierPolicy,
    get_policy,
    is_two_queue,
    prefer_policy,
    ratio_policy,
    single_queue_policy,
)

__all__ = [
    "FUSE_AUTO_ON_CUDA",
    "POLICIES",
    "DistanceBackend",
    "ExactBackend",
    "FrontierPolicy",
    "L2KernelBackend",
    "PQBackend",
    "TraversalContext",
    "TraversalState",
    "build_context",
    "constrained_search",
    "expand_beam",
    "expand_beam_fused",
    "get_policy",
    "is_two_queue",
    "mask_first_occurrence",
    "mask_first_occurrence_sorted",
    "pop_frontier_beam",
    "prefer_policy",
    "ratio_policy",
    "resolve_auto_fuse",
    "search_with_context",
    "seed_state",
    "single_queue_policy",
]
