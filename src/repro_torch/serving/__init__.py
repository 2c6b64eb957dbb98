# Online serving runtime over the port's constrained search (port of
# ``repro.serving``, DESIGN.md §7): dynamic batcher (bucket-ladder shapes),
# shape-bucketed closure cache with a hard trace budget, adaptive tier
# controller with under-fill escalation, and the submit/poll runtime front
# with backpressure + telemetry; fault tolerance on top (DESIGN.md §10):
# deadline enforcement + load shedding, the SLO degradation ladder, client
# retry policy, and seeded fault injection; scale-out (DESIGN.md §13): the
# shared-nothing replica tier with its routers, and the distributed
# executor over a device mesh.
from repro_torch.serving.batcher import BATCH_LADDER, DynamicBatcher, MicroBatch, bucket_for
from repro_torch.serving.cache import CompileCache, TraceBudgetError
from repro_torch.serving.controller import (
    AdaptiveController,
    ControllerConfig,
    make_tier_ladder,
)
from repro_torch.serving.faults import (
    ExecutorFault,
    FaultClock,
    FaultConfig,
    FaultSchedule,
    FaultyExecutor,
    InjectedFault,
)
from repro_torch.serving.replicas import (
    ROUTER_KINDS,
    ConsistentHashRouter,
    LeastLoadedRouter,
    ReplicaSet,
    make_replica_router,
)
from repro_torch.serving.retry import RetryPolicy, submit_with_retry
from repro_torch.serving.slo import DegradationLadder, SLOConfig
from repro_torch.serving.runtime import (
    DistributedExecutor,
    EpochRangeView,
    LocalExecutor,
    ServingRuntime,
    StreamingLocalExecutor,
    assemble_constraint,
    assemble_queries,
    make_serving_router,
)
from repro_torch.serving.telemetry import LatencyHistogram, Telemetry, percentile
from repro_torch.serving.types import (
    MUTATION_FAMILIES,
    AdmissionError,
    DeleteRequest,
    Request,
    Response,
    UpsertRequest,
    VirtualClock,
    deadline_due,
    deadline_missed,
    wall_clock,
)
from repro_torch.serving.workload import (
    WorkItem,
    churn_workload,
    label_words_row,
    mixed_workload,
    poisson_arrivals,
    replay_churn,
    replay_poisson,
)

__all__ = [
    "AdaptiveController",
    "AdmissionError",
    "BATCH_LADDER",
    "CompileCache",
    "ConsistentHashRouter",
    "ControllerConfig",
    "DegradationLadder",
    "DeleteRequest",
    "DistributedExecutor",
    "DynamicBatcher",
    "EpochRangeView",
    "ExecutorFault",
    "FaultClock",
    "FaultConfig",
    "FaultSchedule",
    "FaultyExecutor",
    "InjectedFault",
    "LatencyHistogram",
    "LeastLoadedRouter",
    "LocalExecutor",
    "MUTATION_FAMILIES",
    "MicroBatch",
    "ROUTER_KINDS",
    "ReplicaSet",
    "Request",
    "Response",
    "RetryPolicy",
    "SLOConfig",
    "ServingRuntime",
    "StreamingLocalExecutor",
    "Telemetry",
    "TraceBudgetError",
    "UpsertRequest",
    "VirtualClock",
    "WorkItem",
    "assemble_constraint",
    "assemble_queries",
    "bucket_for",
    "churn_workload",
    "deadline_due",
    "deadline_missed",
    "label_words_row",
    "make_replica_router",
    "make_serving_router",
    "make_tier_ladder",
    "mixed_workload",
    "percentile",
    "poisson_arrivals",
    "replay_churn",
    "replay_poisson",
    "submit_with_retry",
    "wall_clock",
]
