# Observability over the serving runtime (port of ``repro.obs``, plain
# Python): per-request span tracing and structured JSON logs behind a
# ring-buffer sink. Dependency direction: repro_torch.serving imports
# repro_torch.obs, never the reverse. The metrics registry, its Prometheus
# exposition and the HTTP front end are not ported yet (ROADMAP item 11b).
from repro_torch.obs.logs import JsonLogger, RingBufferSink
from repro_torch.obs.tracing import (
    STAGES,
    RequestTrace,
    stage_sum,
    trace_consistent,
)

__all__ = [
    "JsonLogger",
    "RequestTrace",
    "RingBufferSink",
    "STAGES",
    "stage_sum",
    "trace_consistent",
]
