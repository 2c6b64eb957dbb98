# Operational observability layer (DESIGN.md §12; port of ``repro.obs``,
# plain Python): metrics registry with Prometheus text exposition, per-request
# span tracing, structured JSON logs behind a ring-buffer sink, and the
# stdlib HTTP front end over the serving runtime. Dependency direction:
# repro_torch.serving imports repro_torch.obs, never the reverse — every
# adapter here is duck-typed over runtime objects.
from repro_torch.obs.adapters import (
    instrument_runtime,
    instrument_tier,
    latency_hist_samples,
    rollup_samples,
    runtime_families,
)
from repro_torch.obs.logs import JsonLogger, RingBufferSink
from repro_torch.obs.metrics import (
    CallbackFamily,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    format_value,
)
from repro_torch.obs.promparse import (
    ExpositionParseError,
    ParsedFamily,
    parse_exposition,
)
from repro_torch.obs.tracing import (
    STAGES,
    RequestTrace,
    stage_sum,
    trace_consistent,
)

__all__ = [
    "CallbackFamily",
    "Counter",
    "ExpositionParseError",
    "Gauge",
    "Histogram",
    "JsonLogger",
    "MetricsRegistry",
    "ParsedFamily",
    "RequestTrace",
    "RingBufferSink",
    "STAGES",
    "ServingFrontend",
    "format_value",
    "instrument_runtime",
    "instrument_tier",
    "latency_hist_samples",
    "parse_exposition",
    "rollup_samples",
    "runtime_families",
    "stage_sum",
    "trace_consistent",
]


def __getattr__(name: str):
    # The HTTP front end imports threading/http.server; keep that out of
    # the import path of code that only wants metrics/tracing primitives.
    if name == "ServingFrontend":
        from repro_torch.obs.http import ServingFrontend

        return ServingFrontend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
