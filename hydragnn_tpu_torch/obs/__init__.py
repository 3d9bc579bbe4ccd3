"""Observability shared by serving (and, later, training): the metrics core
with its Prometheus text, the structured event stream, the ``/healthz`` +
``/metrics`` listener, request tracing and drift detection (ports of the
JAX package's ``obs/metrics.py``, ``events.py``, ``http.py``, ``trace.py``
and ``drift.py``). The rest of the JAX package's ``obs/`` (run telemetry,
introspection, the goodput ledger) is not ported yet (``ROADMAP.md``, queue
1, item 10).
"""

from hydragnn_tpu_torch.obs.events import (
    EVENT_FIELDS,
    SCHEMA_VERSION,
    RunEventLog,
    iter_events,
    validate_events,
)
from hydragnn_tpu_torch.obs.http import ObservabilityServer
from hydragnn_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BOUNDS,
    EPOCH_LATENCY_BOUNDS,
    LatencyHistogram,
    MetricsRegistry,
    ServeMetrics,
)
from hydragnn_tpu_torch.obs.trace import (
    TRACE_HEADER,
    RequestTrace,
    TraceContext,
    Tracer,
    anatomy,
    build_traces,
    decode_header,
    dominant_segment,
    encode_header,
    load_span_events,
    segment_durations,
)

__all__ = [
    "DEFAULT_LATENCY_BOUNDS",
    "EPOCH_LATENCY_BOUNDS",
    "EVENT_FIELDS",
    "LatencyHistogram",
    "MetricsRegistry",
    "ObservabilityServer",
    "RequestTrace",
    "RunEventLog",
    "SCHEMA_VERSION",
    "ServeMetrics",
    "TRACE_HEADER",
    "TraceContext",
    "Tracer",
    "anatomy",
    "build_traces",
    "decode_header",
    "dominant_segment",
    "encode_header",
    "iter_events",
    "load_span_events",
    "segment_durations",
    "validate_events",
]
