"""Observability of training and serving (ports of the JAX package's
``obs/``): the metrics core with its Prometheus text (``metrics.py``), the
structured event stream (``events.py``), the ``/healthz`` + ``/metrics`` +
``/profile`` listener (``http.py``), request tracing (``trace.py``), drift
detection (``drift.py``), a training run's telemetry (``runtime.py``: the
run's events, live metrics, flight recorder and trace capture, and the
hooks the training code calls), the per-epoch scalars (``scalars.py``),
the captured programs' accounting and trace capture (``introspect.py``),
the goodput and MFU ledger and the fleet rollup (``ledger.py``), and the
post-mortem reports with the budget ratchet (``report.py``,
``python -m hydragnn_tpu_torch.obs``).

Quick start (training)::

    HYDRAGNN_OBS_PORT=8090 python train.py   # live /metrics, /healthz, /profile
    tail -f logs/<run>/events.jsonl          # the run's events
    python -m hydragnn_tpu_torch.obs report logs/<run>
"""

from hydragnn_tpu_torch.obs.events import (
    EVENT_FIELDS,
    SCHEMA_VERSION,
    RunEventLog,
    iter_events,
    validate_events,
)
from hydragnn_tpu_torch.obs.http import ObservabilityServer
from hydragnn_tpu_torch.obs.introspect import Profiler, TraceCapture, instrument
from hydragnn_tpu_torch.obs.ledger import (
    CATEGORIES,
    GoodputLedger,
    build_fleet_report,
    flag_stragglers,
    resolve_peak_flops,
)
from hydragnn_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BOUNDS,
    EPOCH_LATENCY_BOUNDS,
    LatencyHistogram,
    MetricsRegistry,
    ServeMetrics,
)
from hydragnn_tpu_torch.obs.runtime import (
    FlightRecorder,
    RunTelemetry,
    TrainingMetrics,
    activate,
    active,
    deactivate,
    init_run_telemetry,
)
from hydragnn_tpu_torch.obs.scalars import ScalarWriter
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
    "CATEGORIES",
    "DEFAULT_LATENCY_BOUNDS",
    "EPOCH_LATENCY_BOUNDS",
    "EVENT_FIELDS",
    "FlightRecorder",
    "GoodputLedger",
    "LatencyHistogram",
    "MetricsRegistry",
    "ObservabilityServer",
    "Profiler",
    "RequestTrace",
    "RunEventLog",
    "RunTelemetry",
    "SCHEMA_VERSION",
    "ScalarWriter",
    "ServeMetrics",
    "TRACE_HEADER",
    "TraceCapture",
    "TraceContext",
    "Tracer",
    "TrainingMetrics",
    "activate",
    "active",
    "anatomy",
    "build_fleet_report",
    "build_traces",
    "deactivate",
    "decode_header",
    "dominant_segment",
    "encode_header",
    "flag_stragglers",
    "init_run_telemetry",
    "instrument",
    "iter_events",
    "load_span_events",
    "resolve_peak_flops",
    "segment_durations",
    "validate_events",
]
