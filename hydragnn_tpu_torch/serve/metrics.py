"""Serving metrics: a re-export of the shared core, ``obs/metrics.py``
(the JAX package's ``serve/metrics.py`` does the same).

``compiles_total`` counts the novel (program, shape) keys the server
captured a graph for (a forward per model version and bucket, and with an
uncertainty scorer its scoring program per member set and bucket): its
buckets at warmup, and after that none, unless a shape leaked past the
plan. ``requests_total`` counts every accepted submit; a request then ends
in exactly one of ``responses_total``, ``timeouts_total`` or
``errors_total``. ``shed_total`` counts queue-full and over-quota
rejections (never accepted).
"""

from hydragnn_tpu_torch.obs.metrics import (  # noqa: F401  (re-exported API)
    DEFAULT_LATENCY_BOUNDS,
    LatencyHistogram,
    MetricsRegistry,
    ServeMetrics,
)

__all__ = [
    "DEFAULT_LATENCY_BOUNDS",
    "LatencyHistogram",
    "MetricsRegistry",
    "ServeMetrics",
]
