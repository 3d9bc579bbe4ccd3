"""Shared metrics core: counters, gauges, latency histograms, Prometheus
text (a copy of the JAX package's ``obs/metrics.py``, which the port does
not import).

For the same sequence of calls, :meth:`ServeMetrics.render_prometheus` and
:meth:`MetricsRegistry.render_prometheus` give byte for byte the JAX
package's text (``tests/test_torch_obs.py``). Stdlib only: the Prometheus
text format is emitted directly, and ``snapshot()`` returns the same
numbers as a plain dict.

- :class:`LatencyHistogram` + :class:`ServeMetrics`: the predict server's
  counters. The port adds one, ``scorer_errors``: scored batches whose
  uncertainty program failed and that were answered unscored, as the JAX
  server answers them (silently there). It is in ``snapshot()``; the
  server's ``/metrics`` appends it after this class's text
  (``InferenceServer.render_prometheus``), so the text here stays the JAX
  package's.
- :class:`MetricsRegistry`: a declare-then-record registry (counter,
  gauge, histogram, labelled gauge under one lock) that the cost ledger,
  the uncertainty scorer and the tracer build on.
"""

import bisect
import threading
from typing import Dict, List, Optional

# log-spaced seconds, 500us .. 10s — single-graph GNN inference spans
# ~1ms (a warm bucket hit) to seconds (cold compile / queueing)
DEFAULT_LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# log-spaced seconds, 50ms .. 1h — training epochs span sub-second (tiny
# CI runs) to tens of minutes (at-scale multi-host epochs)
EPOCH_LATENCY_BOUNDS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
    150.0, 300.0, 600.0, 1500.0, 3600.0,
)


class LatencyHistogram:
    """Fixed-bound histogram with quantile estimates.

    Quantiles interpolate linearly inside the winning bucket (the
    Prometheus ``histogram_quantile`` rule) — exact enough for p50/p99
    reporting without retaining per-request samples."""

    def __init__(self, bounds=DEFAULT_LATENCY_BOUNDS):
        self.bounds: List[float] = list(bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +inf tail
        self.total = 0
        self.sum = 0.0

    def observe(self, seconds: float):
        self.counts[bisect.bisect_left(self.bounds, seconds)] += 1
        self.total += 1
        self.sum += seconds

    def quantile(self, q: float) -> float:
        """Estimated q-quantile in seconds (0 with no observations; the
        last finite bound when the target falls in the +inf tail)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (
                    self.bounds[i]
                    if i < len(self.bounds)
                    else self.bounds[-1]
                )
                return lo + (hi - lo) * (target - seen) / c
            seen += c
        return self.bounds[-1]

    def state(self) -> Dict:
        return {
            "count": self.total,
            "sum": round(self.sum, 6),
            "p50": round(self.quantile(0.50), 6),
            "p99": round(self.quantile(0.99), 6),
        }


def render_summary(prefix: str, name: str, hist_state: Dict) -> List[str]:
    """Prometheus summary lines for one :meth:`LatencyHistogram.state` —
    the ONE place the summary exposition format lives."""
    return [
        f"# TYPE {prefix}_{name} summary",
        f'{prefix}_{name}{{quantile="0.5"}} {hist_state["p50"]}',
        f'{prefix}_{name}{{quantile="0.99"}} {hist_state["p99"]}',
        f"{prefix}_{name}_sum {hist_state['sum']}",
        f"{prefix}_{name}_count {hist_state['count']}",
    ]


class MetricsRegistry:
    """Generic thread-safe metrics: declare once, record from any thread.

    The declaration order is the exposition order. Histograms render as
    Prometheus summaries (p50/p99 + sum + count), matching the serving
    exposition so dashboards treat training and serving series alike.
    """

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}   # name -> counter|gauge|histogram
        self._help: Dict[str, str] = {}
        self._values: Dict[str, object] = {}

    def _declare(self, name: str, kind: str, help_text: str, init):
        with self._lock:
            if name in self._kinds:
                raise ValueError(f"metric {name!r} already declared")
            self._kinds[name] = kind
            self._help[name] = help_text
            self._values[name] = init
        return self

    def counter(self, name: str, help_text: str = ""):
        return self._declare(name, "counter", help_text, 0)

    def gauge(self, name: str, help_text: str = ""):
        return self._declare(name, "gauge", help_text, 0.0)

    def histogram(self, name: str, help_text: str = "",
                  bounds=DEFAULT_LATENCY_BOUNDS):
        return self._declare(
            name, "histogram", help_text, LatencyHistogram(bounds)
        )

    def labeled_gauge(self, name: str, help_text: str = ""):
        """A gauge family keyed by label sets (e.g. per-bucket compiled
        FLOPs): one declaration, one exposition line per distinct label
        combination recorded via :meth:`set_labeled`."""
        return self._declare(name, "labeled_gauge", help_text, {})

    def inc(self, name: str, value: int = 1):
        with self._lock:
            self._values[name] += value

    def set(self, name: str, value: float):
        with self._lock:
            self._values[name] = value

    def set_labeled(self, name: str, value: float, **labels):
        """Record one label-set's value on a :meth:`labeled_gauge`.
        Label RENDER order is the sorted key order — deterministic
        exposition regardless of call-site kwarg order."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._values[name][key] = value

    def clear_labeled(self, name: str):
        """Drop every label set of a :meth:`labeled_gauge` — for families
        whose membership is a LIVE view (e.g. per-host fleet gauges): a
        member that disappeared must stop being exported, not freeze at
        its last value."""
        with self._lock:
            self._values[name].clear()

    def observe(self, name: str, seconds: float):
        with self._lock:
            self._values[name].observe(seconds)

    def get(self, name: str):
        with self._lock:
            return self._freeze(self._kinds[name], self._values[name])

    @staticmethod
    def _freeze(kind, value):
        if kind == "histogram":
            return value.state()
        if kind == "labeled_gauge":
            return {
                ",".join(f"{k}={v}" for k, v in key): val
                for key, val in value.items()
            }
        return value

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                n: self._freeze(self._kinds[n], v)
                for n, v in self._values.items()
            }

    def render_prometheus(self, prefix: Optional[str] = None) -> str:
        prefix = prefix or self.prefix
        with self._lock:
            names = list(self._kinds)
            kinds = dict(self._kinds)
            helps = dict(self._help)
            values = {
                n: (dict(v) if isinstance(v, dict) else
                    v.state() if isinstance(v, LatencyHistogram) else v)
                for n, v in self._values.items()
            }
        lines = []
        for name in names:
            kind = kinds[name]
            if kind == "histogram":
                lines.extend(render_summary(prefix, name, values[name]))
                continue
            if kind == "labeled_gauge":
                series = values[name]
                if not series:  # no label sets yet: no exposition lines
                    continue
                lines.append(f"# HELP {prefix}_{name} {helps[name]}")
                lines.append(f"# TYPE {prefix}_{name} gauge")
                for key in sorted(series):
                    labels = ",".join(f'{k}="{v}"' for k, v in key)
                    v = series[key]
                    if isinstance(v, float):
                        v = round(v, 6)
                    lines.append(f"{prefix}_{name}{{{labels}}} {v}")
                continue
            lines.append(f"# HELP {prefix}_{name} {helps[name]}")
            lines.append(f"# TYPE {prefix}_{name} {kind}")
            v = values[name]
            if isinstance(v, float):
                v = round(v, 6)
            lines.append(f"{prefix}_{name} {v}")
        return "\n".join(lines) + "\n"


class ServeMetrics:
    """All counters the predict server reports (thread-safe).

    ``requests_total`` counts every accepted submit; a request then ends
    in exactly one of ``responses_total``, ``timeouts_total``, or
    ``errors_total``. ``shed_total`` counts queue-full rejections (never
    accepted, so not in ``requests_total``). Padding waste is tracked as
    the two raw integrals (real vs padded node rows) so the ratio stays
    exact under any aggregation window.

    SLO accounting: every DEADLINE-CARRYING
    request that reaches a terminal serving outcome resolves to exactly
    one ``deadline_met_total`` / ``deadline_missed_total`` — missed
    covers both in-queue expiry (``on_timeout`` counts it automatically)
    and a response delivered after its deadline. Requests that FAIL
    (``errors_total``) are serving failures, not deadline outcomes, and
    touch neither counter — reconcile against ``errors_total``
    separately. ``slo_misses_total`` is the alertable counter
    (== missed); ``slo_miss_ratio`` the derived gauge. Requests without
    deadlines never touch these series."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.responses_total = 0
        self.shed_total = 0
        self.timeouts_total = 0
        self.errors_total = 0
        self.batches_total = 0
        self.compiles_total = 0
        self.bucket_hits: Dict[int, int] = {}
        self.bucket_fallbacks = 0  # graph served by a larger bucket
        self.real_node_rows = 0
        self.padded_node_rows = 0
        self.queue_depth = 0
        self.deadline_met_total = 0
        self.deadline_missed_total = 0
        # response-cache series (serve/cache.py): hits answer without a
        # bucket slot, bytes is the cache's CURRENT payload residency
        self.cache_hits_total = 0
        self.cache_misses_total = 0
        self.cache_evictions_total = 0
        self.cache_bytes = 0
        # scored batches answered unscored because the uncertainty
        # program failed (the port's counter; not in the JAX text below)
        self.scorer_errors = 0
        self.request_latency = LatencyHistogram()
        self.batch_latency = LatencyHistogram()

    # ---- recording -----------------------------------------------------
    def on_submit(self):
        with self._lock:
            self.requests_total += 1

    def on_shed(self):
        with self._lock:
            self.shed_total += 1

    def on_response(self, n: int = 1):
        """A request reached a successful terminal response without a
        packed batch to account it (the fleet router's path; the
        in-process server counts responses per batch via
        :meth:`on_batch`)."""
        with self._lock:
            self.responses_total += n

    def on_timeout(self, n: int = 1):
        # an in-queue expiry IS a missed deadline (only deadline-carrying
        # requests can time out)
        with self._lock:
            self.timeouts_total += n
            self.deadline_missed_total += n

    def on_deadline(self, met: bool, n: int = 1):
        """A deadline-carrying request completed: did its response land
        before the deadline?"""
        with self._lock:
            if met:
                self.deadline_met_total += n
            else:
                self.deadline_missed_total += n

    def on_error(self, n: int = 1):
        with self._lock:
            self.errors_total += n

    def on_compile(self):
        with self._lock:
            self.compiles_total += 1

    def on_cache_hit(self, n: int = 1):
        with self._lock:
            self.cache_hits_total += n

    def on_cache_miss(self, n: int = 1):
        with self._lock:
            self.cache_misses_total += n

    def on_cache_evict(self, n: int = 1):
        with self._lock:
            self.cache_evictions_total += n

    def on_scorer_error(self, n: int = 1):
        with self._lock:
            self.scorer_errors += n

    def set_cache_bytes(self, nbytes: int):
        with self._lock:
            self.cache_bytes = int(nbytes)

    def set_queue_depth(self, depth: int):
        with self._lock:
            self.queue_depth = depth

    def on_batch(
        self,
        bucket: int,
        num_requests: int,
        real_nodes: int,
        padded_nodes: int,
        batch_seconds: float,
        fallbacks: int = 0,
    ):
        with self._lock:
            self.batches_total += 1
            self.responses_total += num_requests
            self.bucket_hits[bucket] = (
                self.bucket_hits.get(bucket, 0) + num_requests
            )
            self.bucket_fallbacks += fallbacks
            self.real_node_rows += real_nodes
            self.padded_node_rows += padded_nodes
            self.batch_latency.observe(batch_seconds)

    def on_response_latency(self, seconds: float):
        with self._lock:
            self.request_latency.observe(seconds)

    # ---- reading -------------------------------------------------------
    def padding_waste_ratio(self) -> float:
        """Fraction of padded node rows that carried no real node — 0 is
        a perfectly full batch, 1-ish means the padding dominates."""
        with self._lock:
            if self.padded_node_rows == 0:
                return 0.0
            return 1.0 - self.real_node_rows / self.padded_node_rows

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "shed_total": self.shed_total,
                "timeouts_total": self.timeouts_total,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "compiles_total": self.compiles_total,
                "bucket_hits": dict(self.bucket_hits),
                "bucket_fallbacks": self.bucket_fallbacks,
                "queue_depth": self.queue_depth,
                "padding_waste_ratio": round(
                    0.0
                    if self.padded_node_rows == 0
                    else 1.0 - self.real_node_rows / self.padded_node_rows,
                    6,
                ),
                "deadline_met_total": self.deadline_met_total,
                "deadline_missed_total": self.deadline_missed_total,
                "slo_miss_ratio": round(
                    self.deadline_missed_total
                    / max(
                        self.deadline_met_total
                        + self.deadline_missed_total,
                        1,
                    ),
                    6,
                ),
                "cache_hits_total": self.cache_hits_total,
                "cache_misses_total": self.cache_misses_total,
                "cache_evictions_total": self.cache_evictions_total,
                "cache_bytes": self.cache_bytes,
                "scorer_errors": self.scorer_errors,
                "request_latency": self.request_latency.state(),
                "batch_latency": self.batch_latency.state(),
            }

    def render_prometheus(self, prefix: str = "hydragnn_serve") -> str:
        """Prometheus text exposition of :meth:`snapshot`."""
        s = self.snapshot()
        lines = []

        def counter(name, value, help_text):
            lines.append(f"# HELP {prefix}_{name} {help_text}")
            kind = "gauge" if name.endswith(("_depth", "_ratio")) else "counter"
            lines.append(f"# TYPE {prefix}_{name} {kind}")
            lines.append(f"{prefix}_{name} {value}")

        counter("requests_total", s["requests_total"], "Accepted requests")
        counter("responses_total", s["responses_total"], "Completed requests")
        counter("shed_total", s["shed_total"], "Queue-full rejections")
        counter("timeouts_total", s["timeouts_total"], "Deadline expiries")
        counter("errors_total", s["errors_total"], "Failed requests")
        counter("batches_total", s["batches_total"], "Dispatched micro-batches")
        counter("compiles_total", s["compiles_total"], "Novel-shape compiles")
        counter(
            "bucket_fallbacks_total",
            s["bucket_fallbacks"],
            "Requests served by a larger bucket than their node count",
        )
        counter("queue_depth", s["queue_depth"], "Requests waiting")
        counter(
            "padding_waste_ratio",
            s["padding_waste_ratio"],
            "Padded node rows carrying no real node",
        )
        for b, hits in sorted(s["bucket_hits"].items()):
            lines.append(
                f'{prefix}_bucket_hits_total{{bucket="{b}"}} {hits}'
            )
        for name, hist in (
            ("request_latency_seconds", s["request_latency"]),
            ("batch_latency_seconds", s["batch_latency"]),
        ):
            lines.extend(render_summary(prefix, name, hist))
        # the SLO series come after the historical exposition, as in the
        # JAX package's text
        counter(
            "slo_misses_total",
            s["deadline_missed_total"],
            "Deadline-carrying requests that missed their deadline",
        )
        lines.append(
            f'{prefix}_deadline_outcomes_total{{outcome="met"}} '
            f'{s["deadline_met_total"]}'
        )
        lines.append(
            f'{prefix}_deadline_outcomes_total{{outcome="missed"}} '
            f'{s["deadline_missed_total"]}'
        )
        counter(
            "slo_miss_ratio",
            s["slo_miss_ratio"],
            "Fraction of deadline-carrying requests that missed",
        )
        # the response-cache series after the SLO tail, as in the JAX text
        counter(
            "cache_hits_total",
            s["cache_hits_total"],
            "Requests answered from the response cache",
        )
        counter(
            "cache_misses_total",
            s["cache_misses_total"],
            "Cache lookups that fell through to dispatch",
        )
        counter(
            "cache_evictions_total",
            s["cache_evictions_total"],
            "Entries evicted by the LRU bounds",
        )
        lines.append(
            f"# HELP {prefix}_cache_bytes Resident response-cache payload "
            "bytes"
        )
        lines.append(f"# TYPE {prefix}_cache_bytes gauge")
        lines.append(f"{prefix}_cache_bytes {s['cache_bytes']}")
        return "\n".join(lines) + "\n"
