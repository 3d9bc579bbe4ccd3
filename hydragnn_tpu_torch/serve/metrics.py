"""Serving metrics (a stdlib copy of the counters the JAX package's
``obs/metrics.py::ServeMetrics`` records for the predict server).

``compiles_total`` counts the novel (model version, shape) keys the server
compiled a program for (on the card, captured a graph): its buckets at
warmup, and after that none, unless a shape leaked past the plan.
``requests_total`` counts every accepted submit; a request then ends in
exactly one of ``responses_total``, ``timeouts_total`` or
``errors_total``. ``shed_total`` counts queue-full rejections (never
accepted). Padding waste is kept as the two raw integrals (real and
padded node rows). Latencies go into fixed-bound histograms with
interpolated quantiles.
"""

import bisect
import threading
from typing import Dict, List

# log-spaced seconds, 500us .. 10s
DEFAULT_LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class LatencyHistogram:
    """Fixed-bound histogram; quantiles interpolate linearly inside the
    winning bucket (the Prometheus ``histogram_quantile`` rule)."""

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
        """Estimated q-quantile in seconds (0 with no observations; the last
        finite bound when the target falls in the +inf tail)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
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


class ServeMetrics:
    """The predict server's counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.responses_total = 0
        self.shed_total = 0
        self.timeouts_total = 0
        self.errors_total = 0
        self.batches_total = 0
        self.bucket_hits: Dict[int, int] = {}
        self.bucket_fallbacks = 0  # graph served by a larger bucket
        self.real_node_rows = 0
        self.padded_node_rows = 0
        self.queue_depth = 0
        self.deadline_met_total = 0
        self.deadline_missed_total = 0
        self.request_latency = LatencyHistogram()
        self.batch_latency = LatencyHistogram()
        self.compiles_total = 0

    def on_compile(self):
        with self._lock:
            self.compiles_total += 1

    def on_submit(self):
        with self._lock:
            self.requests_total += 1

    def on_shed(self):
        with self._lock:
            self.shed_total += 1

    def on_timeout(self, n: int = 1):
        # an in-queue expiry is a missed deadline
        with self._lock:
            self.timeouts_total += n
            self.deadline_missed_total += n

    def on_deadline(self, met: bool, n: int = 1):
        with self._lock:
            if met:
                self.deadline_met_total += n
            else:
                self.deadline_missed_total += n

    def on_error(self, n: int = 1):
        with self._lock:
            self.errors_total += n

    def set_queue_depth(self, depth: int):
        with self._lock:
            self.queue_depth = depth

    def on_batch(self, bucket: int, num_requests: int, real_nodes: int,
                 padded_nodes: int, batch_seconds: float, fallbacks: int = 0):
        with self._lock:
            self.batches_total += 1
            self.responses_total += num_requests
            self.bucket_hits[bucket] = self.bucket_hits.get(bucket, 0) + num_requests
            self.bucket_fallbacks += fallbacks
            self.real_node_rows += real_nodes
            self.padded_node_rows += padded_nodes
            self.batch_latency.observe(batch_seconds)

    def on_response_latency(self, seconds: float):
        with self._lock:
            self.request_latency.observe(seconds)

    def padding_waste_ratio(self) -> float:
        """Fraction of padded node rows that carried no real node."""
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
                "bucket_hits": dict(self.bucket_hits),
                "bucket_fallbacks": self.bucket_fallbacks,
                "queue_depth": self.queue_depth,
                "deadline_met_total": self.deadline_met_total,
                "deadline_missed_total": self.deadline_missed_total,
                "request_latency": self.request_latency.state(),
                "batch_latency": self.batch_latency.state(),
                "compiles_total": self.compiles_total,
            }
