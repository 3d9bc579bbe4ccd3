"""Request tracing: one causal span tree per request (a copy of the JAX
package's ``obs/trace.py``, which the port does not import).

A traced request carries a :class:`TraceContext` (built from the
``X-Hydragnn-Trace`` header, :func:`encode_header`/:func:`decode_header`)
or a :class:`RequestTrace` (the front door's buffer, :meth:`Tracer.start`).
The port's single-replica server records ``queue_wait``, ``batch_form``,
``dispatch`` and ``readback`` for each traced rider of a batch, and
``cache_lookup`` for a hit; the fleet router (``serve/router.py``) records
``admit``, ``cache_lookup``, ``backoff`` and ``attempt`` and merges the
replicas' spans under each attempt. :meth:`Tracer.from_env` reads the rate
from ``HYDRAGNN_TRACE_SAMPLE``.

- Spans are ``span`` events in a ``RunEventLog`` stream
  (``obs/events.py``); :func:`load_span_events`, :func:`build_traces`,
  :func:`segment_durations`, :func:`dominant_segment` and :func:`anatomy`
  rebuild the trees and the latency anatomy. Files written by either
  package load in the other's.
- Tail-based sampling: ``Tracer(sample=)`` (0 = off) arms per-request
  buffering, and the flush is decided at the request's
  outcome: head-sampled traces (a deterministic hash of the trace id under
  the rate) always flush, SLO misses and errors at any non-zero rate.
- Zero cost when off: :meth:`Tracer.start` returns ``None`` and the hot
  path pays one ``is None`` check.
"""

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from hydragnn_tpu_torch.obs.events import iter_events
from hydragnn_tpu_torch.obs.metrics import MetricsRegistry
from hydragnn_tpu_torch.utils.envparse import env_float

TRACE_HEADER = "X-Hydragnn-Trace"

# span names recorded by each side
ROUTER_SPANS = ("route", "admit", "cache_lookup", "backoff", "attempt")
REPLICA_SPANS = ("queue_wait", "batch_form", "dispatch", "readback")
# container spans hold other spans; segment accounting uses their
# EXCLUSIVE time (container minus children) so segments sum to the root
CONTAINER_SPANS = ("route", "attempt")


def new_id(nbytes: int = 8) -> str:
    """Random lowercase-hex id (16 chars for traces, 8 for spans)."""
    return os.urandom(nbytes).hex()


def head_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling decision from the trace id alone —
    every component that sees the id agrees without coordination."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    try:
        return int(trace_id[:8], 16) / float(0xFFFFFFFF) < rate
    except ValueError:
        return False


def encode_header(trace_id: str, parent_span: str) -> str:
    """``X-Hydragnn-Trace`` value: ``<trace_id>-<parent_span>-01``
    (W3C-traceparent-shaped; the trailing flags byte says "armed")."""
    return f"{trace_id}-{parent_span}-01"


def decode_header(value: Optional[str]):
    """``(trace_id, parent_span)`` or None for absent/malformed values —
    a garbled header must disarm tracing, never fail the request."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 2 or not parts[0] or not parts[1]:
        return None
    return parts[0], parts[1]


class TraceContext:
    """Replica-side span collector for ONE armed request.

    Created from the propagated header; ``export()`` returns the
    JSON-able spans the response body carries back to the router (the
    single writer of the trace's event stream). Thread-safe: the batcher
    thread records while the handler thread exports."""

    __slots__ = ("trace_id", "parent_id", "_lock", "_spans")

    def __init__(self, trace_id: str, parent_id: str):
        self.trace_id = trace_id
        self.parent_id = parent_id
        self._lock = threading.Lock()
        self._spans: List[Dict] = []

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["TraceContext"]:
        decoded = decode_header(value)
        if decoded is None:
            return None
        return cls(*decoded)

    def record(self, name: str, start: float, dur_s: float,
               parent: Optional[str] = None, **attrs) -> str:
        span_id = new_id()
        span = {
            "trace": self.trace_id,
            "span": span_id,
            # None defaults to the propagated parent; "" is an explicit
            # root marker and must survive
            "parent": self.parent_id if parent is None else parent,
            "name": name,
            "start": round(float(start), 6),
            "dur_s": round(max(float(dur_s), 0.0), 9),
            "attrs": attrs,
        }
        with self._lock:
            self._spans.append(span)
        return span_id

    def export(self) -> List[Dict]:
        with self._lock:
            return list(self._spans)


class RequestTrace:
    """Router-side per-request span buffer (the tail-sampling unit).

    Spans accumulate here — recorded locally or merged from replica
    response bodies — until :meth:`finish` decides the flush: head
    sample says yes, OR the request missed its SLO, OR it errored."""

    def __init__(self, tracer: "Tracer", trace_id: str, sampled: bool,
                 **attrs):
        self.tracer = tracer
        self.trace_id = trace_id
        self.sampled = sampled
        self.root_id = new_id()
        self.attrs = dict(attrs)
        self._lock = threading.Lock()
        self._spans: List[Dict] = []
        self._start_wall = time.time()
        self._start_mono = time.monotonic()
        self._finished = False

    # ---- recording -----------------------------------------------------
    def record(self, name: str, start: float, dur_s: float,
               parent: Optional[str] = None,
               span_id: Optional[str] = None, **attrs) -> str:
        span_id = span_id or new_id()
        span = {
            "trace": self.trace_id,
            "span": span_id,
            "parent": self.root_id if parent is None else parent,
            "name": name,
            "start": round(float(start), 6),
            "dur_s": round(max(float(dur_s), 0.0), 9),
            "attrs": attrs,
        }
        with self._lock:
            self._spans.append(span)
        return span_id

    def merge(self, spans) -> None:
        """Fold a replica's exported spans (response-body ``spans``
        field) into this buffer. Tolerant of garbage — a malformed
        remote span drops, it never fails the live response."""
        if not spans:
            return
        keep = []
        for s in spans:
            if not isinstance(s, dict):
                continue
            if s.get("trace") != self.trace_id:
                continue
            if not s.get("span") or not s.get("name"):
                continue
            keep.append({
                "trace": self.trace_id,
                "span": str(s["span"]),
                "parent": s.get("parent") or self.root_id,
                "name": str(s["name"]),
                "start": float(s.get("start", 0.0)),
                "dur_s": float(s.get("dur_s", 0.0)),
                "attrs": dict(s.get("attrs") or {}),
            })
        if keep:
            with self._lock:
                self._spans.extend(keep)

    def header(self, parent_span: Optional[str] = None) -> str:
        """Propagation header for one replica attempt; ``parent_span``
        (usually the attempt span's pre-generated id) roots the
        replica's spans under that attempt."""
        return encode_header(self.trace_id, parent_span or self.root_id)

    # ---- outcome -------------------------------------------------------
    def finish(self, status: str, slo_missed: bool = False,
               error: bool = False, **attrs) -> bool:
        """Terminal outcome: record the root ``route`` span and flush
        the buffer when head-sampled or tail-selected (SLO miss /
        error). Returns whether the trace flushed. Idempotent — only
        the first call emits."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
        dur = time.monotonic() - self._start_mono
        root_attrs = dict(self.attrs)
        root_attrs.update(attrs)
        root_attrs["status"] = status
        root_attrs["slo_missed"] = bool(slo_missed)
        self.record(
            "route", self._start_wall, dur, parent="", span_id=self.root_id,
            **root_attrs,
        )
        flush = self.sampled or slo_missed or error
        self.tracer._on_finish(self, flush, slo_missed, error)
        return flush


class Tracer:
    """Process-wide tracing front door: sampling config + flush sink.

    ``emit(event_type, **fields)`` is any schema-gated event emitter —
    ``RunEventLog.emit``, for one. With no sink or a
    zero rate, :meth:`start` returns ``None`` and tracing costs one
    ``is None`` check per request."""

    def __init__(self, sample: float = 0.0,
                 emit: Optional[Callable] = None):
        self.sample = max(float(sample), 0.0)
        self.emit = emit
        self.metrics = MetricsRegistry("hydragnn")
        self.metrics.counter(
            "trace_requests_total", "Requests armed for tracing"
        )
        self.metrics.counter(
            "trace_flushed_total", "Traces flushed to the event stream"
        )
        self.metrics.counter(
            "trace_sampled_total", "Traces flushed by the head sample"
        )
        self.metrics.counter(
            "trace_tail_total",
            "Traces flushed ONLY by the tail rules (SLO miss / error)",
        )
        self.metrics.counter(
            "trace_spans_total", "Spans written to the event stream"
        )

    @classmethod
    def from_env(cls, emit: Optional[Callable] = None) -> "Tracer":
        """The head-sample rate from ``HYDRAGNN_TRACE_SAMPLE`` (default 0:
        off; SLO misses and errors flush at any non-zero rate)."""
        return cls(sample=env_float("HYDRAGNN_TRACE_SAMPLE", 0.0, minimum=0.0), emit=emit)

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0 and self.emit is not None

    def start(self, **attrs) -> Optional[RequestTrace]:
        """Arm one request (or return None when tracing is off). EVERY
        armed request buffers — the tail rules need the spans of
        requests the head sample rejected."""
        if not self.enabled:
            return None
        trace_id = new_id(8)
        self.metrics.inc("trace_requests_total")
        return RequestTrace(
            self, trace_id, head_sampled(trace_id, self.sample), **attrs
        )

    def _on_finish(self, trace: RequestTrace, flush: bool,
                   slo_missed: bool, error: bool) -> None:
        if not flush:
            return
        self.metrics.inc("trace_flushed_total")
        if trace.sampled:
            self.metrics.inc("trace_sampled_total")
        elif slo_missed or error:
            self.metrics.inc("trace_tail_total")
        emit = self.emit
        if emit is None:
            return
        spans = sorted(trace._spans, key=lambda s: (s["start"], s["span"]))
        for span in spans:
            try:
                emit("span", **span)
            except Exception:
                return  # a full disk must not fail the request path
        self.metrics.inc("trace_spans_total", len(spans))

    def render_prometheus(self) -> str:
        return self.metrics.render_prometheus()


# ---- reconstruction ---------------------------------------------------------


def load_span_events(root: str) -> List[Dict]:
    """Every ``span`` event under ``root`` (a directory searched
    recursively for ``events*.jsonl``, or one stream file), read by
    :func:`~hydragnn_tpu_torch.obs.events.iter_events`."""
    return [rec for rec in iter_events(root) if rec["event"] == "span" and rec.get("trace")]


def build_traces(spans: List[Dict]) -> Dict[str, Dict]:
    """Group spans into trace trees: ``{trace_id: {"root": span|None,
    "spans": [...], "children": {span_id: [child span, ...]}}}``."""
    traces: Dict[str, Dict] = {}
    for span in spans:
        t = traces.setdefault(
            span["trace"], {"root": None, "spans": [], "children": {}}
        )
        t["spans"].append(span)
        if span.get("name") == "route" or not span.get("parent"):
            t["root"] = span
        else:
            t["children"].setdefault(span["parent"], []).append(span)
    for t in traces.values():
        t["spans"].sort(key=lambda s: (s.get("start", 0.0), s["span"]))
        for kids in t["children"].values():
            kids.sort(key=lambda s: (s.get("start", 0.0), s["span"]))
    return traces


def segment_durations(trace: Dict) -> Dict[str, float]:
    """Per-segment seconds of one trace. Leaf spans contribute their
    duration under their name; container spans (``route``/``attempt``)
    contribute their EXCLUSIVE time — container minus direct children —
    as ``other`` (route) / ``transport`` (attempt: HTTP + replica
    handling outside the recorded server spans). Segments therefore sum
    to the root duration (when every component reported)."""
    children = trace["children"]
    segments: Dict[str, float] = {}

    def child_sum(span):
        return sum(
            c.get("dur_s", 0.0) for c in children.get(span["span"], ())
        )

    for span in trace["spans"]:
        name = span.get("name", "?")
        dur = float(span.get("dur_s", 0.0))
        if name in CONTAINER_SPANS:
            exclusive = max(dur - child_sum(span), 0.0)
            label = "transport" if name == "attempt" else "other"
            segments[label] = segments.get(label, 0.0) + exclusive
        else:
            segments[name] = segments.get(name, 0.0) + dur
    return segments


def dominant_segment(trace: Dict) -> Optional[str]:
    """The segment this trace spent the most time in (None when the
    trace recorded nothing but its root)."""
    segments = segment_durations(trace)
    segments.pop("other", None)
    if not segments:
        return None
    return max(sorted(segments), key=lambda k: segments[k])


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(int(q * len(vs)), len(vs) - 1)
    return vs[idx]


def anatomy(traces: Dict[str, Dict]) -> Dict:
    """Cross-trace rollup: per-segment count/p50/p99/total seconds, the
    same per (tenant, lane), and the slowest traces with their dominant
    segment flagged — the "request latency anatomy" table."""
    per_segment: Dict[str, List[float]] = {}
    per_group: Dict[str, Dict[str, float]] = {}
    rows = []
    for trace_id, trace in traces.items():
        segments = segment_durations(trace)
        for name, dur in segments.items():
            per_segment.setdefault(name, []).append(dur)
        root = trace["root"]
        attrs = (root or {}).get("attrs") or {}
        group = "{}/{}".format(
            attrs.get("tenant") or "-", attrs.get("lane") or "-"
        )
        g = per_group.setdefault(group, {})
        for name, dur in segments.items():
            g[name] = g.get(name, 0.0) + dur
        rows.append({
            "trace": trace_id,
            "dur_s": float((root or {}).get("dur_s", 0.0)),
            "status": attrs.get("status"),
            "tenant": attrs.get("tenant"),
            "lane": attrs.get("lane"),
            "slo_missed": bool(attrs.get("slo_missed")),
            "spans": len(trace["spans"]),
            "dominant": dominant_segment(trace),
        })
    rows.sort(key=lambda r: -r["dur_s"])
    return {
        "traces": len(traces),
        "segments": {
            name: {
                "count": len(durs),
                "p50_s": round(_percentile(durs, 0.50), 6),
                "p99_s": round(_percentile(durs, 0.99), 6),
                "total_s": round(sum(durs), 6),
            }
            for name, durs in sorted(per_segment.items())
        },
        "groups": {
            group: {k: round(v, 6) for k, v in sorted(g.items())}
            for group, g in sorted(per_group.items())
        },
        "slowest": rows[:20],
    }
