"""Fleet front-end: deadline-aware routing, budgeted retry, priority lanes
(port of the JAX package's ``serve/router.py``).

One :class:`FleetRouter` per client process turns "a pool of replica
processes behind a coordination directory" into the single-endpoint
surface of :class:`~hydragnn_tpu_torch.serve.server.InferenceServer`:
``route()`` a graph, get per-head numpy outputs back, or one of the same
exceptions the in-process server raises (``ServerOverloaded`` with a
retry-after hint, ``DeadlineExceeded``), whether the shed happened at a
replica's queue or at the router's admission gate.

Routing rules, in the order they bite:

- **Discovery is the lease scan**: live replicas hold a fresh
  ``replicas/replica-<k>.json`` lease in ``serving`` state (the files the
  supervisor heals from). Scans are cached for one heartbeat interval; the
  supervisor's ``fleet.json`` gives the target for the degradation check.
  The scan also gives each model's **consensus** active version (None
  while live replicas disagree: a hot-swap in flight).
- **Admission with priority lanes**: each request names a lane (default
  ``"default"``, priority 0). While the fleet is degraded, lanes with
  priority >= ``shed_priority_when_degraded`` are rejected at once with
  ``ServerOverloaded`` and a retry-after; with no live replica everything
  sheds. A tenant whose quota a replica refused is shed here until its
  retry-after passes, while other tenants route.
- **Deadline-aware retry with jittered backoff, budgeted**: an attempt
  that fails for a retryable reason (connection refused or reset: the
  replica died; 503: it shed or is draining) is retried on the next
  replica after ``utils/retry.backoff_delay``, while the deadline has room
  and the fleet-wide :class:`RetryBudget` grants a token (a fraction of a
  token per success, up to a small reserve: under a total outage retries
  die out instead of amplifying it). 400, 413 and 500 propagate at once.
- **SLO accounting**: a
  :class:`~hydragnn_tpu_torch.serve.metrics.ServeMetrics` counts every
  deadline-carrying request end to end (queueing, retries, transport),
  beside the ``hydragnn_fleet_*`` per-lane and per-tenant gauges of
  :class:`~hydragnn_tpu_torch.serve.fleet.FleetMetrics`;
  :meth:`FleetRouter.autoscale_signals` is the autoscaler's input.
- **Shadow tap** (:meth:`FleetRouter.set_shadow`): the canary controller
  mirrors successful responses; the tap can never fail or delay a live
  answer. A tracer (``obs/trace.py``) sends the ``X-Hydragnn-Trace`` header
  to the replicas and merges their spans.
"""

import glob
import http.client
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.obs.trace import TRACE_HEADER, new_id as _new_span_id
from hydragnn_tpu_torch.serve.cache import ResponseCache, canonical_graph_key
from hydragnn_tpu_torch.serve.fleet import (
    DEFAULT_HEARTBEAT_S,
    DEFAULT_LEASE_S,
    REPLICA,
    FleetMetrics,
    encode_graph,
    lease_serving,
)
from hydragnn_tpu_torch.serve.metrics import ServeMetrics
from hydragnn_tpu_torch.serve.server import DeadlineExceeded, ServerOverloaded
from hydragnn_tpu_torch.utils.retry import backoff_delay


def _span(tr, name: str, since_mono: float, span_id=None, **attrs):
    """Record one router-side span ending NOW (no-op with tracing off —
    the disabled path pays one ``is None`` check)."""
    if tr is None:
        return
    dur = time.monotonic() - since_mono
    tr.record(name, time.time() - dur, dur, span_id=span_id, **attrs)


class NoLiveReplica(ConnectionError):
    """Every routed attempt failed and no retry was possible."""


class RetryBudget:
    """Token bucket that caps fleet-wide retries to a fraction of the
    success rate (the classic retry-budget rule: a retry storm must not
    amplify an outage). Starts with ``reserve`` tokens so the FIRST
    failures of a healthy fleet can retry immediately; each success
    earns ``ratio`` tokens back, capped at the reserve."""

    def __init__(self, ratio: float = 0.1, reserve: float = 10.0):
        if ratio < 0 or reserve <= 0:
            raise ValueError("ratio must be >= 0 and reserve > 0")
        self.ratio = float(ratio)
        self.reserve = float(reserve)
        self._lock = threading.Lock()
        self._tokens = float(reserve)

    def on_success(self):
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.reserve)

    def try_acquire(self) -> bool:
        """Take one retry token; False = budget exhausted, fail the
        request rather than add load."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class FleetRouter:
    """Route requests to the live replicas of one coordination dir."""

    def __init__(
        self,
        coord_dir: str,
        target_replicas: Optional[int] = None,
        lanes: Optional[Dict[str, int]] = None,
        shed_priority_when_degraded: int = 1,
        lease_s: float = DEFAULT_LEASE_S,
        scan_interval_s: float = DEFAULT_HEARTBEAT_S,
        retry_budget: Optional[RetryBudget] = None,
        retry_base_delay_s: float = 0.02,
        max_attempts: int = 4,
        default_deadline_s: Optional[float] = None,
        connect_timeout_s: float = 5.0,
        cache=None,
        tracer=None,
    ):
        self.coord_dir = coord_dir
        self._target = target_replicas
        self.lanes = dict(lanes or {"default": 0, "batch": 1})
        self.shed_priority_when_degraded = int(shed_priority_when_degraded)
        self.lease_s = float(lease_s)
        self.scan_interval_s = float(scan_interval_s)
        self.budget = retry_budget or RetryBudget()
        self.retry_base_delay_s = float(retry_base_delay_s)
        self.max_attempts = max(int(max_attempts), 1)
        self.default_deadline_s = default_deadline_s
        self.connect_timeout_s = float(connect_timeout_s)
        self.metrics = ServeMetrics()  # the deadline/SLO series
        self.fleet_metrics = FleetMetrics()
        self._lock = threading.Lock()  # guards the scan cache + cursor
        self._scan_ts = 0.0
        self._cached: List[Tuple[int, int]] = []  # [(replica, port)]
        self._target_ts = float("-inf")  # fleet.json cache, same TTL
        self._target_cached: Optional[int] = None
        self._rr = 0  # round-robin cursor
        # shadow tap (serve/canary.py): called with every successful
        # response so a canary controller can mirror live traffic —
        # MUST be non-blocking and may never raise into the live path
        self._shadow = None
        # router-side response cache (serve/cache.py, optional): keyed
        # on the fleet's CONSENSUS active version per model name (read
        # off the same lease scan discovery uses) — mid-swap, when live
        # replicas disagree, lookups and fills are skipped entirely so a
        # cached answer is always the version the whole fleet serves
        self.cache = cache
        if cache is not None and cache.metrics is None:
            cache.metrics = self.metrics
        # request tracing (obs/trace.py): when armed, every route()
        # generates a trace id, propagates it to the replica attempts
        # as an X-Hydragnn-Trace header, buffers the spans per request
        # and tail-flushes at the terminal outcome. None = off (the
        # default): the hot path pays one None check
        self.tracer = tracer
        self._consensus: Dict[str, Optional[int]] = {}
        # tenant -> model name, learned from response bodies: lets a
        # tenant-routed request build its cache key without the router
        # holding a copy of the fleet's tenant spec
        self._tenant_models: Dict[str, str] = {}
        # tenant -> monotonic time until which that tenant is shed
        # locally (a replica answered its quota-503): the offender backs
        # off at the router while every other tenant routes normally
        self._tenant_backoff: Dict[str, float] = {}

    # ---- shadow routing ------------------------------------------------
    def set_shadow(self, tap) -> None:
        """Install ``tap(graph, body, latency_s)`` on the success path.
        The tap sees the routed graph and the full response body of
        every 200 AFTER the client's answer is already decided — a
        shadow comparison can never change, delay (the tap's contract is
        to enqueue-or-drop, never block) or fail a live response. Pass
        ``None`` to detach."""
        self._shadow = tap

    # ---- discovery -----------------------------------------------------
    def _scan(self, now: Optional[float] = None):
        """Fresh (replica, port) list from the lease files, plus the
        fleet's per-model consensus active version (None for any name
        the live replicas DISAGREE on — a hot-swap in flight)."""
        now = time.time() if now is None else now
        live = []
        versions: Dict[str, set] = {}
        pattern = os.path.join(
            self.coord_dir, f"{REPLICA}s", f"{REPLICA}-*.json"
        )
        for path in sorted(glob.glob(pattern)):
            m = re.search(rf"{REPLICA}-(\d+)\.json$", path)
            if not m:
                continue
            lease = coord.read_json(path)
            if not lease_serving(lease, self.lease_s, now):
                continue
            if not lease.get("port"):
                continue
            live.append((int(m.group(1)), int(lease["port"])))
            actives = lease.get("actives")
            if not actives:
                legacy = lease.get("active") or {}
                if legacy.get("name") is not None:
                    actives = {legacy["name"]: legacy.get("version")}
            for name, version in (actives or {}).items():
                versions.setdefault(name, set()).add(version)
        consensus = {
            name: (vs.pop() if len(vs) == 1 else None)
            for name, vs in versions.items()
        }
        return live, consensus

    def live_replicas(self) -> List[Tuple[int, int]]:
        """Live (replica, port) pairs, cached for one scan interval."""
        now = time.time()
        with self._lock:
            if now - self._scan_ts <= self.scan_interval_s:
                return list(self._cached)
        live, consensus = self._scan(now)
        with self._lock:
            self._cached = live
            self._consensus = consensus
            self._scan_ts = now
            return list(self._cached)

    def consensus_version(self, model: str) -> Optional[int]:
        """The version EVERY live replica reports active for ``model``
        (from the cached lease scan) — None while replicas disagree."""
        self.live_replicas()  # refresh the scan cache if stale
        with self._lock:
            return self._consensus.get(model)

    def _invalidate(self, replica: int):
        """Drop a replica we just watched fail from the cache — the next
        pick must not hand the same dead port out for a whole interval."""
        with self._lock:
            self._cached = [
                (rid, port) for rid, port in self._cached if rid != replica
            ]

    def target_replicas(self) -> Optional[int]:
        if self._target is not None:
            return self._target
        # cached like the lease scan: admission runs on every request
        # and must not pay a fleet.json read (a network round trip on a
        # shared coordination dir) per routed graph
        now = time.time()
        with self._lock:
            if now - self._target_ts <= self.scan_interval_s:
                return self._target_cached
        status = coord.read_json(
            os.path.join(self.coord_dir, "fleet.json")
        )
        target = None if status is None else int(status.get("target", 0))
        with self._lock:
            self._target_cached, self._target_ts = target, now
        return target

    def degraded(self) -> bool:
        target = self.target_replicas()
        if not target:
            return False
        return len(self.live_replicas()) < target

    # ---- admission -----------------------------------------------------
    def _admit(self, lane: str, tenant: Optional[str] = None):
        if lane not in self.lanes:
            raise ValueError(
                f"unknown lane {lane!r}; configured: {sorted(self.lanes)}"
            )
        if tenant is not None:
            # tenant-scoped backoff: a replica answered this tenant's
            # quota-503 recently, so ITS traffic sheds locally until the
            # window expires — other tenants in the SAME lane route
            # normally (the regression the lane-global retry-after had)
            now = time.monotonic()
            with self._lock:
                until = self._tenant_backoff.get(tenant, 0.0)
                if until <= now:
                    self._tenant_backoff.pop(tenant, None)
                    until = 0.0
            if until > now:
                self.metrics.on_shed()
                self.fleet_metrics.on_tenant_shed(tenant)
                raise ServerOverloaded(
                    retry_after_s=max(until - now, 0.001)
                )
        live = self.live_replicas()
        if not live:
            # nothing to route to: shed EVERYTHING with a hint scaled to
            # the heal cadence (supervisor respawn ~ boots + warms)
            self.metrics.on_shed()
            self.fleet_metrics.on_lane_shed(lane)
            raise ServerOverloaded(retry_after_s=max(self.lease_s, 0.1))
        if (
            self.degraded()
            and self.lanes[lane] >= self.shed_priority_when_degraded
        ):
            self.metrics.on_shed()
            self.fleet_metrics.on_lane_shed(lane)
            raise ServerOverloaded(
                retry_after_s=max(self.scan_interval_s * 4, 0.1)
            )
        return live

    def _pick(self, live: List[Tuple[int, int]],
              exclude: set) -> Optional[Tuple[int, int]]:
        candidates = [r for r in live if r[0] not in exclude] or live
        if not candidates:
            return None
        with self._lock:
            self._rr += 1
            return candidates[self._rr % len(candidates)]

    # ---- routing -------------------------------------------------------
    def route(
        self,
        graph,
        model: Optional[str] = None,
        lane: str = "default",
        deadline_s: Optional[float] = None,
        raw: bool = False,
        tenant: Optional[str] = None,
    ):
        """Route one graph; returns the per-head numpy outputs (or the
        full response dict with ``raw=True`` — version/batch_seq/replica
        included, the hot-swap tests' view). Raises
        :class:`ServerOverloaded` (shed — admission gate, tenant
        backoff, zero live replicas, or every live replica shedding),
        :class:`DeadlineExceeded`, or :class:`NoLiveReplica` (attempts
        exhausted on non-shed failures)."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        tracer = self.tracer
        tr = (
            tracer.start(lane=lane, tenant=tenant, model=model)
            if tracer is not None
            else None
        )
        if tr is None:
            return self._route(
                graph, model, lane, deadline_s, raw, tenant, None
            )
        t0 = time.monotonic()
        try:
            out = self._route(
                graph, model, lane, deadline_s, raw, tenant, tr
            )
        except DeadlineExceeded:
            # a deadline-carrying request's expiry IS an SLO miss: the
            # tail rules keep 100% of these traces at any non-zero rate
            tr.finish("deadline_exceeded",
                      slo_missed=deadline_s is not None, error=True)
            raise
        except ServerOverloaded as e:
            tr.finish("shed", error=True,
                      retry_after_s=round(e.retry_after_s, 6))
            raise
        except BaseException as e:
            tr.finish("error", error=True, error_type=type(e).__name__)
            raise
        elapsed = time.monotonic() - t0
        slo_missed = deadline_s is not None and elapsed > deadline_s
        tr.finish("ok", slo_missed=slo_missed)
        return out

    def _route(self, graph, model, lane, deadline_s, raw, tenant, tr):
        t0 = time.monotonic()
        deadline = None if deadline_s is None else t0 + deadline_s
        t_admit = time.monotonic()
        try:
            live = self._admit(lane, tenant)  # ServerOverloaded raises
        except ServerOverloaded as e:
            _span(tr, "admit", t_admit, lane=lane, shed="admission",
                  retry_after_s=round(e.retry_after_s, 6))
            raise
        _span(tr, "admit", t_admit, lane=lane)
        self.metrics.on_submit()
        self.fleet_metrics.registry.inc("requests_routed_total")
        cache_name = cache_key = None
        if self.cache is not None:
            t_cache = time.monotonic()
            # the cache key needs a model NAME: the explicit one, or the
            # tenant's (learned from this tenant's first response body)
            cache_name = model or (
                tenant and self._tenant_models.get(tenant)
            )
            version = (
                self.consensus_version(cache_name) if cache_name else None
            )
            if cache_name and version is not None:
                cache_key = ResponseCache.key(
                    canonical_graph_key(graph), cache_name, version,
                    tenant,
                )
                cached = self.cache.get(cache_key)
                if cached is not None:
                    _span(tr, "cache_lookup", t_cache, hit=True)
                    if tr is not None:
                        tr.attrs["cached"] = True
                    now = time.monotonic()
                    self.metrics.on_response()
                    self.metrics.on_response_latency(now - t0)
                    if deadline is not None:
                        self.metrics.on_deadline(now <= deadline)
                    if raw:
                        return {
                            "heads": [np.asarray(h).tolist()
                                      for h in cached],
                            "version": version,
                            "model": cache_name,
                            "tenant": tenant,
                            "cached": True,
                        }
                    return cached
            # miss (or skipped: no consensus/model name yet) — fall
            # through to dispatch with the lookup time on record
            _span(tr, "cache_lookup", t_cache, hit=False,
                  skipped=cache_key is None)
        tried: set = set()
        shed_hint: Optional[float] = None
        last_error: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            if attempt > 0:
                # retry gate: the deadline must have room for backoff +
                # an attempt BEFORE a budget token is taken — a request
                # that cannot retry anyway must not drain the budget
                # other requests need; then the budget (a storm must
                # die here)
                delay = backoff_delay(attempt - 1, self.retry_base_delay_s)
                if deadline is not None and (
                    time.monotonic() + delay >= deadline
                ):
                    break
                if not self.budget.try_acquire():
                    break
                t_back = time.monotonic()
                time.sleep(delay)
                _span(tr, "backoff", t_back, ordinal=attempt)
                self.metrics_on_retry(lane, tenant)
                live = self.live_replicas()
                if not live:
                    last_error = NoLiveReplica("no live replica to retry")
                    break
            pick = self._pick(live, tried)
            if pick is None:
                last_error = NoLiveReplica("no live replica")
                break
            rid, port = pick
            tried.add(rid)
            remaining = (
                None if deadline is None
                else max(deadline - time.monotonic(), 0.0)
            )
            if remaining is not None and remaining <= 0.0:
                self.metrics.on_timeout()
                raise DeadlineExceeded(
                    f"deadline expired after {time.monotonic() - t0:.3f}s "
                    f"({attempt} attempt(s))"
                )
            attempt_span = None if tr is None else _new_span_id()
            t_att = time.monotonic()
            try:
                status, body = self._post(
                    rid, port, graph, model, remaining, tenant,
                    trace_header=(
                        None if tr is None else tr.header(attempt_span)
                    ),
                )
            except (urllib.error.URLError, http.client.HTTPException,
                    ConnectionError, OSError, TimeoutError) as e:
                # transport failure: the replica just died or is being
                # respawned — retryable (HTTPException covers a kill
                # landing mid-response: IncompleteRead/BadStatusLine)
                _span(tr, "attempt", t_att, span_id=attempt_span,
                      replica=rid, ordinal=attempt,
                      error=type(e).__name__)
                self._invalidate(rid)
                self.fleet_metrics.registry.inc("replica_errors_total")
                last_error = e
                continue
            if tr is not None:
                # the replica's spans (queue_wait/batch_form/dispatch/
                # readback) ride every response body once the header
                # armed them — success AND failure bodies; retried
                # attempts join the SAME trace under their attempt span
                tr.merge(body.get("spans"))
                tr.attrs["attempts"] = attempt + 1
                _span(tr, "attempt", t_att, span_id=attempt_span,
                      replica=rid, ordinal=attempt, status=status)
            if status == 200:
                now = time.monotonic()
                self.budget.on_success()
                self.metrics.on_response()
                self.metrics.on_response_latency(now - t0)
                if deadline is not None:
                    self.metrics.on_deadline(now <= deadline)
                if tenant is not None and body.get("model"):
                    with self._lock:
                        self._tenant_models[tenant] = body["model"]
                if self.cache is not None and body.get("model"):
                    # fill ONLY when the answering version IS the fleet
                    # consensus: mid-swap answers (consensus None, or a
                    # straggler replica) are never cached
                    consensus = self.consensus_version(body["model"])
                    if (
                        consensus is not None
                        and body.get("version") == consensus
                    ):
                        # store exactly what the uncached path returns
                        # (the JSON-decoded arrays): a hit is bitwise-
                        # equal to a fresh route of the same graph
                        self.cache.put(
                            ResponseCache.key(
                                canonical_graph_key(graph),
                                body["model"], consensus, tenant,
                            ),
                            [np.asarray(h) for h in body["heads"]],
                        )
                shadow = self._shadow
                if shadow is not None:
                    try:
                        shadow(graph, body, now - t0)
                    except Exception:
                        # the shadow path can NEVER fail a live
                        # response — a broken tap is the canary's
                        # problem, not the client's
                        pass
                if raw:
                    return body
                return [np.asarray(h) for h in body["heads"]]
            if status == 503:
                # the replica shed (queue full / draining): retryable,
                # and its hint rides along if we end up giving up
                shed_hint = float(body.get("retry_after_s", 0.05))
                shed_tenant = body.get("tenant")
                if shed_tenant is not None and shed_tenant == tenant:
                    # the 503 was a TENANT quota shed, not replica
                    # pressure: back off THIS tenant locally (admission
                    # sheds it until the window passes) and stop
                    # retrying — another replica enforces the same
                    # quota, so a retry only doubles the offender's load
                    with self._lock:
                        self._tenant_backoff[tenant] = max(
                            self._tenant_backoff.get(tenant, 0.0),
                            time.monotonic() + max(shed_hint, 0.001),
                        )
                    self.fleet_metrics.on_tenant_shed(tenant)
                    self.metrics.on_error()
                    if tr is not None:
                        tr.attrs["shed"] = "tenant_quota"
                    raise ServerOverloaded(retry_after_s=shed_hint)
                self.fleet_metrics.registry.inc("replica_errors_total")
                last_error = ServerOverloaded(retry_after_s=shed_hint)
                continue
            if status == 504:
                if deadline is not None:
                    self.metrics.on_timeout()
                else:
                    # the replica's own wait cap expired on a request
                    # that carried no deadline: a serving failure, not
                    # an SLO outcome (the deadline series must only see
                    # deadline-carrying requests)
                    self.metrics.on_error()
                raise DeadlineExceeded(
                    body.get("error", "replica-side deadline expiry")
                )
            # 400/413/500: the request is bad or genuinely failed —
            # retrying cannot help, propagate as a loud failure
            self.metrics.on_error()
            raise RuntimeError(
                f"replica {rid} answered {status}: "
                f"{body.get('error', 'unknown error')}"
            )
        if deadline is not None and time.monotonic() >= deadline:
            self.metrics.on_timeout()
            raise DeadlineExceeded(
                f"deadline expired after {time.monotonic() - t0:.3f}s "
                f"({len(tried)} replica(s) tried)"
            )
        if shed_hint is not None:
            # every reachable replica shed: the caller sees retry-after
            # exactly like the in-process queue-full path. This request
            # was already counted in requests_total at admission, so its
            # terminal outcome lands in errors_total — ServeMetrics'
            # shed_total is reserved for never-accepted rejections (the
            # admission gate above); the per-lane fleet gauge still
            # classifies it as a shed
            self.metrics.on_error()
            self.fleet_metrics.on_lane_shed(lane)
            if tr is not None:
                tr.attrs["shed"] = "all_replicas_shed"
            raise ServerOverloaded(retry_after_s=shed_hint)
        self.metrics.on_error()
        raise NoLiveReplica(
            f"all {len(tried)} attempted replica(s) failed"
            + (f": {last_error}" if last_error else "")
        )

    def metrics_on_retry(self, lane: str, tenant: Optional[str] = None):
        self.fleet_metrics.registry.inc("retries_total")
        self.fleet_metrics.on_lane_retry(lane)
        if tenant is not None:
            self.fleet_metrics.on_tenant_retry(tenant)

    def autoscale_signals(self) -> Dict:
        """Counter snapshot for :class:`FleetAutoscaler`: ``ServeMetrics``
        plus per-tenant quota sheds folded into ``shed_total``. A
        replica's quota-503 lands in ``errors_total`` by the admission
        accounting convention (the request was accepted and routed), but
        for capacity decisions a quota shed IS shed pressure — more
        replicas means more aggregate quota. Locally backed-off tenants
        appear in both series; the autoscaler only thresholds
        ``shed > 0``, so the overlap is harmless."""
        snap = dict(self.metrics.snapshot())
        labeled = self.fleet_metrics.snapshot().get("tenant_shed_total")
        if labeled:
            snap["shed_total"] = (
                snap.get("shed_total", 0) + sum(labeled.values())
            )
        return snap

    def _post(self, rid: int, port: int, graph, model: Optional[str],
              deadline_s: Optional[float],
              tenant: Optional[str] = None,
              trace_header: Optional[str] = None) -> Tuple[int, Dict]:
        payload = {"graph": encode_graph(graph)}
        if model is not None:
            payload["model"] = model
        if deadline_s is not None:
            payload["deadline_s"] = deadline_s
        if tenant is not None:
            payload["tenant"] = tenant
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if trace_header is not None:
            headers[TRACE_HEADER] = trace_header
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=data,
            headers=headers,
            method="POST",
        )
        # urllib's timeout bounds the WHOLE request, not just the
        # connect: a deadline-less request must be allowed a slow
        # predict (the replica's own wait cap answers 504 within 60s),
        # not be misread as replica death at connect_timeout_s
        timeout = (
            max(self.connect_timeout_s, 120.0)
            if deadline_s is None
            else max(min(deadline_s + 1.0, 120.0), 0.05)
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except ValueError:
                body = {}
            return e.code, body
