"""Self-healing serving fleet: replica supervision and zero-downtime
hot-swap (port of the JAX package's ``serve/fleet.py``).

One :class:`~hydragnn_tpu_torch.serve.server.InferenceServer` is one
process: a wedged batcher or a bad promote takes the endpoint down. This
module runs **N replica processes behind one router** (``serve/router.py``),
coordinated through the lease and tombstone files of
:mod:`hydragnn_tpu_torch.coord`. Each replica serves on the card with its
own CUDA context and its own captured forwards; replicas on one card share
it by time-slicing.

Three roles:

- :class:`ReplicaServer` runs inside each replica process: one
  ``InferenceServer`` behind a stdlib HTTP ``POST /predict`` (and
  ``/healthz``, ``/metrics``), a heartbeat **lease**
  (``<dir>/replicas/replica-<k>.json``: state, port, active version,
  requests served) and a **promote watcher** thread that runs hot-swap
  commands (load the candidate, warm it per bucket through the live
  batcher with the compile counter checked, ack) and follows the published
  active version. Capture stays on the batcher thread: the HTTP handlers,
  the heartbeat and the drift detector touch no device.
- :class:`ServingFleet` is the supervisor: it spawns and respawns the
  replica processes (``subprocess.Popen``: fork and exec, never a fork of a
  process that holds a CUDA context), declares a replica lost on process
  exit or a stale lease (a wedged one is killed and respawned at the next
  incarnation; repeated boot failures back off exponentially), prices every
  transition as events (``replica_lost``, ``replica_respawned``,
  ``fleet_degraded``) and ``hydragnn_fleet_*`` gauges, and runs the
  **zero-downtime hot-swap**: a promote command, every live replica's warmed
  ack, then the atomic publish of the new active version. A CRC-bad,
  warm-up-failing or timed-out candidate rolls back loudly
  (``model_rollback``) with the old version serving every request.
- the CLI: ``python -m hydragnn_tpu_torch.serve.fleet --spec spec.json
  --dir <coord> --replicas N`` runs the supervisor; with
  ``HYDRAGNN_FLEET_REPLICA`` set (the supervisor sets it) the same entry
  point runs one replica.

Hot-swap lifecycle (all files under ``<dir>/promote/``, the JAX package's
layout: either package reads the other's)::

    supervisor                      each live replica
    ----------                      -----------------
    cmd-<c>.json  ---------------->  strict v2 load (CRC) of candidate
                                     warm_version through the batcher
                                       pass 1: exactly num_buckets compiles
                                       pass 2: zero
    all acks warmed?  <------------  ack-<c>-r<k>.json
      yes: active.json (atomic) -->  registry.promote at the next
           model_promoted            micro-batch boundary (in-flight
      no:  result-<c>.json           batches keep their packed entry:
           model_rollback            no mixed-version micro-batch)

The supervisor sets ``HYDRAGNN_FLEET_DIR``, ``HYDRAGNN_FLEET_REPLICA``,
``HYDRAGNN_FLEET_GEN`` (incarnation) and ``HYDRAGNN_FLEET_HEARTBEAT_S`` for
each replica. A spec's ``"device"`` picks the replicas' device: absent,
the card (a replica without one raises); ``"cpu"``, the plain versions.

Degradation ladder (with the router): full fleet, every lane admitted;
degraded (live < target), lanes at or below the shed priority rejected
with a retry-after; no live replica, everything shed with a retry-after
until the supervisor heals the fleet. A request is never silently dropped.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.obs.events import RunEventLog
from hydragnn_tpu_torch.obs.metrics import MetricsRegistry
from hydragnn_tpu_torch.obs.trace import TRACE_HEADER, TraceContext
from hydragnn_tpu_torch.ops import launch_counts
from hydragnn_tpu_torch.serve.buckets import GraphTooLarge
from hydragnn_tpu_torch.serve.server import DeadlineExceeded, ServerOverloaded
from hydragnn_tpu_torch.serve.tenants import DEFAULT_QUOTA
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.envparse import env_int

REPLICA = "replica"  # coord kind AND member prefix for fleet leases
# canary replicas lease under a DIFFERENT kind (<dir>/canarys/): the
# router's discovery scan globs replicas/ only, so a canary is invisible
# to routing and capacity math by construction — no filtering logic to
# get wrong (serve/canary.py is the sole consumer of these leases)
CANARY = "canary"

# serving leases turn over much faster than training ones: a replica
# outage is user-visible latency, not a lost epoch
DEFAULT_HEARTBEAT_S = 0.25
DEFAULT_LEASE_S = 2.0


def highest_cmd(promote_dir: str) -> int:
    """Highest promote command id already on disk (written sequentially
    from 1) — the one walk both the supervisor's counter reseed and the
    replica's boot-time history fast-forward use."""
    highest = 0
    while os.path.exists(
        os.path.join(promote_dir, f"cmd-{highest + 1:06d}.json")
    ):
        highest += 1
    return highest


def lease_serving(lease: Optional[Dict], lease_s: float,
                  now: Optional[float] = None) -> bool:
    """THE definition of "this lease represents a live, serving
    replica" — shared by the supervisor's monitor tick, the promote
    quorum, and the router's discovery scan, so all three planes agree
    on liveness."""
    if lease is None or "ts" not in lease:
        return False
    now = time.time() if now is None else now
    return bool(
        lease.get("state") == "serving"
        and not lease.get("done")
        and now - float(lease["ts"]) <= float(lease_s)
    )


# ---- wire format -----------------------------------------------------------


def encode_graph(graph) -> Dict:
    """GraphData -> JSON-able dict (inference inputs only)."""
    payload = {
        "x": np.asarray(graph.x).tolist(),
        "edge_index": np.asarray(graph.edge_index).tolist(),
    }
    if graph.pos is not None:
        payload["pos"] = np.asarray(graph.pos).tolist()
    if graph.edge_attr is not None:
        payload["edge_attr"] = np.asarray(graph.edge_attr).tolist()
    return payload


def decode_graph(payload: Dict) -> GraphData:
    """The JSON dict of :func:`encode_graph` -> the port's ``GraphData``."""
    g = GraphData(
        x=np.asarray(payload["x"], np.float32),
        pos=(
            np.asarray(payload["pos"], np.float32)
            if payload.get("pos") is not None
            else None
        ),
    )
    g.edge_index = np.asarray(payload["edge_index"], np.int64)
    if payload.get("edge_attr") is not None:
        g.edge_attr = np.asarray(payload["edge_attr"], np.float32)
    return g


# ---- fleet metrics ---------------------------------------------------------


class FleetMetrics:
    """The ``hydragnn_fleet_*`` series. One instance per PROCESS role:
    the supervisor records replica lifecycle, a router its routing /
    shedding side — both expose through the shared
    :class:`~hydragnn_tpu_torch.obs.metrics.MetricsRegistry` machinery."""

    def __init__(self):
        r = MetricsRegistry("hydragnn_fleet")
        r.gauge("target_replicas", "Replica processes the fleet maintains")
        r.gauge("live_replicas", "Replicas currently holding a fresh lease")
        r.gauge(
            "availability",
            "live/target fraction (1.0 = full fleet serving)",
        )
        r.gauge("degraded", "1 while live < target (the shed trigger)")
        r.counter(
            "replica_losses_total",
            "Replica deaths detected (process exit or stale lease)",
        )
        r.counter("replica_respawns_total", "Replicas healed by respawn")
        r.gauge(
            "last_recovery_seconds",
            "Detection-to-serving downtime of the last respawn",
        )
        r.counter("promotes_total", "Hot-swap promotes published")
        r.counter(
            "rollbacks_total",
            "Hot-swap candidates rejected with the old version serving",
        )
        # router-side lanes (serve/router.py records these): cumulative
        # totals as labeled gauges, one series per admission lane
        r.counter("requests_routed_total", "Requests the router accepted")
        r.counter(
            "retries_total", "Routed attempts beyond each request's first"
        )
        r.counter(
            "replica_errors_total",
            "Replica attempts that failed (connection/5xx)",
        )
        r.labeled_gauge(
            "lane_shed_total", "Cumulative shed requests per admission lane"
        )
        r.labeled_gauge(
            "lane_retries_total", "Cumulative retries per admission lane"
        )
        # per-TENANT shed/retry series (multi-tenant serving): a quota
        # shed is the offending tenant's problem, not its lane's — the
        # lane-global gauges alone would blame every tenant in the lane
        r.labeled_gauge(
            "tenant_shed_total", "Cumulative quota-shed requests per tenant"
        )
        r.labeled_gauge(
            "tenant_retries_total", "Cumulative retried requests per tenant"
        )
        self.registry = r
        self._lane_lock = threading.Lock()
        self._lane_shed: Dict[str, int] = {}
        self._lane_retries: Dict[str, int] = {}
        self._tenant_shed: Dict[str, int] = {}
        self._tenant_retries: Dict[str, int] = {}

    def on_lane_shed(self, lane: str):
        with self._lane_lock:
            self._lane_shed[lane] = self._lane_shed.get(lane, 0) + 1
            total = self._lane_shed[lane]
        self.registry.set_labeled("lane_shed_total", total, lane=lane)

    def on_lane_retry(self, lane: str):
        with self._lane_lock:
            self._lane_retries[lane] = self._lane_retries.get(lane, 0) + 1
            total = self._lane_retries[lane]
        self.registry.set_labeled("lane_retries_total", total, lane=lane)

    def on_tenant_shed(self, tenant: str):
        with self._lane_lock:
            self._tenant_shed[tenant] = self._tenant_shed.get(tenant, 0) + 1
            total = self._tenant_shed[tenant]
        self.registry.set_labeled("tenant_shed_total", total, tenant=tenant)

    def on_tenant_retry(self, tenant: str):
        with self._lane_lock:
            self._tenant_retries[tenant] = (
                self._tenant_retries.get(tenant, 0) + 1
            )
            total = self._tenant_retries[tenant]
        self.registry.set_labeled(
            "tenant_retries_total", total, tenant=tenant
        )

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()

    def snapshot(self) -> Dict:
        return self.registry.snapshot()


# ---- replica-side ----------------------------------------------------------


class _ReplicaListener(ThreadingHTTPServer):
    allow_reuse_address = True
    daemon_threads = True  # a hung in-flight request must not block exit


class ReplicaServer:
    """One serving replica: ``InferenceServer`` + HTTP + lease + promote
    watcher. Usable in-process (tests drive real routing against it) or
    as the body of a supervised replica process (:func:`replica_main`).
    """

    def __init__(
        self,
        server,
        coord_dir: str,
        replica_id: int,
        port: int = 0,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
        incarnation: int = 0,
        model_name: Optional[str] = None,
        arch_config: Optional[dict] = None,
        poll_s: float = 0.1,
        role: str = REPLICA,
    ):
        if role not in (REPLICA, CANARY):
            raise ValueError(f"unknown replica role {role!r}")
        self.server = server
        self.coord_dir = coord_dir
        self.replica_id = int(replica_id)
        self.role = role
        self.is_canary = role == CANARY
        self.incarnation = int(incarnation)
        self.model_name = model_name or (
            server.default_model or server.registry.names()[0]
        )
        self.arch_config = arch_config
        self.heartbeat_s = float(heartbeat_s)
        self.poll_s = float(poll_s)
        self._port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self.heartbeat: Optional[coord.Heartbeat] = None
        self._state = "starting"
        self._done = False
        self._lock = threading.Lock()  # guards counters + promote state
        self._served = 0
        # promote bookkeeping: cmd_id -> (name, warmed version); with
        # tenants a replica serves MANY names, each with its own promote
        # stream, so activation sequence and boot-time base version are
        # tracked per name. _warm_versions is the set of (name, version)
        # pairs ACTUALLY compiled per bucket — a switch onto anything
        # outside it must warm first or the batcher pays the compile
        # inline under traffic
        self._warmed: Dict[int, tuple] = {}
        self._warm_versions: set = set()
        self._base_versions: Dict[str, int] = {}
        self._last_cmd_handled = 0
        self._active_seqs: Dict[str, int] = {}
        # model-quality observatory hooks, wired by replica_main (or a
        # test harness) after construction — same pattern as
        # server.costs: None = feature off, zero request-path cost
        self.drift = None  # obs/drift.py DriftDetector
        self.sink = None   # serve/quality.py FeedbackSink

    def serving_names(self) -> List[str]:
        """Every model name this replica serves (the default plus all
        tenant-packed models) — the set a promote command may target."""
        return self.server.registry.names()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaServer":
        # the version each name BOOTED with is the cmd-0 "base" a fleet
        # rollback() reverts to — capture BEFORE catching up, which
        # registers (and activates) any published candidate as a NEWER
        # version; recording the candidate as base would make a later
        # rollback split serving versions across the fleet
        bases = {
            name: self.server.registry.get(name).version
            for name in self.serving_names()
        }
        with self._lock:
            self._base_versions = bases
        # catch up on an already-published active version BEFORE taking
        # traffic: a replica respawned mid/after a promote must come up
        # serving what the fleet serves, not the stale base checkpoint.
        # A CANARY never catches up: it exists to serve exactly the
        # candidate it booted with, not whatever the fleet promoted
        if not self.is_canary:
            self._catch_up_promotes()
        self.server.start()  # warms every registered model per bucket
        # PIN every currently-active version: without an explicit
        # promote the registry serves the LATEST registered version, so
        # merely registering a candidate mid-hot-swap would flip traffic
        # onto unwarmed weights before the supervisor publishes.
        # Promoting the current version makes activation explicit.
        for name in self.serving_names():
            self.server.registry.promote(
                name, self.server.registry.active_version(name)
            )
        # server.start() warmed the ACTIVE version of every name
        warm_now = {
            (name, self.server.registry.active_version(name))
            for name in self.serving_names()
        }
        with self._lock:
            self._warmed.setdefault(
                0, (self.model_name, bases[self.model_name])
            )
            self._warm_versions.update(warm_now)
        httpd = _ReplicaListener(("127.0.0.1", self._port), self._handler())
        thread = threading.Thread(
            target=httpd.serve_forever,
            name=f"hydragnn-replica-{self.replica_id}",
            daemon=True,
        )
        thread.start()
        with self._lock:
            self._httpd, self._http_thread = httpd, thread
            self._state = "serving"
        self.heartbeat = coord.Heartbeat(
            coord.hb_path(
                self.coord_dir, self.role, self.replica_id,
                prefix=self.role,
            ),
            self._lease_payload,
            self.heartbeat_s,
        ).start()
        if not self.is_canary:
            # a canary runs NO promote watcher: following active.json
            # would flip it off its candidate, and acking the fleet's
            # promote commands would corrupt the all-replica quorum
            watch = threading.Thread(
                target=self._watch_promotes,
                name=f"hydragnn-promote-watch-{self.replica_id}",
                daemon=True,
            )
            watch.start()
            with self._lock:
                self._watch_thread = watch
        return self

    @property
    def address(self):
        with self._lock:
            if self._httpd is None:
                return None
            return self._httpd.server_address[:2]

    def _lease_payload(self) -> Dict:
        with self._lock:
            state = self._state
            served = self._served
            done = self._done
            port = (
                self._httpd.server_address[1]
                if self._httpd is not None
                else 0
            )
        try:
            active = self.server.registry.get(self.model_name)
            active_info = {"name": active.name, "version": active.version,
                           "source": active.source}
        except KeyError:
            active_info = None
        # per-name active versions: the legacy "active" field covers the
        # default serving name only; named (per-tenant) promotes verify
        # propagation against this map
        actives = {}
        for name in self.serving_names():
            try:
                actives[name] = self.server.registry.active_version(name)
            except KeyError:
                pass
        metrics = self.server.metrics
        return {
            "replica": self.replica_id,
            "role": self.role,
            "gen": self.incarnation,
            "state": state,
            "port": port,
            "served": served,
            "active": active_info,
            "actives": actives,
            "done": done,
            # this process's device work: each dispatched micro-batch
            # replays one forward and each capture ran one eager warm-up,
            # so on the card the kernels' launches are (batches +
            # compiles) times one forward's; the final (done) lease is
            # read after the batcher stopped
            "batches": metrics.batches_total,
            "compiles": metrics.compiles_total,
            "launches": launch_counts(),
        }

    def shutdown(self, drain: bool = True, timeout: float = 10.0):
        """Fleet-orchestrated (or operator) teardown: stop accepting,
        drain the batcher so every queued/in-flight future resolves with
        a terminal outcome, answer stragglers with 503 + retry-after,
        then release the lease marked done (a drained replica is
        finished, not lost)."""
        with self._lock:
            if self._state == "stopped":
                return
            self._state = "draining"
        self._watch_stop.set()
        with self._lock:
            watch = self._watch_thread
            self._watch_thread = None
        if watch is not None and watch.is_alive():
            watch.join(timeout=max(self.poll_s * 4, 2.0))
        # InferenceServer.stop resolves EVERY accepted future (result or
        # "server stopped") — the stop-under-load contract; handler
        # threads waiting on those futures answer their clients from it
        self.server.stop(drain=drain, timeout=timeout)
        # flush partial quality state so no accepted feedback graph or
        # drift sample is lost across a drain (both calls are idempotent)
        if self.sink is not None:
            try:
                self.sink.close()
            except Exception:
                pass
        if self.drift is not None:
            try:
                self.drift.evaluate_window()  # close the partial window
            except Exception:
                pass
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._http_thread = self._http_thread, None
            self._state = "stopped"
            self._done = True
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        if self.heartbeat is not None:
            self.heartbeat.stop()  # final write carries done=True

    def serve_forever(self):
        """CLI body: serve until SIGTERM/SIGINT, then drain and exit."""
        stop = threading.Event()

        def _sig(_signum, _frame):
            stop.set()

        signal.signal(signal.SIGTERM, _sig)
        signal.signal(signal.SIGINT, _sig)
        self.start()
        while not stop.wait(0.2):
            pass
        self.shutdown()

    # -- request path --------------------------------------------------------
    def _handler(self):
        replica = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path == "/healthz":
                    body = json.dumps(replica.health()).encode()
                    self._reply(200, body, "application/json")
                elif self.path == "/metrics":
                    # the server's text (its series, then the cost ledger's
                    # and the scorer's families), then the drift scores
                    text = replica.server.render_prometheus()
                    if replica.drift is not None:
                        text += replica.drift.render_prometheus()
                    self._reply(200, text.encode(), "text/plain")
                else:
                    self._reply(404, b"not found\n", "text/plain")

            def do_POST(self):  # noqa: N802
                if self.path != "/predict":
                    self._reply(404, b"not found\n", "text/plain")
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    payload = json.loads(self.rfile.read(length))
                except (ValueError, OSError):
                    self._json(400, {"error": "unparseable request body"})
                    return
                code, body, headers = replica.handle_predict(
                    payload, trace_header=self.headers.get(TRACE_HEADER)
                )
                self._json(code, body, headers)

            def _json(self, code, obj, headers=None):
                self._reply(
                    code, json.dumps(obj).encode(), "application/json",
                    headers,
                )

            def _reply(self, code, body, ctype, headers=None):
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client gave up (deadline): nothing to answer

            def log_message(self, *args):  # request spam off stderr
                pass

        return Handler

    def handle_predict(self, payload: Dict,
                       trace_header: Optional[str] = None):
        """One request end to end; returns ``(status, body, headers)``.
        Factored out of the HTTP handler so tests can drive the exact
        request path (fault hooks included) without a socket.

        A well-formed ``X-Hydragnn-Trace`` header arms span capture for
        THIS request: replica-side spans (queue-wait, batch-form,
        dispatch, readback) ride back to the router in the response
        body's ``spans`` field, and EVERY body — success or error —
        echoes the request's ``trace`` id, so a failed attempt is still
        attributable to its end-to-end trace."""
        ctx = TraceContext.from_header(trace_header)

        def _out(code, body, headers):
            # the router (the trace's single event-stream writer) merges
            # these spans under the attempt span it sent in the header
            if ctx is not None:
                body = dict(body)
                body["trace"] = ctx.trace_id
                body["spans"] = ctx.export()
            return code, body, headers

        # fault hooks fire on ACCEPTED requests, before any work — the
        # SIGKILL-mid-request and slow-replica injections
        faults.kill_replica_at_request()
        with self._lock:
            ordinal = self._served
            self._served += 1
        faults.slow_replica(ordinal)
        if self.is_canary:
            # bad-candidate injections fire ONLY on the canary role —
            # a fleet-wide env can regress the candidate under test but
            # never a live replica's answers or latency
            faults.slow_candidate(ordinal)
        try:
            graph = decode_graph(payload["graph"])
        except (KeyError, ValueError, TypeError):
            return _out(400, {"error": "malformed graph payload"}, {})
        # input-distribution-shift injection (drift-detector testing):
        # scales THIS replica's decoded copy only
        graph = faults.shift_inputs(graph, ordinal)
        deadline_s = payload.get("deadline_s")
        tenant = payload.get("tenant")
        try:
            fut = self.server.submit(
                graph,
                model=payload.get("model"),
                deadline_s=deadline_s,
                tenant=tenant,
                trace=ctx,
            )
        except ServerOverloaded as e:
            # a TenantOverQuota carries the offender's name: the router
            # scopes its backoff to THAT tenant instead of the whole lane
            return _out(
                503,
                {"error": "overloaded",
                 "retry_after_s": e.retry_after_s,
                 "tenant": getattr(e, "tenant", None)},
                {"Retry-After": f"{e.retry_after_s:.3f}"},
            )
        except GraphTooLarge as e:
            return _out(413, {"error": str(e)}, {})
        except (KeyError, ValueError) as e:
            # unknown model name / bad request fields: the request is
            # wrong, not the replica — 400 so the router does NOT retry
            return _out(400, {"error": str(e)}, {})
        except RuntimeError as e:  # server stopped (draining replica)
            retry = max(self.server.max_wait_s, 0.05)
            return _out(
                503,
                {"error": str(e), "retry_after_s": retry},
                {"Retry-After": f"{retry:.3f}"},
            )
        try:
            heads = fut.result(
                deadline_s if deadline_s is not None else 60.0
            )
        except DeadlineExceeded as e:
            return _out(504, {"error": str(e)}, {})
        except TimeoutError:
            return _out(504, {"error": "prediction timed out"}, {})
        except RuntimeError as e:
            # stop-under-load: an accepted future failed at shutdown —
            # terminal, explicit, retryable elsewhere
            retry = max(self.server.max_wait_s, 0.05)
            return _out(
                503,
                {"error": str(e), "retry_after_s": retry},
                {"Retry-After": f"{retry:.3f}"},
            )
        except Exception as e:  # dispatch error: failed, not dropped
            return _out(500, {"error": str(e)}, {})
        if self.is_canary and faults.nan_candidate(ordinal + 1):
            heads = [
                np.full(np.shape(np.asarray(h)), np.nan, np.float32)
                for h in heads
            ]
        # model-quality observatory: fold this request into the drift
        # sketches and offer interesting graphs to the feedback sink.
        # Both hooks are advisory — a broken detector must never turn a
        # successful prediction into an error response.
        unc = getattr(fut, "uncertainty", None)
        drifted = False
        if self.drift is not None:
            try:
                drifted = self.drift.observe(
                    tenant, graph=graph, heads=heads, uncertainty=unc
                )
            except Exception:
                drifted = False
        if self.sink is not None:
            self.sink.offer(graph, uncertainty=unc, drifted=drifted)
        body = {
            "heads": [np.asarray(h).tolist() for h in heads],
            "version": fut.version,
            # which packed model answered: the cross-tenant isolation
            # proof reads this (a tenant's responses must ALL carry
            # its own model), and the router's cache keys put() on it
            "model": fut.model_name,
            "tenant": tenant,
            "batch_seq": fut.batch_seq,
            "replica": self.replica_id,
        }
        if unc is not None:
            body["uncertainty"] = [float(v) for v in unc]
        return _out(200, body, {})

    def health(self) -> Dict:
        h = self.server.health()
        with self._lock:
            h.update(
                replica=self.replica_id,
                incarnation=self.incarnation,
                state=self._state,
                served=self._served,
            )
        return h

    # -- hot-swap ------------------------------------------------------------
    def _promote_dir(self) -> str:
        return os.path.join(self.coord_dir, "promote")

    def _cmd_path(self, cmd_id: int) -> str:
        return os.path.join(self._promote_dir(), f"cmd-{int(cmd_id):06d}.json")

    def _ack_path(self, cmd_id: int) -> str:
        return os.path.join(
            self._promote_dir(),
            f"ack-{int(cmd_id):06d}-r{self.replica_id}.json",
        )

    def _watch_promotes(self):
        warned = False
        wait = self.poll_s
        while not self._watch_stop.wait(wait):
            try:
                self.poll_promotes()
                wait = self.poll_s
            except Exception as e:
                # a torn command file must not kill the watcher — but a
                # replica PERSISTENTLY unable to follow the active
                # version (unreadable candidate) must be diagnosable,
                # and must not re-attempt the full checkpoint load every
                # tick
                if not warned:
                    warned = True
                    import warnings

                    warnings.warn(
                        f"replica {self.replica_id} promote watcher: "
                        f"{type(e).__name__}: {e} (will keep retrying "
                        "at reduced cadence)"
                    )
                wait = self.poll_s * 10

    def poll_promotes(self):
        """One watcher tick (public so in-process tests can step it
        deterministically): handle any new promote command, then follow
        the published active version."""
        pdir = self._promote_dir()
        if not os.path.isdir(pdir):
            return
        with self._lock:
            last = self._last_cmd_handled
        next_cmd = last + 1
        while True:
            cmd = coord.read_json(self._cmd_path(next_cmd))
            if cmd is None:
                break
            self._handle_promote_cmd(cmd)
            with self._lock:
                self._last_cmd_handled = next_cmd
            next_cmd += 1
        for active in self._published_actives():
            self._apply_active(active)

    def _published_actives(self) -> List[Dict]:
        """Every published active-version file: the legacy fleet-wide
        ``active.json`` plus one ``active-byname/<name>.json`` per model
        name a NAMED (per-tenant) promote has targeted. Applying both for
        the same name is safe — the per-name seq makes it idempotent."""
        pdir = self._promote_dir()
        out = []
        legacy = coord.read_json(os.path.join(pdir, "active.json"))
        if legacy is not None:
            out.append(legacy)
        bydir = os.path.join(pdir, "active-byname")
        if os.path.isdir(bydir):
            for fn in sorted(os.listdir(bydir)):
                if not fn.endswith(".json"):
                    continue
                active = coord.read_json(os.path.join(bydir, fn))
                if active is not None:
                    out.append(active)
        return out

    def _handle_promote_cmd(self, cmd: Dict):
        """Load + warm one candidate; ack warmed/failed. The old version
        serves throughout: the load happens off the batcher thread, the
        warmup routes THROUGH the batcher (interleaving with traffic),
        and nothing switches until the supervisor publishes."""
        cmd_id = int(cmd["cmd_id"])
        try:
            entry = self._load_candidate(cmd)
            warm = self.server.warm_version(entry.name, entry.version)
            if not warm["verified"]:
                raise RuntimeError(
                    "candidate warmup not compile-verified: pass 1 "
                    f"compiled {warm['first_pass_compiles']}/"
                    f"{warm['buckets']} buckets, later passes "
                    f"{warm['later_pass_compiles']} (want 0)"
                )
            with self._lock:
                self._warmed[cmd_id] = (entry.name, entry.version)
                self._warm_versions.add((entry.name, entry.version))
            coord.write_json(
                self._ack_path(cmd_id),
                {"cmd_id": cmd_id, "replica": self.replica_id,
                 "status": "warmed", "version": entry.version,
                 "name": entry.name,
                 "compiles": warm["first_pass_compiles"],
                 "later_pass_compiles": warm["later_pass_compiles"]},
            )
        except Exception as e:
            coord.write_json(
                self._ack_path(cmd_id),
                {"cmd_id": cmd_id, "replica": self.replica_id,
                 "status": "failed", "error": f"{type(e).__name__}: {e}"},
            )

    def _load_candidate(self, cmd: Dict):
        """Strict v2 load of the candidate into the registry (as the
        next INACTIVE version of the serving name). The corrupt-candidate
        fault injection reroutes the read through a byte-flipped copy so
        the real CRC path rejects it."""
        checkpoint = cmd["checkpoint"]
        target = cmd.get("name") or self.model_name
        if target not in self.serving_names():
            # the replica hot-swaps names it SERVES (the default plus
            # every tenant-packed model); a promote labeled with any
            # other name would mislabel the event stream and never be
            # routable — refuse loudly (acked "failed")
            raise ValueError(
                f"promote names {cmd['name']!r} but this replica serves "
                f"{sorted(self.serving_names())}"
            )
        path = cmd["path"]
        real = os.path.join(path, checkpoint, f"{checkpoint}.pk")
        injected = faults.corrupt_candidate(real)
        if injected != real:
            # stage a temp checkpoint layout around the corrupted copy
            # (the loader reads <path>/<name>/<name>.pk)
            stage = os.path.join(
                self.coord_dir,
                f"cand-{int(cmd['cmd_id'])}-r{self.replica_id}",
            )
            os.makedirs(os.path.join(stage, checkpoint), exist_ok=True)
            shutil.copyfile(
                injected, os.path.join(stage, checkpoint, f"{checkpoint}.pk")
            )
            path = stage
        return self.server.registry.load_checkpoint(
            checkpoint,
            arch_config=cmd.get("arch") or self.arch_config,
            path=path,
            name=target,
            device=self.server.device,
        )

    def _apply_active(self, active: Dict):
        """Follow the supervisor's published active version for ONE
        model name (the one the active file carries; the default serving
        name when absent). The switch is a registry promote: new submits
        resolve the new entry, batches in flight keep theirs — the
        micro-batch boundary IS the swap."""
        seq = int(active.get("seq", 0))
        target = active.get("name") or self.model_name
        with self._lock:
            if seq <= self._active_seqs.get(target, 0):
                return
            cmd_id = int(active.get("cmd_id", 0))
            if cmd_id == 0:
                # cmd 0 = the fleet rollback target: the base version of
                # the named model this incarnation booted with
                version = self._base_versions.get(target)
            else:
                warmed = self._warmed.get(cmd_id)
                version = (
                    warmed[1]
                    if warmed is not None and warmed[0] == target
                    else None
                )
        if version is None and int(active.get("cmd_id", 0)) != 0:
            # the published active references a candidate this replica
            # never warmed (respawned after the promote resolved, or the
            # startup active.json read raced the publish): adopt it now
            # — load, warm through the live batcher, then switch
            cmd_id = int(active.get("cmd_id", 0))
            cmd = coord.read_json(self._cmd_path(cmd_id))
            if cmd is None:
                return
            entry = self._load_candidate(cmd)
            self.server.warm_version(entry.name, entry.version)
            with self._lock:
                self._warmed[cmd_id] = (entry.name, entry.version)
                self._warm_versions.add((entry.name, entry.version))
            version = entry.version
        if version is None:
            return
        with self._lock:
            warm_needed = (target, version) not in self._warm_versions
        if warm_needed:
            # switching onto a registered-but-never-warmed version (a
            # respawned replica's booted base on a fleet rollback):
            # warm it through the live batcher FIRST, or every bucket's
            # first post-switch request pays a compile inline
            self.server.warm_version(target, version)
            with self._lock:
                self._warm_versions.add((target, version))
        self.server.registry.promote(target, version)
        with self._lock:
            self._active_seqs[target] = seq

    def _existing_cmds(self) -> int:
        return highest_cmd(self._promote_dir())

    def _catch_up_promotes(self):
        """Startup: adopt every published active version (fleet-wide AND
        per-name) before serving. Loads ONLY the active candidates —
        commands already on disk are NEVER replayed (their promotes
        resolved, or are resolving, against quorums that predate this
        incarnation; re-warming a rejected candidate on every respawn
        would burn compiles and overwrite historical acks). Warmup of
        the adopted versions happens in ``server.start()``, which warms
        the active version of every name."""
        existing = self._existing_cmds()
        with self._lock:
            self._last_cmd_handled = existing
        for active in self._published_actives():
            self._catch_up_one(active, existing)

    def _catch_up_one(self, active: Dict, existing: int):
        target = active.get("name") or self.model_name
        cmd_id = int(active.get("cmd_id", 0))
        seq = int(active.get("seq", 0))
        if cmd_id == 0:
            with self._lock:
                self._active_seqs[target] = max(
                    self._active_seqs.get(target, 0), seq
                )
                self._last_cmd_handled = max(
                    self._last_cmd_handled,
                    int(active.get("latest_cmd", 0)),
                )
            return
        cmd = coord.read_json(self._cmd_path(cmd_id))
        if cmd is None:
            # active references a torn/missing command: skip history and
            # let _apply_active's adopt path pick the version up live
            return
        entry = self._load_candidate(cmd)
        self.server.registry.promote(target, entry.version)
        with self._lock:
            self._warmed[cmd_id] = (target, entry.version)
            self._active_seqs[target] = max(
                self._active_seqs.get(target, 0), seq
            )
            # commands at or before the active one are history; later
            # ones (a promote racing our respawn) are handled live
            self._last_cmd_handled = max(
                self._last_cmd_handled, cmd_id,
                int(active.get("latest_cmd", cmd_id)),
            )


# ---- supervisor ------------------------------------------------------------


class _ReplicaHandle:
    """Supervisor-side state for one replica slot."""

    __slots__ = (
        "rid", "proc", "incarnation", "spawned_ts", "detect_ts",
        "was_serving", "fail_streak", "respawn_at",
    )

    def __init__(self, rid: int):
        self.rid = rid
        self.proc: Optional[subprocess.Popen] = None
        self.incarnation = 0
        self.spawned_ts = 0.0
        self.detect_ts: Optional[float] = None  # respawn pending since
        self.was_serving = False
        self.fail_streak = 0  # consecutive deaths without reaching serving
        self.respawn_at: Optional[float] = None  # backoff: spawn not before


class ServingFleet:
    """Supervise N replica processes through one coordination directory.

    The supervisor is also an ObservabilityServer provider (``health()``
    + ``metrics.render_prometheus()``), so ``observability_port`` exposes
    fleet ``/healthz`` + ``/metrics`` like any replica or training run.
    """

    def __init__(
        self,
        coord_dir: str,
        n_replicas: int,
        spec_path: Optional[str] = None,
        worker_cmd: Optional[List[str]] = None,
        env: Optional[Dict[str, str]] = None,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
        lease_s: float = DEFAULT_LEASE_S,
        poll_s: float = 0.1,
        boot_timeout_s: float = 180.0,
        log_dir: Optional[str] = None,
        observability_port: Optional[int] = None,
    ):
        if spec_path is None and worker_cmd is None:
            raise ValueError("need spec_path or an explicit worker_cmd")
        self.coord_dir = coord_dir
        self.target = int(n_replicas)
        self.spec_path = spec_path
        self.worker_cmd = worker_cmd or [
            sys.executable, "-m", "hydragnn_tpu_torch.serve.fleet",
            "--spec", spec_path, "--dir", coord_dir,
        ]
        self.extra_env = dict(env or {})
        self.heartbeat_s = float(heartbeat_s)
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.boot_timeout_s = float(boot_timeout_s)
        self.metrics = FleetMetrics()
        self.metrics.registry.set("target_replicas", float(self.target))
        self.events = RunEventLog(
            os.path.join(log_dir or coord_dir, "events.jsonl")
        )
        self._replicas: Dict[int, _ReplicaHandle] = {
            rid: _ReplicaHandle(rid) for rid in range(self.target)
        }
        # slots removed by a scale-down: their processes drain (SIGTERM)
        # off the monitored set, but stop() still owns their teardown
        self._retired: List[_ReplicaHandle] = []
        self._lock = threading.Lock()  # guards _replicas + counters
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # degraded means LOST capacity: the flag starts True so the boot
        # window (live climbing 0 -> target) emits no fleet_degraded —
        # only a drop from a previously-full fleet does
        self._degraded = True
        self._next_cmd = 0
        self._active_seq = 0
        self._http = None
        self._observability_port = observability_port

    # -- lifecycle -----------------------------------------------------------
    def start(self, wait_serving: bool = True,
              timeout: Optional[float] = None) -> "ServingFleet":
        for sub in (f"{REPLICA}s", "dead", "promote",
                    os.path.join("promote", "active-byname")):
            os.makedirs(os.path.join(self.coord_dir, sub), exist_ok=True)
        self._emit_tenant_admissions()
        # a supervisor RESTARTED on an existing coordination dir must
        # continue the promote sequence, not restart it: reusing cmd id
        # 1 would overwrite history and let stale ack files satisfy the
        # new promote without any replica having warmed it
        pdir = os.path.join(self.coord_dir, "promote")
        seqs = [0]
        active = coord.read_json(os.path.join(pdir, "active.json"))
        if active is not None:
            seqs.append(int(active.get("seq", 0)))
        bydir = os.path.join(pdir, "active-byname")
        if os.path.isdir(bydir):
            # named promotes publish per-name actives: the seq counter
            # must clear THOSE too, or a restarted supervisor's next
            # promote would be ignored as stale by every replica
            for fn in os.listdir(bydir):
                if fn.endswith(".json"):
                    a = coord.read_json(os.path.join(bydir, fn))
                    if a is not None:
                        seqs.append(int(a.get("seq", 0)))
        with self._lock:
            self._next_cmd = max(self._next_cmd, highest_cmd(pdir))
            self._active_seq = max(self._active_seq, *seqs)
        for rid in range(self.target):
            self._spawn(self._replicas[rid])
        monitor = threading.Thread(
            target=self._monitor_loop, name="hydragnn-fleet-monitor",
            daemon=True,
        )
        monitor.start()
        with self._lock:
            self._monitor = monitor
        if self._observability_port is not None:
            from hydragnn_tpu_torch.obs.http import ObservabilityServer

            self._http = ObservabilityServer(
                self, port=self._observability_port
            ).start()
        if wait_serving:
            self.wait_serving(timeout or self.boot_timeout_s)
        return self

    def stop(self, graceful: bool = True, timeout: float = 15.0):
        self._stop.set()
        with self._lock:
            monitor, self._monitor = self._monitor, None
            # snapshot: resize() mutates _replicas from other threads
            handles = list(self._replicas.values()) + list(self._retired)
        if monitor is not None and monitor.is_alive():
            monitor.join(timeout=max(self.poll_s * 8, 5.0))
        for handle in handles:
            proc = handle.proc
            if proc is None or proc.poll() is not None:
                continue
            if graceful:
                proc.terminate()  # replicas drain on SIGTERM
        deadline = time.monotonic() + timeout
        for handle in handles:
            proc = handle.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if self._http is not None:
            self._http.stop()
            self._http = None
        self.events.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def emit(self, event: str, **fields):
        """Append one schema-gated event to the fleet stream (public:
        load generators append their ``fleet_report`` here)."""
        self.events.emit(event, **fields)

    def _emit_tenant_admissions(self):
        """One ``tenant_admitted`` per spec'd tenant at fleet start: the
        audit record of who is packed into this fleet with what quota."""
        if self.spec_path is None:
            return
        try:
            with open(self.spec_path) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            return
        default_quota = env_int(
            "HYDRAGNN_TENANT_DEFAULT_QUOTA", DEFAULT_QUOTA, minimum=1
        )
        for t in spec.get("tenants") or ():
            self.emit(
                "tenant_admitted",
                tenant=t.get("name"),
                model=t.get("model") or t.get("name"),
                quota=int(t.get("quota") or default_quota),
            )

    # -- autoscaling ---------------------------------------------------------
    def resize(self, n_replicas: int, reason: str = "manual") -> int:
        """Grow/shrink the supervised replica set to ``n_replicas``.

        Grow spawns fresh slots at the next rids; shrink SIGTERMs the
        highest rids, which drain (every in-flight future resolves) and
        release their leases marked done — removed from the monitored
        set first, so the monitor never "heals" an intentional retire.
        Emits ``fleet_scaled``; the autoscaler is the main caller."""
        n = int(n_replicas)
        if n < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n}")
        grown: List[_ReplicaHandle] = []
        shrunk: List[_ReplicaHandle] = []
        with self._lock:
            old = self.target
            if n == old:
                return old
            if n > old:
                for rid in range(old, n):
                    handle = self._replicas.get(rid) or _ReplicaHandle(rid)
                    self._replicas[rid] = handle
                    grown.append(handle)
            else:
                for rid in range(n, old):
                    handle = self._replicas.pop(rid, None)
                    if handle is not None:
                        shrunk.append(handle)
                        self._retired.append(handle)
            self.target = n
            if grown:
                # new slots boot live < target for a while: that is
                # GROWTH, not lost capacity — suppress fleet_degraded
                # exactly like the initial boot window does
                self._degraded = True
        self.metrics.registry.set("target_replicas", float(n))
        for handle in grown:
            self._spawn(handle)
        for handle in shrunk:
            proc = handle.proc
            if proc is not None and proc.poll() is None:
                proc.terminate()  # drain, answer stragglers, lease done
        self.emit(
            "fleet_scaled", old_target=old, new_target=n, reason=reason
        )
        return n

    # -- spawning ------------------------------------------------------------
    def _worker_env(self, handle: _ReplicaHandle) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(
            HYDRAGNN_FLEET_DIR=self.coord_dir,
            HYDRAGNN_FLEET_REPLICA=str(handle.rid),
            HYDRAGNN_FLEET_GEN=str(handle.incarnation),
            HYDRAGNN_FLEET_HEARTBEAT_S=str(self.heartbeat_s),
        )
        return env

    def _spawn(self, handle: _ReplicaHandle):
        handle.proc = subprocess.Popen(
            self.worker_cmd, env=self._worker_env(handle)
        )
        handle.spawned_ts = time.time()
        handle.was_serving = False

    def replica_pid(self, rid: int) -> Optional[int]:
        proc = self._replicas[int(rid)].proc
        return None if proc is None else proc.pid

    def replica_port(self, rid: int) -> Optional[int]:
        lease = coord.read_json(
            coord.hb_path(self.coord_dir, REPLICA, rid, prefix=REPLICA)
        )
        if lease is None:
            return None
        return int(lease.get("port") or 0) or None

    # -- monitoring ----------------------------------------------------------
    def _lease(self, handle: _ReplicaHandle) -> Optional[Dict]:
        lease = coord.read_json(
            coord.hb_path(
                self.coord_dir, REPLICA, handle.rid, prefix=REPLICA
            )
        )
        if lease is None:
            return None
        if int(lease.get("gen", handle.incarnation)) != handle.incarnation:
            return None  # a previous incarnation's lease: booting
        return lease

    def _monitor_loop(self):
        while not self._stop.wait(self.poll_s):
            try:
                self._tick()
            except Exception:
                pass  # monitoring must outlive any single bad read

    def _tick(self, now: Optional[float] = None):
        now = time.time() if now is None else now
        live = 0
        with self._lock:  # resize() mutates the dict concurrently
            handles = list(self._replicas.values())
        for handle in handles:
            if handle.respawn_at is not None:
                # respawn backoff window: the slot is down by decision,
                # not death — spawn once the window closes
                if now >= handle.respawn_at:
                    handle.respawn_at = None
                    self._spawn(handle)
                continue
            lease = self._lease(handle)
            serving = lease_serving(lease, self.lease_s, now)
            if serving:
                live += 1
                if not handle.was_serving:
                    handle.was_serving = True
                    handle.fail_streak = 0  # reached serving: heal worked
                    if handle.detect_ts is not None:
                        downtime = now - handle.detect_ts
                        handle.detect_ts = None
                        self.metrics.registry.inc("replica_respawns_total")
                        self.metrics.registry.set(
                            "last_recovery_seconds", round(downtime, 3)
                        )
                        self.emit(
                            "replica_respawned",
                            replica=handle.rid,
                            downtime_s=round(downtime, 3),
                            incarnation=handle.incarnation,
                        )
                continue
            reason = self._death_reason(handle, lease, now)
            if reason is None:
                continue
            self._heal(handle, reason, now)
        self._publish_status(live)

    def _death_reason(self, handle: _ReplicaHandle, lease: Optional[Dict],
                      now: float) -> Optional[str]:
        proc = handle.proc
        if proc is None:
            return None
        rc = proc.poll()
        if rc is not None:
            return f"exit_{rc}"
        if lease is None:
            # no current-incarnation lease yet: still booting, unless it
            # has been booting implausibly long (wedged before serving)
            if now - handle.spawned_ts > self.boot_timeout_s:
                return "boot_timeout"
            return None
        if lease.get("done"):
            return None  # drained clean: not a loss, not respawned
        if now - float(lease["ts"]) > self.lease_s:
            return "lease_expired"
        return None

    def _heal(self, handle: _ReplicaHandle, reason: str, now: float):
        """One replica death end to end: kill whatever is left of the
        process, emit + count the loss, respawn at the next incarnation.
        (No tombstone: replicas run no peer watchdog and the router
        discovers from leases alone, so the supervisor's SIGKILL is the
        whole eviction.) A slot that keeps dying before ever reaching
        serving respawns under exponential backoff — a persistent boot
        failure (bad spec, missing checkpoint) must not turn the
        supervisor into a fork storm."""
        proc = handle.proc
        if proc is not None and proc.poll() is None:
            proc.kill()  # wedged (stale lease): SIGKILL, not a drain
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        age = coord.heartbeat_age(
            self.coord_dir, REPLICA, handle.rid, now=now, prefix=REPLICA
        )
        self.metrics.registry.inc("replica_losses_total")
        self.emit(
            "replica_lost",
            replica=handle.rid,
            reason=reason,
            stale_s=None if age is None else round(float(age), 3),
            incarnation=handle.incarnation,
        )
        handle.detect_ts = handle.detect_ts or now
        handle.incarnation += 1
        streak = handle.fail_streak
        handle.fail_streak += 1
        if streak == 0:
            self._spawn(handle)  # first failure heals immediately
        else:
            handle.respawn_at = now + min(0.5 * (2.0 ** (streak - 1)), 15.0)

    def _publish_status(self, live: int):
        with self._lock:
            # resize() flips _degraded under the same lock (the grow
            # boot-window suppression); the read-modify-write here must
            # not race it into a spurious fleet_degraded
            degraded = live < self.target
            was_degraded = self._degraded
            self._degraded = degraded
        self.metrics.registry.set("live_replicas", float(live))
        self.metrics.registry.set(
            "availability", live / max(self.target, 1)
        )
        self.metrics.registry.set("degraded", float(degraded))
        if degraded and not was_degraded:
            self.emit("fleet_degraded", live=live, target=self.target)
        coord.write_json(
            os.path.join(self.coord_dir, "fleet.json"),
            {"live": live, "target": self.target, "degraded": degraded,
             "ts": time.time()},
        )

    def wait_serving(self, timeout: float = 60.0) -> int:
        """Block until every replica serves (or timeout); returns the
        live count. The monitor keeps healing regardless."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = coord.read_json(
                os.path.join(self.coord_dir, "fleet.json")
            )
            if status and status.get("live", 0) >= self.target:
                return int(status["live"])
            time.sleep(self.poll_s)
        status = coord.read_json(
            os.path.join(self.coord_dir, "fleet.json")
        )
        return int(status.get("live", 0)) if status else 0

    # -- hot-swap orchestration ----------------------------------------------
    def promote(
        self,
        checkpoint: str,
        path: str,
        arch_config: Optional[dict] = None,
        name: Optional[str] = None,
        timeout: float = 120.0,
    ) -> Dict:
        """Zero-downtime promote: command every live replica to load +
        warm the candidate; publish the new active version only when ALL
        of them ack warmed. Any failed/timed-out ack rolls back — the
        active version (and every replica's serving state) is untouched
        and the rejection is loud (``model_rollback`` + return value)."""
        with self._lock:
            self._next_cmd += 1
            cmd_id = self._next_cmd
        pdir = os.path.join(self.coord_dir, "promote")
        cmd = {
            "cmd_id": cmd_id,
            "checkpoint": checkpoint,
            "path": os.path.abspath(path),
            "name": name,
            "ts": time.time(),
        }
        if arch_config is not None:
            cmd["arch"] = arch_config
        coord.write_json(
            os.path.join(pdir, f"cmd-{cmd_id:06d}.json"), cmd
        )
        # the ack quorum is the replicas SERVING on a FRESH lease at
        # command time — a stale lease is a death in progress, and
        # waiting on its ack would block the promote for the full
        # timeout. A member that gets respawned mid-promote fails the
        # promote fast instead: its new incarnation never saw the
        # command (boot fast-forwards history) and adopts the candidate
        # from active.json only if the promote resolves without it.
        now = time.time()
        quorum_inc: Dict[int, int] = {}
        with self._lock:
            handles = list(self._replicas.values())
        for h in handles:
            if lease_serving(self._lease(h), self.lease_s, now):
                quorum_inc[h.rid] = h.incarnation
        if not quorum_inc:
            # nobody serving means nobody can warm the candidate — fail
            # NOW with a clear reason rather than blocking the full
            # timeout (replicas booting right now fast-forward past this
            # command and would never ack it)
            reason = "no serving replica to warm the candidate"
            result = {
                "status": "rolled_back",
                "cmd_id": cmd_id,
                "reason": reason,
                "acks": {},
            }
            coord.write_json(
                os.path.join(pdir, f"result-{cmd_id:06d}.json"), result
            )
            self.metrics.registry.inc("rollbacks_total")
            self.emit(
                "model_rollback",
                name=name or checkpoint,
                reason=reason,
                cmd_id=cmd_id,
            )
            return result
        quorum = sorted(quorum_inc)
        acks: Dict[int, Dict] = {}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and len(acks) < len(quorum):
            for rid in quorum:
                if rid in acks:
                    continue
                with self._lock:
                    handle = self._replicas.get(rid)
                if handle is None or handle.incarnation != quorum_inc[rid]:
                    acks[rid] = {
                        "status": "failed",
                        "error": "replica lost and respawned mid-promote",
                    }
                    continue
                ack = coord.read_json(
                    os.path.join(pdir, f"ack-{cmd_id:06d}-r{rid}.json")
                )
                if ack is not None:
                    acks[rid] = ack
            time.sleep(self.poll_s)
        failed = {
            rid: ack for rid, ack in acks.items()
            if ack.get("status") != "warmed"
        }
        missing = [rid for rid in quorum if rid not in acks]
        if failed or missing:
            reason = "; ".join(
                [f"replica {rid}: {ack.get('error', 'failed')}"
                 for rid, ack in sorted(failed.items())]
                + [f"replica {rid}: no ack within {timeout:.0f}s"
                   for rid in missing]
            )
            result = {
                "status": "rolled_back",
                "cmd_id": cmd_id,
                "reason": reason,
                "acks": acks,
            }
            coord.write_json(
                os.path.join(pdir, f"result-{cmd_id:06d}.json"), result
            )
            self.metrics.registry.inc("rollbacks_total")
            self.emit(
                "model_rollback",
                name=name or checkpoint,
                reason=reason,
                cmd_id=cmd_id,
                **(
                    {}
                    if not acks
                    else {"version": max(
                        int(a.get("version", 0)) for a in acks.values()
                    )}
                ),
            )
            return result
        with self._lock:
            self._active_seq += 1
            seq = self._active_seq
        versions = {rid: int(ack["version"]) for rid, ack in acks.items()}
        t_publish = time.time()
        active_payload = {
            "seq": seq, "cmd_id": cmd_id, "checkpoint": checkpoint,
            "name": name, "latest_cmd": cmd_id, "ts": t_publish,
        }
        if name is None:
            coord.write_json(
                os.path.join(pdir, "active.json"), active_payload
            )
        else:
            # NAMED promotes (per-tenant hot-swap) publish under
            # active-byname/<name>.json and leave active.json alone:
            # each model name gets its own active pointer, so promotes
            # of different names never overwrite each other's catch-up
            # state for respawning replicas
            os.makedirs(
                os.path.join(pdir, "active-byname"), exist_ok=True
            )
            coord.write_json(
                os.path.join(pdir, "active-byname", f"{name}.json"),
                active_payload,
            )
        # wait (bounded) for every acked replica's lease to REPORT the
        # new active version: when this returns "propagated", the whole
        # fleet answers new submits from the candidate — the swap is
        # done, not merely announced
        prop_deadline = time.monotonic() + max(
            min(timeout, 30.0), self.poll_s * 4
        )

        def _lease_reports(rid: int) -> bool:
            with self._lock:
                handle = self._replicas.get(rid)
            if handle is None:
                return True  # retired by a scale-down mid-propagation
            lease = self._lease(handle)
            if lease is None:
                return False
            if name is not None:
                # named promote: verify against the per-name actives map
                # (the legacy "active" field tracks the DEFAULT name)
                reported = (lease.get("actives") or {}).get(name)
            else:
                reported = (lease.get("active") or {}).get("version")
            return reported == versions[rid]

        propagated = False
        while time.monotonic() < prop_deadline and not propagated:
            propagated = all(_lease_reports(rid) for rid in versions)
            if not propagated:
                time.sleep(self.poll_s)
        result = {
            "status": "promoted",
            "cmd_id": cmd_id,
            "versions": versions,
            "propagated": propagated,
            "acks": acks,
        }
        coord.write_json(
            os.path.join(pdir, f"result-{cmd_id:06d}.json"), result
        )
        self.metrics.registry.inc("promotes_total")
        self.emit(
            "model_promoted",
            name=name or checkpoint,
            version=max(versions.values()),
            cmd_id=cmd_id,
            replicas=sorted(versions),
            propagation_s=round(time.time() - t_publish, 3),
        )
        return result

    def rollback(self, reason: str = "operator",
                 name: Optional[str] = None) -> Dict:
        """Revert the published active version to the base checkpoint
        (cmd 0) — fleet-wide default name, or ONE tenant model when
        ``name`` is given. Replicas re-promote their original entry at
        the next watcher tick — already warm, so the revert is also
        downtime-free."""
        with self._lock:
            self._active_seq += 1
            seq = self._active_seq
            latest = self._next_cmd
        payload = {"seq": seq, "cmd_id": 0, "latest_cmd": latest,
                   "name": name, "ts": time.time()}
        if name is None:
            coord.write_json(
                os.path.join(self.coord_dir, "promote", "active.json"),
                payload,
            )
        else:
            bydir = os.path.join(
                self.coord_dir, "promote", "active-byname"
            )
            os.makedirs(bydir, exist_ok=True)
            coord.write_json(
                os.path.join(bydir, f"{name}.json"), payload
            )
        self.metrics.registry.inc("rollbacks_total")
        self.emit(
            "model_rollback", name=name or "<base>", reason=reason,
            cmd_id=0,
        )
        return {"status": "rolled_back", "cmd_id": 0, "reason": reason}

    # -- provider protocol ---------------------------------------------------
    def health(self) -> Dict:
        status = coord.read_json(
            os.path.join(self.coord_dir, "fleet.json")
        ) or {}
        live = int(status.get("live", 0))
        with self._lock:
            handles = dict(self._replicas)
        return {
            "status": "ok" if live >= self.target else (
                "degraded" if live else "down"
            ),
            "live": live,
            "target": self.target,
            "replicas": {
                rid: {
                    "incarnation": h.incarnation,
                    "pid": None if h.proc is None else h.proc.pid,
                    "port": self.replica_port(rid),
                }
                for rid, h in handles.items()
            },
        }


# ---- spec-driven replica process -------------------------------------------


def build_server_from_spec(spec: Dict):
    """Build (InferenceServer, arch_config, model_name) from a fleet
    spec: the one recipe the CLI replica, the tests and the smoke share::

        {
          "checkpoint": {"name": "model", "path": "logs/"},
          "arch": {... Architecture section ...},
          "model_name": "model",          # registry/serving name
          "samples": "samples.pkl",       # list[GraphData] for the plan
          "plan": {"max_batch_graphs": 8, "num_buckets": 3},
          "server": {"max_wait_s": 0.005, "queue_capacity": 256},
          "device": "cpu",                # optional: absent = the card
          "tenants": [                    # optional: multi-tenant packing
            {"name": "acme", "model": "model", "quota": 32, "weight": 2},
            {"name": "beta", "model": "aux",
             "checkpoint": {"name": "aux_ck", "path": "logs/"}}
          ],
          "cache": {"enabled": true}      # optional: response cache
        }

    ``device`` absent means the card, and a machine without one raises
    here, before anything is built: a replica never serves on the CPU
    unless its spec says ``"cpu"``. ``samples`` is a pickle of either
    package's ``GraphData`` list, read as the port's class."""
    from hydragnn_tpu_torch.data.serialized import SafeUnpickler
    from hydragnn_tpu_torch.serve.buckets import plan_from_samples
    from hydragnn_tpu_torch.serve.cache import ResponseCache
    from hydragnn_tpu_torch.serve.quality import UncertaintyScorer
    from hydragnn_tpu_torch.serve.registry import ModelRegistry
    from hydragnn_tpu_torch.serve.server import InferenceServer
    from hydragnn_tpu_torch.serve.tenants import TenantManager
    from hydragnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(spec.get("device"))
    with open(spec["samples"], "rb") as f:
        samples = SafeUnpickler(f).load()
    plan = plan_from_samples(samples, **dict(spec.get("plan", {})))
    registry = ModelRegistry()
    name = spec.get("model_name") or spec["checkpoint"]["name"]
    registry.load_checkpoint(
        spec["checkpoint"]["name"],
        arch_config=spec.get("arch"),
        path=spec["checkpoint"]["path"],
        name=name,
        device=device,
    )
    # tenant models pack into the same registry at server construction
    # (InferenceServer calls tenants.load_models); tenants whose model IS
    # the default name share its entry
    tenants = TenantManager.from_specs(spec["tenants"]) if spec.get("tenants") else None
    cache = ResponseCache.from_env(spec.get("cache"))
    # the opt-in K-sample uncertainty path (HYDRAGNN_UNC_SAMPLES=0: None,
    # no scoring program captured)
    scorer = UncertaintyScorer.from_env(registry, device=device)
    server = InferenceServer(
        registry, plan, default_model=name, tenants=tenants, cache=cache,
        scorer=scorer, device=device, **dict(spec.get("server", {}))
    )
    return server, spec.get("arch"), name


def feedback_dir(queue_dir: str, role: str, rid: int) -> str:
    """Where one process's feedback packs go: ``<queue_dir>/<role><rid>``.
    Packs are per-process state (a sink's pack ranks count from 0), so each
    process writes into a directory of its own. A replica's is the JAX
    package's ``replica<rid>``; a canary's is ``canary<rid>``, where the
    JAX package writes ``replica<rid>`` for a canary too: a canary and a
    replica of the same id would both write ``shard.00000.gpk`` there."""
    return os.path.join(queue_dir, f"{role}{int(rid)}")


def replica_main(spec_path: str) -> int:
    """Body of one supervised replica process (the CLI with
    ``HYDRAGNN_FLEET_REPLICA`` set): build the server from the spec,
    serve until SIGTERM."""
    from hydragnn_tpu_torch.obs.drift import DriftDetector
    from hydragnn_tpu_torch.serve.costs import CostLedger
    from hydragnn_tpu_torch.serve.quality import FeedbackSink

    with open(spec_path) as f:
        spec = json.load(f)
    coord_dir = os.environ["HYDRAGNN_FLEET_DIR"]
    rid = int(os.environ["HYDRAGNN_FLEET_REPLICA"])
    server, arch, name = build_server_from_spec(spec)
    # each replica gets its OWN event stream (RunEventLog's per-file seq
    # forbids multi-process writers on one file); readers merge
    # events*.jsonl from the coord dir
    role = CANARY if os.getenv("HYDRAGNN_FLEET_CANARY") else REPLICA
    cost_events = RunEventLog(os.path.join(coord_dir, f"events-{role}{rid}.jsonl"))
    server.costs = CostLedger(emit=cost_events.emit)
    replica = ReplicaServer(
        server,
        coord_dir,
        rid,
        incarnation=int(os.getenv("HYDRAGNN_FLEET_GEN", "0")),
        heartbeat_s=float(os.getenv("HYDRAGNN_FLEET_HEARTBEAT_S", str(DEFAULT_HEARTBEAT_S))),
        model_name=name,
        arch_config=arch,
        # the canary controller spawns this same entry point with
        # HYDRAGNN_FLEET_CANARY=1: same server, canary lease namespace,
        # no promote watcher
        role=role,
    )
    # drift detector with version-pinned reference windows (one directory
    # per replica: the reference files are per-process state) and the
    # feedback sink; each is None when its knobs turn it off
    drift = DriftDetector.from_env(
        os.path.join(coord_dir, f"drift-{role}{rid}"), emit=cost_events.emit
    )
    replica.drift = drift
    sink = FeedbackSink.from_env(emit=cost_events.emit)
    if sink is not None:
        sink.queue_dir = feedback_dir(sink.queue_dir, role, rid)
    replica.sink = sink
    if drift is not None:
        # promote/rollback re-pins the reference to the activated
        # version; the initial call adopts (or loads) v_active's window
        server.registry.add_activation_listener(
            lambda _name, version: drift.on_activate(version)
        )
        drift.on_activate(server.registry.active_version(name))
    replica.serve_forever()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.serve.fleet",
        description="Serving-fleet supervisor / replica (module docs).",
    )
    parser.add_argument("--spec", required=True, help="fleet spec JSON")
    parser.add_argument("--dir", default=None,
                        help="coordination dir (supervisor mode)")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--heartbeat", type=float,
                        default=DEFAULT_HEARTBEAT_S)
    parser.add_argument("--lease", type=float, default=DEFAULT_LEASE_S)
    parser.add_argument("--obs-port", type=int, default=None)
    args = parser.parse_args(argv)
    if os.getenv("HYDRAGNN_FLEET_REPLICA") is not None:
        return replica_main(args.spec)
    if args.dir is None:
        parser.error("supervisor mode needs --dir")
    fleet = ServingFleet(
        args.dir,
        args.replicas,
        spec_path=args.spec,
        heartbeat_s=args.heartbeat,
        lease_s=args.lease,
        observability_port=args.obs_port,
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    fleet.start()
    while not stop.wait(0.5):
        pass
    fleet.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
