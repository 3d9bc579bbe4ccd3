"""SLO-gated canary promotion: shadow routing and statistical quality
gates (port of the JAX package's ``serve/canary.py``).

The fleet's hot-swap promotes any candidate that loads strictly and warms:
a mechanical gate. This module adds a quality gate: training publishes
candidate snapshots into a
:class:`~hydragnn_tpu_torch.serve.registry.CandidateChannel`, and a
:class:`CanaryController` proves each one against live traffic before the
all-acked hot-swap may fire::

    publish            shadow                 gates            promote
    -------            ------                 -----            -------
    cand-<seq>.json -> canary replica boots   per-head MAE     all pass ->
    (training side)    the snapshot; the      per-bucket         fleet.promote
                       router's shadow tap    latency delta    any fail ->
                       mirrors a fraction     NaN/error veto     canary_rejected
                       of live 200s to it     min-sample floor

- **The canary never serves a live request.** It leases under
  ``<dir>/canarys/``, which the router's discovery (``replicas/``) cannot
  see, so it is out of routing and of the capacity count by construction.
  Its process is ``python -m hydragnn_tpu_torch.serve.fleet`` with
  ``HYDRAGNN_FLEET_CANARY=1``: on the card it has its own CUDA context and
  contends with the live replicas for the card by time-slicing, which the
  latency gate sees.
- **Shadow work sheds first.** The tap drops (and counts) mirrored
  requests while the fleet is degraded or the bounded queue is full; it
  never blocks, and a raising tap is swallowed by the router.
- **A bad candidate never reaches active.** NaN answers and canary errors
  are vetoes, a crash-looping candidate runs out of respawns, a slow or
  diverged one fails its gate, one that cannot gather the sample floor in
  time is rejected as unproven, and every rejection is loud
  (``canary_rejected`` with the gate named).
"""

import dataclasses
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.analysis.guards import nan_origin
from hydragnn_tpu_torch.obs.metrics import MetricsRegistry
from hydragnn_tpu_torch.serve.fleet import (
    CANARY,
    DEFAULT_HEARTBEAT_S,
    DEFAULT_LEASE_S,
    encode_graph,
    lease_serving,
)
from hydragnn_tpu_torch.serve.registry import CandidateChannel
from hydragnn_tpu_torch.utils import envparse


def _env_float(name: str, default: float) -> float:
    return float(os.getenv(name, str(default)))


def _env_int(name: str, default: int) -> int:
    return int(os.getenv(name, str(default)))


@dataclasses.dataclass(frozen=True)
class CanaryGates:
    """The statistical promotion gates, all knobs env-overridable
    (``HYDRAGNN_CANARY_*``, the JAX package's names).

    A candidate is promoted only when, over at least ``min_samples``
    shadow comparisons: every head's MAE vs the active version is
    within ``max(head_mae_tol, head_mae_rel_tol * mean|live|)``; every
    bucket with ``min_bucket_samples`` comparisons keeps its mean
    canary latency within ``live * latency_ratio_tol + latency_slack_s``
    (the additive slack keeps microsecond-scale buckets from failing on
    noise); and the hard vetoes never fired — more than
    ``max_shadow_errors`` canary-side errors, ANY non-finite canary
    answer, or more than ``max_crashes`` canary process deaths each
    reject immediately. A candidate that cannot reach the sample floor
    within ``decide_timeout_s`` is rejected as unproven: promotion
    requires positive evidence, never its absence."""

    min_samples: int = 24
    min_bucket_samples: int = 4
    head_mae_tol: float = 5e-3
    head_mae_rel_tol: float = 0.05
    latency_ratio_tol: float = 2.5
    latency_slack_s: float = 0.05
    max_shadow_errors: int = 0
    max_crashes: int = 1
    decide_timeout_s: float = 120.0
    # uncertainty veto (None = gate off): reject when the candidate's
    # mean predictive uncertainty exceeds live's by more than this
    # ratio — only meaningful when the serving path runs an
    # UncertaintyScorer, inert otherwise (no uncertainty samples ever
    # accumulate, and the gate skips on an empty record)
    max_unc_ratio: Optional[float] = None

    @classmethod
    def from_env(cls, **overrides) -> "CanaryGates":
        base = cls(**overrides)
        return cls(
            min_samples=_env_int(
                "HYDRAGNN_CANARY_MIN_SAMPLES", base.min_samples),
            min_bucket_samples=_env_int(
                "HYDRAGNN_CANARY_MIN_BUCKET_SAMPLES",
                base.min_bucket_samples),
            head_mae_tol=_env_float(
                "HYDRAGNN_CANARY_HEAD_MAE_TOL", base.head_mae_tol),
            head_mae_rel_tol=_env_float(
                "HYDRAGNN_CANARY_HEAD_MAE_REL_TOL", base.head_mae_rel_tol),
            latency_ratio_tol=_env_float(
                "HYDRAGNN_CANARY_LATENCY_RATIO_TOL", base.latency_ratio_tol),
            latency_slack_s=_env_float(
                "HYDRAGNN_CANARY_LATENCY_SLACK_S", base.latency_slack_s),
            max_shadow_errors=_env_int(
                "HYDRAGNN_CANARY_MAX_SHADOW_ERRORS", base.max_shadow_errors),
            max_crashes=_env_int(
                "HYDRAGNN_CANARY_MAX_CRASHES", base.max_crashes),
            decide_timeout_s=_env_float(
                "HYDRAGNN_CANARY_DECIDE_TIMEOUT_S", base.decide_timeout_s),
            max_unc_ratio=(
                envparse.env_float(
                    "HYDRAGNN_CANARY_MAX_UNC_RATIO", 0.0, minimum=1e-9
                )
                if os.getenv("HYDRAGNN_CANARY_MAX_UNC_RATIO")
                else base.max_unc_ratio
            ),
        )


class CanaryMetrics:
    """The ``hydragnn_canary_*`` series (one per controller)."""

    def __init__(self):
        r = MetricsRegistry("hydragnn_canary")
        r.gauge("evaluating", "1 while a candidate is under shadow eval")
        r.gauge("candidate_seq", "Channel seq of the candidate under eval")
        r.gauge("shadow_queue_depth", "Mirrored requests awaiting replay")
        r.counter("shadow_samples_total",
                  "Shadow comparisons accumulated into the gates")
        r.counter("shadow_shed_total",
                  "Mirrored requests dropped (degraded fleet / queue full)")
        r.counter("shadow_errors_total",
                  "Canary-side error answers (non-200) — the error veto")
        r.counter("nan_vetoes_total",
                  "Candidates rejected on a non-finite canary answer")
        r.counter("crashes_total", "Canary process deaths detected")
        r.counter("promotes_total", "Candidates promoted to active")
        r.counter("rejects_total", "Candidates rejected (any reason)")
        r.labeled_gauge("head_mae",
                        "Shadow MAE vs active, per output head")
        r.labeled_gauge("latency_ratio",
                        "Mean canary/live latency ratio, per bucket")
        self.registry = r

    def snapshot(self) -> Dict:
        return self.registry.snapshot()

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()


class _CandidateStats:
    """Thread-safe accumulator for one candidate's shadow evidence."""

    def __init__(self):
        self._lock = threading.Lock()
        self.samples = 0
        self.errors = 0
        self.nans = 0
        # first few NaN-veto origin payloads (analysis/guards.nan_origin
        # over the head outputs): the rejection names WHICH head went
        # non-finite (``head_<i>``), not just that one did
        self.nan_origins: List[Dict] = []
        # per head: sum |canary - live|, sum |live|, element count
        self.head_abs_err: Dict[int, float] = {}
        self.head_abs_live: Dict[int, float] = {}
        self.head_elems: Dict[int, int] = {}
        # per bucket: latency sums + count (live and canary, same graphs)
        self.bucket_live_s: Dict[int, float] = {}
        self.bucket_canary_s: Dict[int, float] = {}
        self.bucket_n: Dict[int, int] = {}
        # mean predictive uncertainty sums (present only when the
        # serving path runs an UncertaintyScorer; the uncertainty veto
        # skips when either side never reported)
        self.unc_live_sum = 0.0
        self.unc_live_n = 0
        self.unc_canary_sum = 0.0
        self.unc_canary_n = 0

    def add_sample(self, live_heads: List[np.ndarray],
                   canary_heads: List[np.ndarray], bucket: int,
                   live_latency_s: float, canary_latency_s: float,
                   live_unc=None, canary_unc=None) -> bool:
        """Fold one compared pair in; returns False (and records a NaN
        veto instead of a sample) when the canary answer is non-finite."""
        finite = all(
            bool(np.all(np.isfinite(h))) for h in canary_heads
        )
        origin = None
        if not finite:
            origin = nan_origin(
                {f"head_{i}": torch.from_numpy(np.asarray(h))
                 for i, h in enumerate(canary_heads)},
                scope="canary",
            )
        with self._lock:
            if not finite:
                self.nans += 1
                if origin is not None and len(self.nan_origins) < 8:
                    self.nan_origins.append(origin)
                return False
            for i, (live, cand) in enumerate(zip(live_heads, canary_heads)):
                live = np.asarray(live, np.float64)
                cand = np.asarray(cand, np.float64)
                self.head_abs_err[i] = (
                    self.head_abs_err.get(i, 0.0)
                    + float(np.sum(np.abs(cand - live)))
                )
                self.head_abs_live[i] = (
                    self.head_abs_live.get(i, 0.0)
                    + float(np.sum(np.abs(live)))
                )
                self.head_elems[i] = self.head_elems.get(i, 0) + live.size
            b = int(bucket)
            self.bucket_live_s[b] = (
                self.bucket_live_s.get(b, 0.0) + float(live_latency_s)
            )
            self.bucket_canary_s[b] = (
                self.bucket_canary_s.get(b, 0.0) + float(canary_latency_s)
            )
            self.bucket_n[b] = self.bucket_n.get(b, 0) + 1
            for vals, which in ((live_unc, "live"), (canary_unc, "canary")):
                if not vals:
                    continue
                finite_u = [
                    float(v) for v in vals
                    if v is not None and np.isfinite(float(v))
                ]
                if not finite_u:
                    continue
                mean_u = sum(finite_u) / len(finite_u)
                if which == "live":
                    self.unc_live_sum += mean_u
                    self.unc_live_n += 1
                else:
                    self.unc_canary_sum += mean_u
                    self.unc_canary_n += 1
            self.samples += 1
        return True

    def add_error(self):
        with self._lock:
            self.errors += 1

    def snapshot(self) -> Dict:
        with self._lock:
            head_mae = {
                i: self.head_abs_err[i] / max(self.head_elems[i], 1)
                for i in self.head_abs_err
            }
            head_live_mag = {
                i: self.head_abs_live[i] / max(self.head_elems[i], 1)
                for i in self.head_abs_live
            }
            buckets = {
                b: {
                    "n": self.bucket_n[b],
                    "live_mean_s": self.bucket_live_s[b] / self.bucket_n[b],
                    "canary_mean_s":
                        self.bucket_canary_s[b] / self.bucket_n[b],
                }
                for b in self.bucket_n
            }
            return {
                "samples": self.samples,
                "errors": self.errors,
                "nans": self.nans,
                "nan_origins": [dict(o) for o in self.nan_origins],
                "head_mae": head_mae,
                "head_live_mag": head_live_mag,
                "buckets": buckets,
                "uncertainty": {
                    "live_n": self.unc_live_n,
                    "live_mean": (
                        self.unc_live_sum / self.unc_live_n
                        if self.unc_live_n else None
                    ),
                    "canary_n": self.unc_canary_n,
                    "canary_mean": (
                        self.unc_canary_sum / self.unc_canary_n
                        if self.unc_canary_n else None
                    ),
                },
            }


def evaluate_gates(stats: Dict, gates: CanaryGates) -> Dict:
    """Pure decision logic over a :meth:`_CandidateStats.snapshot`.

    Returns ``{"verdict": "promote"|"reject"|"wait", "reason": ...,
    "failures": [...]}`` — vetoes first, then the sample floor, then
    the per-head and per-bucket gates. Separated from the controller so
    the decision table is unit-testable without any serving stack."""
    if stats["nans"] > 0:
        origins = stats.get("nan_origins") or []
        where = (
            f" (first origin: `{origins[0]['subtree']}` at "
            f"{origins[0]['origin']})"
            if origins
            else ""
        )
        return {
            "verdict": "reject",
            "reason": (
                f"nan_outputs: {stats['nans']} non-finite canary "
                f"answer(s) — hard veto{where}"
            ),
        }
    if stats["errors"] > gates.max_shadow_errors:
        return {
            "verdict": "reject",
            "reason": (
                f"shadow_errors: {stats['errors']} canary error "
                f"answer(s) (max {gates.max_shadow_errors})"
            ),
        }
    if stats["samples"] < gates.min_samples:
        return {"verdict": "wait", "reason": "below min-sample floor"}
    failures = []
    for head, mae in sorted(stats["head_mae"].items()):
        tol = max(
            gates.head_mae_tol,
            gates.head_mae_rel_tol * stats["head_live_mag"].get(head, 0.0),
        )
        if mae > tol:
            failures.append(
                f"head_mae: head {head} MAE {mae:.3e} > tol {tol:.3e}"
            )
    for bucket, rec in sorted(stats["buckets"].items()):
        if rec["n"] < gates.min_bucket_samples:
            continue
        limit = (
            rec["live_mean_s"] * gates.latency_ratio_tol
            + gates.latency_slack_s
        )
        if rec["canary_mean_s"] > limit:
            failures.append(
                f"latency: bucket {bucket} canary mean "
                f"{rec['canary_mean_s'] * 1e3:.1f}ms > limit "
                f"{limit * 1e3:.1f}ms (live "
                f"{rec['live_mean_s'] * 1e3:.1f}ms over {rec['n']})"
            )
    unc = stats.get("uncertainty") or {}
    if (
        gates.max_unc_ratio is not None
        and unc.get("live_mean") is not None
        and unc.get("canary_mean") is not None
        and unc.get("live_n", 0) >= gates.min_bucket_samples
        and unc.get("canary_n", 0) >= gates.min_bucket_samples
    ):
        # the 1e-12 floor keeps a zero-variance live baseline (models
        # without dropout) from turning ANY canary noise into a reject
        limit = max(unc["live_mean"], 1e-12) * gates.max_unc_ratio
        if unc["canary_mean"] > limit:
            failures.append(
                f"uncertainty: canary mean {unc['canary_mean']:.3e} > "
                f"limit {limit:.3e} (live {unc['live_mean']:.3e}, "
                f"ratio tol {gates.max_unc_ratio})"
            )
    if failures:
        return {
            "verdict": "reject",
            "reason": "; ".join(failures),
            "failures": failures,
        }
    return {"verdict": "promote", "reason": "all gates passed"}


class _SubprocessCanary:
    """Default canary replica: the fleet CLI re-entered with
    ``HYDRAGNN_FLEET_CANARY=1`` against a candidate-specific spec."""

    def __init__(self, spec_path: str, coord_dir: str, canary_id: int,
                 incarnation: int, heartbeat_s: float):
        env = dict(os.environ)
        env.update(
            HYDRAGNN_FLEET_DIR=coord_dir,
            HYDRAGNN_FLEET_REPLICA=str(canary_id),
            HYDRAGNN_FLEET_GEN=str(incarnation),
            HYDRAGNN_FLEET_HEARTBEAT_S=str(heartbeat_s),
            HYDRAGNN_FLEET_CANARY="1",
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "hydragnn_tpu_torch.serve.fleet",
             "--spec", spec_path],
            env=env,
        )

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


class CanaryController:
    """Consume published candidates, shadow-evaluate each on a dedicated
    canary replica, and promote (the fleet's all-acked hot-swap) or
    reject loudly.

    ``fleet`` needs the supervisor surface only (duck-typed so tests
    can stub the swap): ``coord_dir``, ``lease_s``, ``emit(event,
    **fields)`` and ``promote(checkpoint, path, arch_config=, name=,
    timeout=)``. ``channel`` is a :class:`CandidateChannel` or its root
    path. ``spec_path`` (default ``fleet.spec_path``) supplies the
    arch/plan/samples the canary replica boots with and the bucket plan
    the latency gate classifies by.

    ``replica_factory(spec_path, canary_id, incarnation)`` overrides
    the subprocess default with anything exposing ``alive()``/``stop()``
    — the controller discovers serving state and port uniformly from
    the canary's OWN lease file, so in-process test replicas need no
    extra plumbing.
    """

    def __init__(
        self,
        fleet,
        channel,
        spec_path: Optional[str] = None,
        *,
        fraction: float = 0.25,
        gates: Optional[CanaryGates] = None,
        queue_capacity: int = 64,
        poll_s: float = 0.1,
        boot_timeout_s: float = 180.0,
        promote_timeout_s: float = 120.0,
        shadow_deadline_s: float = 30.0,
        keep_last: Optional[int] = None,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
        replica_factory: Optional[Callable] = None,
    ):
        self.fleet = fleet
        self.coord_dir = fleet.coord_dir
        self.lease_s = float(getattr(fleet, "lease_s", DEFAULT_LEASE_S))
        self.channel = (
            channel if isinstance(channel, CandidateChannel)
            else CandidateChannel(channel)
        )
        self.spec_path = spec_path or getattr(fleet, "spec_path", None)
        if self.spec_path is None:
            raise ValueError("need spec_path (or a fleet that carries one)")
        with open(self.spec_path) as f:
            self._spec = json.load(f)
        fraction = float(
            os.getenv("HYDRAGNN_CANARY_FRACTION", str(fraction))
        )
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = fraction
        self._stride = max(1, int(round(1.0 / fraction)))
        self.gates = gates or CanaryGates.from_env()
        self.poll_s = float(poll_s)
        self.boot_timeout_s = float(boot_timeout_s)
        self.promote_timeout_s = float(promote_timeout_s)
        self.shadow_deadline_s = float(shadow_deadline_s)
        self.keep_last = (
            keep_last if keep_last is not None
            else int(os.getenv("HYDRAGNN_CANARY_KEEP_LAST", "0")) or None
        )
        self.heartbeat_s = float(heartbeat_s)
        self._factory = replica_factory or self._spawn_subprocess
        self.metrics = CanaryMetrics()
        self.decisions: List[Dict] = []  # terminal verdicts, oldest first
        self._plan = None  # lazy: the latency gate's bucket classifier
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_capacity))
        self._stop = threading.Event()
        self._armed = threading.Event()  # tap mirrors only while set
        self._tap_lock = threading.Lock()
        self._tap_n = 0
        self._deg_lock = threading.Lock()
        self._deg_cached = False
        self._deg_ts = float("-inf")
        self._lock = threading.Lock()  # guards candidate state below
        self._last_seq = max(self.channel.pinned(), default=0)
        self._cand: Optional[Dict] = None  # manifest under evaluation
        self._handle = None
        self._canary_id = 0
        self._incarnation = 0
        self._crashes = 0
        self._port: Optional[int] = None
        self._armed_ts = 0.0
        self._published_ts = 0.0
        self._boot_ts = 0.0
        self._stats = _CandidateStats()
        self._spec_cand_path = self.spec_path
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "CanaryController":
        self._stop.clear()
        loop = threading.Thread(
            target=self._loop, name="hydragnn-canary-loop", daemon=True
        )
        worker = threading.Thread(
            target=self._shadow_worker, name="hydragnn-canary-shadow",
            daemon=True,
        )
        self._threads = [loop, worker]
        loop.start()
        worker.start()
        return self

    def stop(self):
        self._armed.clear()
        self._stop.set()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=max(self.poll_s * 20, 10.0))
        self._threads = []
        self._teardown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def attach(self, router) -> None:
        """Install the shadow tap on a :class:`FleetRouter`."""
        router.set_shadow(self.shadow_tap)

    def status(self) -> Dict:
        with self._lock:
            cand = self._cand
            return {
                "evaluating": cand is not None,
                "seq": None if cand is None else cand["seq"],
                "crashes": self._crashes,
                "last_seq": self._last_seq,
                "samples":
                    0 if cand is None else self._stats.snapshot()["samples"],
            }

    def wait_decision(self, seq: int, timeout: float = 300.0) -> Dict:
        """Block until the candidate at ``seq`` reached a terminal
        verdict; returns its decision record (test/bench helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                for d in self.decisions:
                    if d["seq"] == seq:
                        return d
            time.sleep(self.poll_s)
        raise TimeoutError(f"no canary decision for seq {seq} in {timeout}s")

    # -- shadow tap (router threads) -----------------------------------------
    def shadow_tap(self, graph, body: Dict, latency_s: float) -> None:
        """The router's success-path hook: enqueue-or-drop, never block.
        Sheds (counted) whenever the fleet is degraded — shadow work is
        the FIRST load shed, before any priority lane — or the bounded
        queue is full; samples 1/stride of eligible responses."""
        if not self._armed.is_set():
            return
        with self._tap_lock:
            n = self._tap_n
            self._tap_n += 1
        if n % self._stride:
            return
        if self._degraded_now():
            self.metrics.registry.inc("shadow_shed_total")
            return
        try:
            self._q.put_nowait((
                graph, body.get("heads"), float(latency_s),
                body.get("uncertainty"),
            ))
        except queue.Full:
            self.metrics.registry.inc("shadow_shed_total")
            return
        self.metrics.registry.set(
            "shadow_queue_depth", float(self._q.qsize())
        )

    def _degraded_now(self) -> bool:
        now = time.time()
        with self._deg_lock:
            if now - self._deg_ts <= self.heartbeat_s:
                return self._deg_cached
        status = coord.read_json(
            os.path.join(self.coord_dir, "fleet.json")
        )
        degraded = bool(status and status.get("degraded"))
        with self._deg_lock:
            self._deg_cached, self._deg_ts = degraded, now
        return degraded

    # -- canary replica management -------------------------------------------
    def _spawn_subprocess(self, spec_path: str, canary_id: int,
                          incarnation: int):
        return _SubprocessCanary(
            spec_path, self.coord_dir, canary_id, incarnation,
            self.heartbeat_s,
        )

    def _lease(self) -> Optional[Dict]:
        lease = coord.read_json(
            coord.hb_path(
                self.coord_dir, CANARY, self._canary_id, prefix=CANARY
            )
        )
        if lease is None:
            return None
        if int(lease.get("gen", -1)) != self._incarnation:
            return None  # a previous incarnation's (or candidate's) lease
        return lease

    def _candidate_spec(self, manifest: Dict) -> str:
        """The fleet spec with the checkpoint swapped for the candidate
        snapshot — what the canary replica boots (and warms) from."""
        spec = dict(self._spec)
        spec["checkpoint"] = {
            "name": manifest["checkpoint"],
            "path": manifest["path"],
        }
        path = os.path.join(
            self.coord_dir, "canary", f"spec-{int(manifest['seq']):06d}.json"
        )
        coord.write_json(path, spec)
        return path

    def _begin(self, manifest: Dict):
        seq = int(manifest["seq"])
        spec_path = self._candidate_spec(manifest)
        with self._lock:
            self._cand = manifest
            # unique member id per candidate: lease files never collide
            # across evaluations, and a stale previous canary's lease can
            # never read as this one's
            self._canary_id = seq
            self._incarnation = 0
            self._crashes = 0
            self._port = None
            self._stats = _CandidateStats()
            self._spec_cand_path = spec_path
            self._published_ts = float(manifest.get("ts", time.time()))
            self._boot_ts = time.monotonic()
        self.metrics.registry.set("evaluating", 1.0)
        self.metrics.registry.set("candidate_seq", float(seq))
        self.fleet.emit(
            "canary_started", candidate=seq,
            checkpoint=manifest["checkpoint"], fraction=self.fraction,
        )
        self._handle = self._factory(spec_path, seq, 0)

    def _respawn(self):
        with self._lock:
            self._incarnation += 1
            inc = self._incarnation
            self._port = None
            # a fresh incarnation gets fresh evidence: samples compared
            # against a torn predecessor must not leak into its gates
            self._stats = _CandidateStats()
            self._boot_ts = time.monotonic()
            spec_path = self._spec_cand_path
            seq = self._canary_id
        self._armed.clear()
        self._handle = self._factory(spec_path, seq, inc)

    def _teardown(self):
        self._armed.clear()
        handle, self._handle = self._handle, None
        if handle is not None:
            try:
                handle.stop()
            except Exception:
                pass
        with self._lock:
            self._cand = None
            self._port = None
        # drain mirrored-but-unreplayed requests: they belong to the
        # torn-down candidate
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self.metrics.registry.set("evaluating", 0.0)
        self.metrics.registry.set("shadow_queue_depth", 0.0)

    # -- supervision + decision loop -----------------------------------------
    def _loop(self):
        while not self._stop.wait(self.poll_s):
            try:
                self._tick()
            except Exception:
                pass  # supervision must outlive any single bad read

    def _tick(self):
        with self._lock:
            cand = self._cand
        if cand is None:
            pending = self.channel.pending(self._last_seq)
            if not pending:
                return
            # newest pending wins: older unevaluated candidates are
            # already stale training states — reject them loudly rather
            # than spend shadow budget proving yesterday's checkpoint
            for stale in pending[:-1]:
                self._record(
                    stale, "rejected",
                    f"superseded by seq {pending[-1]['seq']}",
                    samples=0,
                )
            self._begin(pending[-1])
            return
        handle = self._handle
        alive = handle is not None and handle.alive()
        lease = self._lease()
        serving = lease_serving(lease, self.lease_s) and lease.get("port")
        if serving and not self._armed.is_set():
            with self._lock:
                self._port = int(lease["port"])
                self._armed_ts = time.monotonic()
            self._armed.set()
        if not alive or (
            self._armed.is_set() and not serving
        ):
            # dead process, or a wedged one whose lease went stale
            self._armed.clear()
            if handle is not None:
                try:
                    handle.stop()
                except Exception:
                    pass
            self.metrics.registry.inc("crashes_total")
            with self._lock:
                self._crashes += 1
                crashes = self._crashes
            if crashes > self.gates.max_crashes:
                self._reject(
                    cand,
                    f"crash_loop: candidate died {crashes} time(s) "
                    f"(respawn budget {self.gates.max_crashes})",
                )
            else:
                self._respawn()
            return
        if not self._armed.is_set():
            if time.monotonic() - self._boot_ts > self.boot_timeout_s:
                self._reject(
                    cand,
                    f"crash_loop: candidate never reached serving within "
                    f"{self.boot_timeout_s:.0f}s",
                )
            return
        stats = self._stats.snapshot()
        self._export_gauges(stats)
        decision = evaluate_gates(stats, self.gates)
        if decision["verdict"] == "promote":
            self._promote(cand, stats)
        elif decision["verdict"] == "reject":
            self._reject(cand, decision["reason"],
                         samples=stats["samples"],
                         nan_origins=stats.get("nan_origins") or [])
        elif (
            time.monotonic() - self._armed_ts > self.gates.decide_timeout_s
        ):
            self._reject(
                cand,
                f"insufficient_samples: {stats['samples']}/"
                f"{self.gates.min_samples} within "
                f"{self.gates.decide_timeout_s:.0f}s — unproven candidates "
                "are never promoted",
                samples=stats["samples"],
            )

    def _export_gauges(self, stats: Dict):
        for head, mae in stats["head_mae"].items():
            self.metrics.registry.set_labeled(
                "head_mae", round(mae, 9), head=str(head)
            )
        for bucket, rec in stats["buckets"].items():
            ratio = rec["canary_mean_s"] / max(rec["live_mean_s"], 1e-9)
            self.metrics.registry.set_labeled(
                "latency_ratio", round(ratio, 4), bucket=str(bucket)
            )

    def _record(self, manifest: Dict, verdict: str, reason: Optional[str],
                samples: int, **extra) -> Dict:
        seq = int(manifest["seq"])
        decision = {
            "seq": seq,
            "checkpoint": manifest["checkpoint"],
            "verdict": verdict,
            "reason": reason,
            "samples": samples,
            "gate_latency_s": round(
                max(time.time() - float(manifest.get("ts", time.time())),
                    0.0), 3,
            ),
        }
        decision.update(extra)
        with self._lock:
            self.decisions.append(decision)
            self._last_seq = max(self._last_seq, seq)
        if verdict == "rejected":
            self.metrics.registry.inc("rejects_total")
            if reason and reason.startswith("nan_outputs"):
                self.metrics.registry.inc("nan_vetoes_total")
                # every NaN veto carries its origin into the event
                # stream: WHICH head went non-finite, not just a count
                for origin in decision.get("nan_origins") or []:
                    self.fleet.emit(
                        "nan_origin",
                        **{**origin, "scope": f"canary:{seq}"},
                    )
            self.fleet.emit(
                "canary_rejected", candidate=seq,
                checkpoint=manifest["checkpoint"], reason=reason,
                samples=samples,
            )
        else:
            self.metrics.registry.inc("promotes_total")
            self.fleet.emit(
                "canary_promoted", candidate=seq,
                checkpoint=manifest["checkpoint"], samples=samples,
                **{k: v for k, v in extra.items() if k == "version"},
            )
        return decision

    def _reject(self, manifest: Dict, reason: str, samples: int = 0,
                **extra):
        self._record(manifest, "rejected", reason, samples, **extra)
        self._teardown()

    def _promote(self, manifest: Dict, stats: Dict):
        # disarm BEFORE the swap: mirrored traffic compared across the
        # version flip would read as disagreement
        self._armed.clear()
        res = self.fleet.promote(
            manifest["checkpoint"],
            path=manifest["path"],
            arch_config=self._spec.get("arch"),
            # a multi-tenant channel can target any packed model: the
            # candidate manifest's model_name wins over the spec default
            name=manifest.get("model_name") or self._spec.get("model_name"),
            timeout=self.promote_timeout_s,
        )
        if res.get("status") == "promoted":
            versions = res.get("versions") or {}
            self._record(
                manifest, "promoted", None, samples=stats["samples"],
                version=max(versions.values()) if versions else None,
            )
            self.channel.record_promotion(manifest["seq"])
            if self.keep_last:
                self.channel.gc(self.keep_last)
        else:
            # the mechanical gate failed AFTER the quality gates passed
            # (a replica's strict load refused the snapshot, ack
            # timeout...): the fleet already rolled back loudly; the
            # canary verdict is still a rejection with the cause chained
            self._record(
                manifest, "rejected",
                f"hot_swap_rolled_back: {res.get('reason', 'unknown')}",
                samples=stats["samples"],
            )
        self._teardown()

    # -- shadow worker -------------------------------------------------------
    def _shadow_worker(self):
        while not self._stop.is_set():
            try:
                graph, live_heads, live_latency, live_unc = self._q.get(
                    timeout=0.1
                )
            except queue.Empty:
                continue
            self.metrics.registry.set(
                "shadow_queue_depth", float(self._q.qsize())
            )
            if not self._armed.is_set() or live_heads is None:
                continue  # torn-down mid-flight, or a raw-less response
            with self._lock:
                port = self._port
            if port is None:
                continue
            t0 = time.monotonic()
            try:
                status, body = self._post(port, graph)
            except (urllib.error.URLError, ConnectionError, OSError,
                    TimeoutError):
                # transport-level failure: the canary just died (or is
                # being respawned) — the supervision tick owns process
                # death, so this is a dropped sample, not an error veto
                continue
            canary_latency = time.monotonic() - t0
            if status != 200:
                self._stats.add_error()
                self.metrics.registry.inc("shadow_errors_total")
                continue
            try:
                canary_heads = [
                    np.asarray(h, np.float64) for h in body["heads"]
                ]
                live_arrs = [
                    np.asarray(h, np.float64) for h in live_heads
                ]
                bucket = self._bucket_of(graph)
            except Exception:
                self._stats.add_error()
                self.metrics.registry.inc("shadow_errors_total")
                continue
            ok = self._stats.add_sample(
                live_arrs, canary_heads, bucket, live_latency,
                canary_latency, live_unc=live_unc,
                canary_unc=body.get("uncertainty"),
            )
            if ok:
                self.metrics.registry.inc("shadow_samples_total")

    def _post(self, port: int, graph):
        data = json.dumps(
            {"graph": encode_graph(graph),
             "deadline_s": self.shadow_deadline_s}
        ).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=data,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(
            req, timeout=self.shadow_deadline_s + 5.0
        ) as resp:
            return resp.status, json.loads(resp.read() or b"{}")

    def _bucket_of(self, graph) -> int:
        if self._plan is None:
            from hydragnn_tpu_torch.data.serialized import SafeUnpickler
            from hydragnn_tpu_torch.serve.buckets import plan_from_samples

            with open(self._spec["samples"], "rb") as f:
                samples = SafeUnpickler(f).load()
            self._plan = plan_from_samples(
                samples, **dict(self._spec.get("plan", {}))
            )
        return int(self._plan.admit(graph)[0])
