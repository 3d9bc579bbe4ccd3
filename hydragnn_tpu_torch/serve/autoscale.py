"""SLO-driven predictive autoscaling for the serving fleet (port of the
JAX package's ``serve/autoscale.py``; host arithmetic only).

Reactive scaling (grow when the SLO is already burning) pays a replica's
boot (process spawn, CUDA context, checkpoint load, one capture per
bucket) in user-visible misses. :class:`FleetAutoscaler` scales a
:class:`~hydragnn_tpu_torch.serve.fleet.ServingFleet` from two signals so
that capacity usually arrives first:

- **SLO pressure (the reactive floor)**: the router's deadline ledger
  (``slo_miss_ratio`` over the last tick's window) and admission sheds: a
  window over the miss budget, or any shed, grows at least one replica.
- **Short-horizon forecast**: an EWMA of the request rate blended with a
  diurnal profile (:class:`LoadForecast`: each of ``n_phases`` phases of
  ``period_s`` keeps its own EWMA, read one phase ahead). Desired capacity
  is ``ceil(forecast * headroom / capacity_rps)``.

Hysteresis keeps it from fighting the supervisor's healing: separate up
and down cooldowns (down much longer), no scale-down while the fleet is
degraded (a dead replica is the monitor's to respawn), hard min/max
clamps. The knobs are ``HYDRAGNN_AUTOSCALE_*`` (:meth:`AutoscalePolicy.from_env`);
every action lands in the event stream as ``fleet_scaled`` through
:meth:`ServingFleet.resize`.
"""

import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.utils.envparse import env_float, env_int


class AutoscalePolicy:
    """Bounds + hysteresis + forecast shape for one autoscaler."""

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 8,
        capacity_rps: float = 50.0,
        slo_budget: float = 0.05,
        up_cooldown_s: float = 10.0,
        down_cooldown_s: float = 60.0,
        ewma_alpha: float = 0.3,
        period_s: float = 86400.0,
        n_phases: int = 24,
        headroom: float = 1.2,
    ):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if capacity_rps <= 0:
            raise ValueError("capacity_rps must be > 0")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if n_phases < 1:
            raise ValueError("n_phases must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.capacity_rps = float(capacity_rps)
        self.slo_budget = float(slo_budget)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.ewma_alpha = float(ewma_alpha)
        self.period_s = float(period_s)
        self.n_phases = int(n_phases)
        self.headroom = float(headroom)

    @classmethod
    def from_env(cls, **overrides) -> "AutoscalePolicy":
        """Policy from ``HYDRAGNN_AUTOSCALE_*`` knobs; explicit kwargs
        win over env, env wins over defaults."""
        kw = dict(
            min_replicas=env_int("HYDRAGNN_AUTOSCALE_MIN", 1, minimum=1),
            max_replicas=env_int("HYDRAGNN_AUTOSCALE_MAX", 8, minimum=1),
            capacity_rps=env_float(
                "HYDRAGNN_AUTOSCALE_CAPACITY_RPS", 50.0
            ),
            slo_budget=env_float("HYDRAGNN_AUTOSCALE_SLO_BUDGET", 0.05),
            up_cooldown_s=env_float(
                "HYDRAGNN_AUTOSCALE_UP_COOLDOWN_S", 10.0
            ),
            down_cooldown_s=env_float(
                "HYDRAGNN_AUTOSCALE_DOWN_COOLDOWN_S", 60.0
            ),
            period_s=env_float("HYDRAGNN_AUTOSCALE_PERIOD_S", 86400.0),
        )
        kw.update(overrides)
        return cls(**kw)


class LoadForecast:
    """EWMA + diurnal-phase request-rate forecast.

    ``observe(rps, now)`` feeds one measured window; ``forecast(now)``
    returns the expected rate for the phase ``now`` falls into — the
    max of the global EWMA (tracks the current level) and that phase's
    own EWMA from previous periods (anticipates the repeating curve).
    Phases never observed fall back to the global EWMA alone.
    """

    def __init__(self, alpha: float = 0.3, period_s: float = 86400.0,
                 n_phases: int = 24):
        self.alpha = float(alpha)
        self.period_s = float(period_s)
        self.n_phases = int(n_phases)
        self._ewma: Optional[float] = None
        self._phase_ewma: List[Optional[float]] = [None] * self.n_phases

    def _phase(self, now: float) -> int:
        return int((now % self.period_s) / self.period_s * self.n_phases
                   ) % self.n_phases

    def observe(self, rps: float, now: float):
        rps = max(float(rps), 0.0)
        self._ewma = (
            rps if self._ewma is None
            else self.alpha * rps + (1 - self.alpha) * self._ewma
        )
        p = self._phase(now)
        prev = self._phase_ewma[p]
        self._phase_ewma[p] = (
            rps if prev is None
            else self.alpha * rps + (1 - self.alpha) * prev
        )

    def forecast(self, now: float, horizon_s: float = 0.0) -> float:
        """Expected rps at ``now + horizon_s`` (default: the current
        phase). Looking one phase ahead is what buys boot time: capacity
        for the morning ramp starts spawning during the last quiet
        phase."""
        if self._ewma is None:
            return 0.0
        p = self._phase(now + horizon_s)
        phase = self._phase_ewma[p]
        return self._ewma if phase is None else max(self._ewma, phase)


class FleetAutoscaler:
    """Closed loop: signals -> forecast -> :meth:`ServingFleet.resize`.

    ``signals`` is any zero-arg callable returning CUMULATIVE counters —
    the router's ``autoscale_signals()`` is accepted as-is
    (``requests_total`` / ``shed_total`` / ``deadline_met_total`` /
    ``deadline_missed_total``), as is a nested
    ``{"slo": {"deadline_met": ..., "deadline_missed": ...}}`` shape.

    The autoscaler diffs consecutive snapshots itself, so wiring it to a
    live router is one lambda. ``tick(now)`` is public and deterministic
    (inject ``now``) — tests drive the whole loop without threads or
    sleeps; ``start()`` runs it on a timer for production.
    """

    def __init__(
        self,
        fleet,
        signals: Callable[[], Dict],
        policy: Optional[AutoscalePolicy] = None,
        interval_s: Optional[float] = None,
        forecast: Optional[LoadForecast] = None,
    ):
        self.fleet = fleet
        self.signals = signals
        self.policy = policy or AutoscalePolicy.from_env()
        self.interval_s = (
            env_float("HYDRAGNN_AUTOSCALE_INTERVAL_S", 5.0)
            if interval_s is None
            else float(interval_s)
        )
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.forecast = forecast or LoadForecast(
            alpha=self.policy.ewma_alpha,
            period_s=self.policy.period_s,
            n_phases=self.policy.n_phases,
        )
        self._prev: Optional[Dict] = None
        self._prev_ts: Optional[float] = None
        self._last_up = float("-inf")
        self._last_down = float("-inf")
        self.decisions: List[Dict] = []  # bounded audit trail
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        thread = threading.Thread(
            target=self._loop, name="hydragnn-autoscaler", daemon=True
        )
        thread.start()
        self._thread = thread
        return self

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            thread.join(timeout=max(self.interval_s * 2, 5.0))

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass  # scaling must outlive any single bad snapshot

    # -- the control loop ----------------------------------------------------
    @staticmethod
    def _counters(snap: Dict) -> Dict[str, float]:
        slo = snap.get("slo") or {}
        return {
            "requests": float(snap.get("requests_total", 0)),
            "shed": float(snap.get("shed_total", 0)),
            "met": float(
                slo.get("deadline_met", snap.get("deadline_met_total", 0))
            ),
            "missed": float(
                slo.get("deadline_missed",
                        snap.get("deadline_missed_total", 0))
            ),
        }

    def _fleet_degraded(self) -> bool:
        status = coord.read_json(
            os.path.join(self.fleet.coord_dir, "fleet.json")
        )
        return bool(status and status.get("degraded"))

    def tick(self, now: Optional[float] = None) -> Optional[Dict]:
        """One control step; returns the decision record (None on the
        priming tick, which only seeds the counter baseline)."""
        now = time.time() if now is None else now
        cur = self._counters(self.signals())
        prev, self._prev = self._prev, cur
        prev_ts, self._prev_ts = self._prev_ts, now
        if prev is None or prev_ts is None or now <= prev_ts:
            return None
        window = now - prev_ts
        d = {k: max(cur[k] - prev[k], 0.0) for k in cur}
        rps = d["requests"] / window
        self.forecast.observe(rps, now)
        outcomes = d["met"] + d["missed"]
        miss_ratio = d["missed"] / outcomes if outcomes else 0.0
        slo_pressure = (
            miss_ratio > self.policy.slo_budget or d["shed"] > 0
        )
        # predictive demand: next-phase forecast, with headroom so the
        # fleet does not run at exactly 100% of estimated capacity
        phase_s = self.policy.period_s / self.policy.n_phases
        want_rps = self.forecast.forecast(now, horizon_s=phase_s)
        desired = math.ceil(
            (want_rps * self.policy.headroom) / self.policy.capacity_rps
        )
        current = int(self.fleet.target)
        reason = "forecast"
        if slo_pressure:
            # the reactive floor: the SLO is burning NOW, grow at least
            # one replica whatever the forecast believes
            desired = max(desired, current + 1)
            reason = "slo_pressure"
        desired = min(
            max(desired, self.policy.min_replicas),
            self.policy.max_replicas,
        )
        applied = current
        if desired > current:
            if now - self._last_up >= self.policy.up_cooldown_s:
                applied = self.fleet.resize(desired, reason=reason)
                self._last_up = now
        elif desired < current:
            if (
                now - self._last_down >= self.policy.down_cooldown_s
                and now - self._last_up >= self.policy.down_cooldown_s
                and not self._fleet_degraded()
            ):
                # shrink only from a HEALTHY fleet, long after the last
                # grow: a live dip is the monitor's to heal, and a fresh
                # spike may return before the down-cooldown expires
                applied = self.fleet.resize(desired, reason="scale_down")
                self._last_down = now
        decision = {
            "ts": now,
            "rps": round(rps, 3),
            "forecast_rps": round(want_rps, 3),
            "miss_ratio": round(miss_ratio, 6),
            "shed": d["shed"],
            "desired": desired,
            "applied": applied,
            "reason": reason,
        }
        self.decisions.append(decision)
        del self.decisions[:-200]
        return decision
