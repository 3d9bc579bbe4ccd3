"""Per-tenant cost attribution: device time, FLOPs, quota feedback (port
of the JAX package's ``serve/costs.py``).

- **Attribution is per dispatched batch**: micro-batches never mix
  tenants (the batcher groups on ``(tenant, model, version, bucket)``),
  so a batch's time and FLOPs belong to one tenant.
  :meth:`CostLedger.note_batch` is called once per dispatch from the
  batcher thread. ``batch_seconds`` is the JAX package's: host wall time
  from packing to readback. ``flops`` is the bucket's per-dispatch count,
  which the port's server takes once per (model version, bucket) from
  ``torch.utils.flop_counter.FlopCounterMode`` over the eager warm-up of
  the captured forward (the JAX package reads XLA's ``cost_analysis``).
  FlopCounterMode counts the matrix products only: the hand-written
  kernels K1-K7 add 0, and so does the elementwise work XLA counts.
- **Replica-seconds close the books**: :meth:`CostLedger.bill` reports
  per-tenant device seconds plus an ``idle_s`` residual, so that the rows
  sum to the integrated replica-seconds.
- **Cost feedback into quotas** (``HYDRAGNN_TENANT_COST_QUOTAS=1``): each
  cost window, every tenant's share of the window's device time is held
  against its weight-proportional share; a tenant over it for ``patience``
  windows has its admission quota shaved (floored), and a
  ``quota_adjusted`` event records it; a tenant under it gets its base
  quota back.

Exported gauge families (``hydragnn_tenant_cost_*``): per-tenant device
seconds, FLOPs and requests, and the replica-seconds and idle-seconds
totals.
"""

import math
import threading
import time
from typing import Callable, Dict, List, Optional

from hydragnn_tpu_torch.obs.metrics import MetricsRegistry
from hydragnn_tpu_torch.utils.envparse import env_flag, env_float, env_int

# bill row for device time consumed by requests carrying no tenant
UNTENANTED = "(untenanted)"


def feedback_enabled() -> bool:
    """Cost->quota feedback armed? (``HYDRAGNN_TENANT_COST_QUOTAS=1``)"""
    return env_flag("HYDRAGNN_TENANT_COST_QUOTAS")


class CostLedger:
    """Per-replica tenant cost accounting + quota feedback loop.

    One instance per :class:`~hydragnn_tpu_torch.serve.server.InferenceServer`
    (batch attribution is per-process state). ``emit`` is a schema-gated
    event emitter for ``quota_adjusted`` records; ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, emit: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.emit = emit
        self._clock = clock
        self._start = clock()
        self._lock = threading.Lock()
        self._device_s: Dict[str, float] = {}
        self._flops: Dict[str, float] = {}
        self._requests: Dict[str, int] = {}
        self._batches: Dict[str, int] = {}
        # feedback knobs (env-validated once, at construction)
        self.feedback = feedback_enabled()
        self.window_s = env_float(
            "HYDRAGNN_TENANT_COST_WINDOW_S", 1.0, minimum=0.01
        )
        self.patience = env_int(
            "HYDRAGNN_TENANT_COST_PATIENCE", 2, minimum=1
        )
        self.shave = env_float(
            "HYDRAGNN_TENANT_COST_SHAVE", 0.5, minimum=0.01
        )
        self.floor_fraction = env_float(
            "HYDRAGNN_TENANT_COST_FLOOR", 0.125, minimum=0.0
        )
        self.tolerance = env_float(
            "HYDRAGNN_TENANT_COST_TOLERANCE", 1.25, minimum=1.0
        )
        self._window_start = clock()
        self._window_device: Dict[str, float] = {}
        self._over_streak: Dict[str, int] = {}
        self._under_streak: Dict[str, int] = {}
        self.metrics = MetricsRegistry("hydragnn")
        self.metrics.labeled_gauge(
            "tenant_cost_device_seconds",
            "Device wall-time attributed to this tenant's batches",
        )
        self.metrics.labeled_gauge(
            "tenant_cost_flops",
            "Compiled FLOPs attributed to this tenant's batches",
        )
        self.metrics.labeled_gauge(
            "tenant_cost_requests",
            "Requests dispatched for this tenant",
        )
        self.metrics.gauge(
            "tenant_cost_replica_seconds",
            "Integrated replica lifetime this ledger has billed over",
        )
        self.metrics.gauge(
            "tenant_cost_idle_seconds",
            "Replica-seconds attributed to no tenant (idle residual)",
        )
        self.metrics.counter(
            "tenant_quota_adjustments_total",
            "Cost-feedback quota changes (shaves + restores)",
        )

    # ---- attribution ---------------------------------------------------
    def note_batch(self, tenant: Optional[str], bucket: int,
                   n_requests: int, batch_seconds: float,
                   flops: float = 0.0) -> None:
        """Attribute one dispatched batch (batcher thread, after the
        readback). ``flops`` is the bucket's per-dispatch matmul FLOPs (0
        when nothing counted them)."""
        key = tenant if tenant is not None else UNTENANTED
        secs = max(float(batch_seconds), 0.0)
        with self._lock:
            self._device_s[key] = self._device_s.get(key, 0.0) + secs
            self._flops[key] = self._flops.get(key, 0.0) + max(
                float(flops), 0.0
            )
            self._requests[key] = (
                self._requests.get(key, 0) + int(n_requests)
            )
            self._batches[key] = self._batches.get(key, 0) + 1
            self._window_device[key] = (
                self._window_device.get(key, 0.0) + secs
            )

    def replica_seconds(self) -> float:
        return max(self._clock() - self._start, 0.0)

    # ---- billing -------------------------------------------------------
    def bill(self) -> Dict:
        """The replica's cost statement. Per-tenant ``device_s`` rows
        plus the ``idle_s`` residual sum to ``replica_s`` by
        construction (clamped at zero if measurement skew ever puts
        busy time above the lifetime)."""
        replica_s = self.replica_seconds()
        with self._lock:
            device = dict(self._device_s)
            flops = dict(self._flops)
            requests = dict(self._requests)
            batches = dict(self._batches)
        busy = sum(device.values())
        tenants = {
            name: {
                "device_s": round(device[name], 6),
                "flops": flops.get(name, 0.0),
                "requests": requests.get(name, 0),
                "batches": batches.get(name, 0),
                "cost_share": round(
                    device[name] / busy if busy > 0 else 0.0, 6
                ),
            }
            for name in sorted(device)
        }
        out = {
            "replica_s": round(replica_s, 6),
            "busy_s": round(busy, 6),
            "idle_s": round(max(replica_s - busy, 0.0), 6),
            "tenants": tenants,
        }
        self._export_gauges(out)
        return out

    def _export_gauges(self, bill: Dict) -> None:
        self.metrics.set("tenant_cost_replica_seconds", bill["replica_s"])
        self.metrics.set("tenant_cost_idle_seconds", bill["idle_s"])
        for name, row in bill["tenants"].items():
            self.metrics.set_labeled(
                "tenant_cost_device_seconds", row["device_s"], tenant=name
            )
            self.metrics.set_labeled(
                "tenant_cost_flops", row["flops"], tenant=name
            )
            self.metrics.set_labeled(
                "tenant_cost_requests", row["requests"], tenant=name
            )

    def render_prometheus(self) -> str:
        self.bill()  # refresh the gauge families before exposition
        return self.metrics.render_prometheus()

    # ---- quota feedback ------------------------------------------------
    def maybe_adjust_quotas(self, tenants) -> List[Dict]:
        """One feedback tick: no-op until a cost window has elapsed,
        then compare every registered tenant's window cost share against
        its weight-fair share and shave/restore admission quotas.
        Called from the batcher thread after dispatch (cheap: one clock
        read between windows). Returns the adjustments made."""
        if not self.feedback or tenants is None:
            return []
        now = self._clock()
        with self._lock:
            if now - self._window_start < self.window_s:
                return []
            window = dict(self._window_device)
            self._window_device.clear()
            self._window_start = now
        busy = sum(window.values())
        if busy <= 0.0:
            return []
        names = tenants.names()
        if not names:
            return []
        weights = {n: tenants.spec(n).weight for n in names}
        wsum = sum(weights.values())
        adjustments: List[Dict] = []
        for name in names:
            share = window.get(name, 0.0) / busy
            fair = weights[name] / wsum if wsum > 0 else 0.0
            if share > fair * self.tolerance:
                self._under_streak[name] = 0
                streak = self._over_streak.get(name, 0) + 1
                self._over_streak[name] = streak
                if streak < self.patience:
                    continue
                self._over_streak[name] = 0  # re-arm the patience gate
                base = tenants.base_quota_for(name)
                current = tenants.quota_for(name)
                floor = max(
                    int(math.ceil(base * self.floor_fraction)), 1
                )
                shaved = max(floor, int(current * self.shave))
                if shaved >= current:
                    continue  # already at (or below) the floor
                tenants.set_quota_override(name, shaved)
                adjustments.append(self._emit_adjustment(
                    name, current, shaved, "over_cost", share, fair,
                ))
            else:
                self._over_streak[name] = 0
                streak = self._under_streak.get(name, 0) + 1
                self._under_streak[name] = streak
                if (
                    streak < self.patience
                    or tenants.quota_override(name) is None
                ):
                    continue
                self._under_streak[name] = 0
                current = tenants.quota_for(name)
                tenants.set_quota_override(name, None)
                adjustments.append(self._emit_adjustment(
                    name, current, tenants.quota_for(name), "restored",
                    share, fair,
                ))
        return adjustments

    def _emit_adjustment(self, tenant: str, old: int, new: int,
                         reason: str, share: float, fair: float) -> Dict:
        self.metrics.inc("tenant_quota_adjustments_total")
        rec = {
            "tenant": tenant,
            "old_quota": int(old),
            "new_quota": int(new),
            "reason": reason,
            "cost_share": round(share, 6),
            "fair_share": round(fair, 6),
        }
        if self.emit is not None:
            try:
                self.emit("quota_adjusted", **rec)
            except Exception:
                pass  # bookkeeping must never fail the dispatch path
        return rec


# ---- aggregation over replicas --------------------------------------------


def merge_bills(bills: List[Dict]) -> Dict:
    """Sum replica bills into one fleet statement (same shape as
    :meth:`CostLedger.bill`; per-tenant rows merge by name)."""
    out: Dict = {"replica_s": 0.0, "busy_s": 0.0, "idle_s": 0.0,
                 "tenants": {}}
    for bill in bills:
        if not bill:
            continue
        out["replica_s"] += float(bill.get("replica_s", 0.0))
        out["busy_s"] += float(bill.get("busy_s", 0.0))
        out["idle_s"] += float(bill.get("idle_s", 0.0))
        for name, row in (bill.get("tenants") or {}).items():
            agg = out["tenants"].setdefault(
                name,
                {"device_s": 0.0, "flops": 0.0, "requests": 0,
                 "batches": 0},
            )
            agg["device_s"] += float(row.get("device_s", 0.0))
            agg["flops"] += float(row.get("flops", 0.0))
            agg["requests"] += int(row.get("requests", 0))
            agg["batches"] += int(row.get("batches", 0))
    busy = out["busy_s"]
    for row in out["tenants"].values():
        row["cost_share"] = round(
            row["device_s"] / busy if busy > 0 else 0.0, 6
        )
        row["device_s"] = round(row["device_s"], 6)
    for k in ("replica_s", "busy_s", "idle_s"):
        out[k] = round(out[k], 6)
    return out


def price_per_million(bill: Dict, succeeded: int) -> Dict:
    """Fleet-global price of a million requests from one merged bill:
    replica-seconds per request scaled up, priced at
    ``HYDRAGNN_COST_PER_REPLICA_HOUR`` (default 1.0 currency units)."""
    rate = env_float("HYDRAGNN_COST_PER_REPLICA_HOUR", 1.0, minimum=0.0)
    replica_s = float(bill.get("replica_s", 0.0))
    per_million_s = (
        replica_s / succeeded * 1e6 if succeeded > 0 else float("inf")
    )
    return {
        "requests": int(succeeded),
        "replica_s": round(replica_s, 6),
        "replica_s_per_million": round(per_million_s, 3),
        "cost_per_replica_hour": rate,
        "cost_per_million": round(per_million_s / 3600.0 * rate, 6),
    }
