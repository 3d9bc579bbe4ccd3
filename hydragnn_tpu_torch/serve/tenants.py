"""Tenant multiplexing: models packed in device memory, quotas, fair
scheduling (port of the JAX package's ``serve/tenants.py``).

One server serves many tenants: each tenant maps to one registered model
name, and all of them live on the card at once, as entries of one
:class:`~hydragnn_tpu_torch.serve.registry.ModelRegistry` behind one
bucket plan; every tenant's model is captured per bucket at warmup like
any other registered model.

Isolation is two mechanisms, both owned by :class:`TenantManager`:

- **Admission quotas**: each tenant holds at most ``quota`` requests in
  flight (queued and packed) per server. The check happens at ``submit()``
  before the shared queue: a flooding tenant is shed with
  :class:`TenantOverQuota` (a :class:`ServerOverloaded` carrying the
  tenant's name) while the other tenants' path to the queue stays clear.
- **Deficit-weighted round robin** (DWRR): when several tenants have
  groups due, the batcher flushes them in DWRR order. Every round credits
  each backlogged tenant ``weight * quantum``, the largest credit
  dispatches first, and served requests debit it; an idle tenant's credit
  resets.

A spec may point a tenant at a checkpoint directory or at a
:class:`~hydragnn_tpu_torch.serve.registry.CandidateChannel` root, whose
pinned active version (``promoted.json``) is then loaded.
"""

import threading
from typing import Dict, List, Optional, Tuple

from hydragnn_tpu_torch.serve.server import ServerOverloaded
from hydragnn_tpu_torch.utils.envparse import env_int

DEFAULT_QUOTA = 64
DEFAULT_QUANTUM = 4


class TenantOverQuota(ServerOverloaded):
    """One tenant's admission quota is exhausted — sheds THAT tenant
    only. Subclasses :class:`ServerOverloaded`, so every caller that
    handles a full queue handles it unchanged; the ``tenant`` attribute
    names the offender."""

    def __init__(self, tenant: str, quota: int, retry_after_s: float):
        super().__init__(retry_after_s=retry_after_s)
        self.tenant = tenant
        self.quota = quota

    def __str__(self):
        return (
            f"tenant {self.tenant!r} quota ({self.quota} in flight) "
            f"exhausted; retry after {self.retry_after_s:.3f}s"
        )


class TenantSpec:
    """Static config of one tenant (validated eagerly — a typo'd spec
    must fail at registration, not at first request)."""

    def __init__(
        self,
        name: str,
        model: str,
        quota: Optional[int] = None,
        weight: float = 1.0,
        checkpoint: Optional[Dict] = None,
        channel: Optional[str] = None,
    ):
        if not name:
            raise ValueError("tenant name must be non-empty")
        if not model:
            raise ValueError(f"tenant {name!r} needs a model name")
        if quota is not None and int(quota) < 1:
            raise ValueError(f"tenant {name!r} quota must be >= 1")
        if not float(weight) > 0:
            raise ValueError(f"tenant {name!r} weight must be > 0")
        self.name = name
        self.model = model
        self.quota = None if quota is None else int(quota)
        self.weight = float(weight)
        self.checkpoint = checkpoint  # {"name": ..., "path": ..., "arch"?}
        self.channel = channel  # CandidateChannel root (pinned load)

    @classmethod
    def from_dict(cls, d: Dict) -> "TenantSpec":
        return cls(
            name=d.get("name", ""),
            model=d.get("model") or d.get("name", ""),
            quota=d.get("quota"),
            weight=d.get("weight", 1.0),
            checkpoint=d.get("checkpoint"),
            channel=d.get("channel"),
        )


class TenantManager:
    """Tenant registry + admission quotas + DWRR flush scheduling.

    One instance per :class:`~hydragnn_tpu_torch.serve.server.InferenceServer`
    (in-flight counts are per-server state); the specs are shared
    configuration, so ``from_specs`` on each replica builds identical
    managers."""

    def __init__(
        self,
        specs: Optional[List[TenantSpec]] = None,
        default_quota: Optional[int] = None,
        quantum: Optional[int] = None,
    ):
        self.default_quota = (
            env_int("HYDRAGNN_TENANT_DEFAULT_QUOTA", DEFAULT_QUOTA,
                    minimum=1)
            if default_quota is None
            else int(default_quota)
        )
        self.quantum = (
            env_int("HYDRAGNN_TENANT_QUANTUM", DEFAULT_QUANTUM, minimum=1)
            if quantum is None
            else int(quantum)
        )
        if self.default_quota < 1:
            raise ValueError("default_quota must be >= 1")
        if self.quantum < 1:
            raise ValueError("quantum must be >= 1")
        self._lock = threading.Lock()
        self._specs: Dict[str, TenantSpec] = {}
        self._in_flight: Dict[str, int] = {}
        self._deficit: Dict[str, float] = {}
        # cost-feedback admission overrides (serve/costs.py): a shaved
        # quota lives here, never on the spec, so clearing the override
        # restores the spec'd base exactly
        self._quota_override: Dict[str, int] = {}
        self.admitted_total: Dict[str, int] = {}
        self.shed_total: Dict[str, int] = {}
        for spec in specs or ():
            self.register(spec)

    @classmethod
    def from_specs(cls, specs: List[Dict], **kw) -> "TenantManager":
        return cls([TenantSpec.from_dict(d) for d in specs], **kw)

    # ---- registration --------------------------------------------------
    def register(self, spec: TenantSpec) -> TenantSpec:
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(f"tenant {spec.name!r} already registered")
            self._specs[spec.name] = spec
            self._in_flight[spec.name] = 0
        return spec

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._specs)

    def spec(self, tenant: str) -> TenantSpec:
        with self._lock:
            spec = self._specs.get(tenant)
        if spec is None:
            raise KeyError(
                f"unknown tenant {tenant!r}; registered: {self.names()}"
            )
        return spec

    def model_for(self, tenant: str) -> str:
        return self.spec(tenant).model

    def base_quota_for(self, tenant: str) -> int:
        """The spec'd (or default) quota, ignoring any cost-feedback
        override — what :meth:`set_quota_override` restores to."""
        spec = self.spec(tenant)
        return self.default_quota if spec.quota is None else spec.quota

    def quota_for(self, tenant: str) -> int:
        base = self.base_quota_for(tenant)  # KeyError on unknown tenant
        with self._lock:
            override = self._quota_override.get(tenant)
        return base if override is None else min(override, base)

    def set_quota_override(self, tenant: str, quota: Optional[int]):
        """Install (or with ``None`` clear) a cost-feedback admission
        override for ``tenant``. Overrides only ever SHAVE — an override
        above the base quota is clamped at read time."""
        self.spec(tenant)  # KeyError on unknown tenant
        if quota is not None and int(quota) < 1:
            raise ValueError(
                f"tenant {tenant!r} quota override must be >= 1"
            )
        with self._lock:
            if quota is None:
                self._quota_override.pop(tenant, None)
            else:
                self._quota_override[tenant] = int(quota)

    def quota_override(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._quota_override.get(tenant)

    def load_models(self, registry, device=None) -> Dict[str, int]:
        """Load every tenant's model into ``registry`` on ``device`` (the
        card unless ``"cpu"``; idempotent per name: tenants may share a
        model). Checkpoint-backed tenants load through the strict v2 path;
        channel-backed tenants load the channel's pinned active snapshot
        (the latest published one when nothing is pinned). Returns
        ``{model name: registered version}``."""
        from hydragnn_tpu_torch.serve.registry import CandidateChannel

        versions: Dict[str, int] = {}
        for name in self.names():
            spec = self.spec(name)
            if spec.model in versions or spec.model in registry.names():
                versions.setdefault(spec.model, registry.get(spec.model).version)
                continue
            if spec.channel is not None:
                channel = CandidateChannel(spec.channel)
                pinned = channel.pinned()
                seq = max(pinned) if pinned else channel.latest_seq()
                if seq <= 0:
                    raise ValueError(
                        f"tenant {name!r}: channel {spec.channel!r} has no published "
                        "candidate to load"
                    )
                man = channel.read(seq)
                entry = registry.load_checkpoint(
                    man["checkpoint"], path=channel.version_dir(seq), name=spec.model,
                    device=device,
                )
            elif spec.checkpoint is not None:
                ck = spec.checkpoint
                entry = registry.load_checkpoint(
                    ck["name"], arch_config=ck.get("arch"), path=ck.get("path", "./logs/"),
                    name=spec.model, device=device,
                )
            else:
                raise ValueError(
                    f"tenant {name!r}: model {spec.model!r} is not registered and the "
                    "spec names no checkpoint/channel"
                )
            versions[spec.model] = entry.version
        return versions

    # ---- admission -----------------------------------------------------
    def admit(self, tenant: str, retry_after_s: float = 0.005):
        """Count one request against ``tenant``'s quota or shed it with
        :class:`TenantOverQuota`. Callers MUST pair every successful
        admit with exactly one :meth:`release` (the server wires it to
        the request future's terminal resolution)."""
        quota = self.quota_for(tenant)  # KeyError on unknown tenant
        with self._lock:
            if self._in_flight[tenant] >= quota:
                self.shed_total[tenant] = self.shed_total.get(tenant, 0) + 1
                raise TenantOverQuota(
                    tenant, quota, retry_after_s=max(retry_after_s, 0.001)
                )
            self._in_flight[tenant] += 1
            self.admitted_total[tenant] = (
                self.admitted_total.get(tenant, 0) + 1
            )

    def release(self, tenant: str):
        with self._lock:
            n = self._in_flight.get(tenant, 0)
            self._in_flight[tenant] = max(n - 1, 0)

    def in_flight(self, tenant: str) -> int:
        with self._lock:
            return self._in_flight.get(tenant, 0)

    # ---- DWRR scheduling -----------------------------------------------
    def flush_order(self, backlog: Dict[Optional[str], int],
                    ) -> List[Optional[str]]:
        """Order tenants with due groups for this flush round.

        Deficit-weighted round robin: each backlogged tenant is credited
        ``weight * quantum``, the order is descending credit (ties
        broken by name for determinism), and :meth:`on_served` debits
        what actually dispatched. Tenants absent from the backlog have
        their deficit reset (classic DRR — credit must not accrue while
        idle). ``None`` (untenanted traffic) schedules with weight 1."""
        with self._lock:
            for t in list(self._deficit):
                if t not in backlog:
                    self._deficit.pop(t)
            for t in backlog:
                w = 1.0
                if t is not None and t in self._specs:
                    w = self._specs[t].weight
                self._deficit[t] = self._deficit.get(t, 0.0) + (
                    w * self.quantum
                )
            return sorted(
                backlog,
                key=lambda t: (-self._deficit.get(t, 0.0), t or ""),
            )

    def on_served(self, tenant: Optional[str], n: int):
        with self._lock:
            if tenant in self._deficit:
                self._deficit[tenant] = max(
                    self._deficit[tenant] - float(n), 0.0
                )

    # ---- introspection -------------------------------------------------
    def describe(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                name: {
                    "model": spec.model,
                    "quota": min(
                        self._quota_override.get(name, 1 << 30),
                        self.default_quota
                        if spec.quota is None
                        else spec.quota,
                    ),
                    "quota_override": self._quota_override.get(name),
                    "weight": spec.weight,
                    "in_flight": self._in_flight.get(name, 0),
                    "admitted": self.admitted_total.get(name, 0),
                    "shed": self.shed_total.get(name, 0),
                }
                for name, spec in self._specs.items()
            }
