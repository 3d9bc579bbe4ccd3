"""Online inference on the card: micro-batched, bucketed predictions, with
tenants, a response cache, cost accounting, uncertainty scoring and an
observability endpoint::

    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.serve import (
        InferenceServer, ModelRegistry, plan_from_samples,
    )

    registry = ModelRegistry()
    registry.register("pna", create_model_config(arch))   # on the card
    plan = plan_from_samples(sample_graphs, max_batch_graphs=64)
    with InferenceServer(registry, plan, observability_port=0) as server:
        heads = server.predict(graph)                      # sync
        fut = server.submit(graph, deadline_s=0.1)         # async

``InferenceServer(tenants=TenantManager(...), cache=ResponseCache(),
costs=CostLedger(), scorer=UncertaintyScorer(...))`` adds the rest of the
single-replica server; ``submit(tenant=..., trace=...)``.

The serving fleet: ``ServingFleet`` supervises replica processes
(``ReplicaServer``, one ``InferenceServer`` each) through a coordination
directory, ``FleetRouter`` routes to them, ``CanaryController`` proves
published candidates on a canary replica and ``FleetAutoscaler`` resizes
the fleet (``serve/fleet.py``, ``router.py``, ``canary.py``,
``autoscale.py``)::

    with ServingFleet(coord_dir, 2, spec_path="spec.json") as fleet:
        router = FleetRouter(coord_dir)
        heads = router.route(graph, deadline_s=1.0)
        fleet.promote("candidate", path="logs/")
"""

from hydragnn_tpu_torch.serve.autoscale import AutoscalePolicy, FleetAutoscaler, LoadForecast
from hydragnn_tpu_torch.serve.buckets import (
    BucketCapacity,
    GraphTooLarge,
    ServingBucketPlan,
    plan_from_layout,
    plan_from_samples,
)
from hydragnn_tpu_torch.serve.cache import ResponseCache, canonical_graph_key
from hydragnn_tpu_torch.serve.canary import CanaryController, CanaryGates, CanaryMetrics
from hydragnn_tpu_torch.serve.costs import CostLedger, merge_bills, price_per_million
from hydragnn_tpu_torch.serve.fleet import FleetMetrics, ReplicaServer, ServingFleet
from hydragnn_tpu_torch.serve.http import ObservabilityServer
from hydragnn_tpu_torch.serve.metrics import LatencyHistogram, MetricsRegistry, ServeMetrics
from hydragnn_tpu_torch.serve.quality import FeedbackSink, UncertaintyScorer
from hydragnn_tpu_torch.serve.registry import (
    CandidateChannel,
    ModelEntry,
    ModelRegistry,
    publish_candidate,
)
from hydragnn_tpu_torch.serve.router import FleetRouter, NoLiveReplica, RetryBudget
from hydragnn_tpu_torch.serve.server import (
    DeadlineExceeded,
    InferenceServer,
    ServeFuture,
    ServerOverloaded,
)
from hydragnn_tpu_torch.serve.tenants import TenantManager, TenantOverQuota, TenantSpec

__all__ = [
    "AutoscalePolicy",
    "BucketCapacity",
    "CanaryController",
    "CanaryGates",
    "CanaryMetrics",
    "CandidateChannel",
    "CostLedger",
    "DeadlineExceeded",
    "FeedbackSink",
    "FleetAutoscaler",
    "FleetMetrics",
    "FleetRouter",
    "GraphTooLarge",
    "InferenceServer",
    "LatencyHistogram",
    "LoadForecast",
    "MetricsRegistry",
    "ModelEntry",
    "ModelRegistry",
    "NoLiveReplica",
    "ObservabilityServer",
    "ReplicaServer",
    "ResponseCache",
    "RetryBudget",
    "ServeFuture",
    "ServeMetrics",
    "ServerOverloaded",
    "ServingBucketPlan",
    "ServingFleet",
    "TenantManager",
    "TenantOverQuota",
    "TenantSpec",
    "UncertaintyScorer",
    "canonical_graph_key",
    "merge_bills",
    "plan_from_layout",
    "plan_from_samples",
    "price_per_million",
    "publish_candidate",
]
