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
"""

from hydragnn_tpu_torch.serve.buckets import (
    BucketCapacity,
    GraphTooLarge,
    ServingBucketPlan,
    plan_from_samples,
)
from hydragnn_tpu_torch.serve.cache import ResponseCache, canonical_graph_key
from hydragnn_tpu_torch.serve.costs import CostLedger, merge_bills, price_per_million
from hydragnn_tpu_torch.serve.http import ObservabilityServer
from hydragnn_tpu_torch.serve.metrics import LatencyHistogram, MetricsRegistry, ServeMetrics
from hydragnn_tpu_torch.serve.quality import FeedbackSink, UncertaintyScorer
from hydragnn_tpu_torch.serve.registry import (
    CandidateChannel,
    ModelEntry,
    ModelRegistry,
    publish_candidate,
)
from hydragnn_tpu_torch.serve.server import (
    DeadlineExceeded,
    InferenceServer,
    ServeFuture,
    ServerOverloaded,
)
from hydragnn_tpu_torch.serve.tenants import TenantManager, TenantOverQuota, TenantSpec

__all__ = [
    "BucketCapacity",
    "CandidateChannel",
    "CostLedger",
    "DeadlineExceeded",
    "FeedbackSink",
    "GraphTooLarge",
    "InferenceServer",
    "LatencyHistogram",
    "MetricsRegistry",
    "ModelEntry",
    "ModelRegistry",
    "ObservabilityServer",
    "ResponseCache",
    "ServeFuture",
    "ServeMetrics",
    "ServerOverloaded",
    "ServingBucketPlan",
    "TenantManager",
    "TenantOverQuota",
    "TenantSpec",
    "UncertaintyScorer",
    "canonical_graph_key",
    "merge_bills",
    "plan_from_samples",
    "price_per_million",
    "publish_candidate",
]
