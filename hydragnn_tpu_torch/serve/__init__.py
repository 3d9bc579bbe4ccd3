"""Online inference on the card: micro-batched, bucketed predictions::

    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.serve import (
        InferenceServer, ModelRegistry, plan_from_samples,
    )

    registry = ModelRegistry()
    registry.register("pna", create_model_config(arch))   # on the card
    plan = plan_from_samples(sample_graphs, max_batch_graphs=64)
    with InferenceServer(registry, plan) as server:
        heads = server.predict(graph)                      # sync
        fut = server.submit(graph, deadline_s=0.1)         # async
"""

from hydragnn_tpu_torch.serve.buckets import (
    BucketCapacity,
    GraphTooLarge,
    ServingBucketPlan,
    plan_from_samples,
)
from hydragnn_tpu_torch.serve.metrics import LatencyHistogram, ServeMetrics
from hydragnn_tpu_torch.serve.registry import ModelEntry, ModelRegistry
from hydragnn_tpu_torch.serve.server import (
    DeadlineExceeded,
    InferenceServer,
    ServeFuture,
    ServerOverloaded,
)

__all__ = [
    "BucketCapacity",
    "DeadlineExceeded",
    "GraphTooLarge",
    "InferenceServer",
    "LatencyHistogram",
    "ModelEntry",
    "ModelRegistry",
    "ServeFuture",
    "ServeMetrics",
    "ServerOverloaded",
    "ServingBucketPlan",
    "plan_from_samples",
]
