from hydragnn_tpu_torch.graph.batch import (
    GraphBatch,
    collate_graphs,
    compute_triplets,
    pack_triplets,
    pad_sizes_for,
    stack_batches,
)
from hydragnn_tpu_torch.graph.segment import (
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_minmax_fused,
    segment_moments_fused,
    segment_softmax,
    segment_softmax_unnorm,
    segment_std,
    segment_sum,
)

__all__ = [
    "GraphBatch",
    "collate_graphs",
    "compute_triplets",
    "pack_triplets",
    "pad_sizes_for",
    "segment_count",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_minmax_fused",
    "segment_moments_fused",
    "segment_softmax",
    "segment_softmax_unnorm",
    "segment_std",
    "segment_sum",
    "stack_batches",
]
