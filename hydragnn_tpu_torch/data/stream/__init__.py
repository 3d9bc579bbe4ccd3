"""Streaming data plane (port of ``data/stream/``): shard-native ingestion
for datasets that fit neither in host RAM nor device memory.

Pipeline:  sources (lazy shard readers)  ->  WeightedMix (deterministic
interleave + distributed window shuffle, checkpointable cursor)  ->
BucketPlanner (auto-tuned bucket plan from streamed size histograms)  ->
StreamLoader (greedy bucket packing + collation + bounded prefetch).
"""

from hydragnn_tpu_torch.data.stream.loader import StreamLoader
from hydragnn_tpu_torch.data.stream.mix import WeightedMix
from hydragnn_tpu_torch.data.stream.planner import BucketPlanner
from hydragnn_tpu_torch.data.stream.source import (
    ExtxyzSource,
    ListSource,
    MPTrjSource,
    QM9RawSource,
    ShardStoreSource,
    StreamSource,
    sample_nbytes,
)
from hydragnn_tpu_torch.data.stream.config import (
    assemble_stream_loaders,
    build_stream_loaders,
    streaming_requested,
)

__all__ = [
    "BucketPlanner",
    "assemble_stream_loaders",
    "ExtxyzSource",
    "ListSource",
    "MPTrjSource",
    "QM9RawSource",
    "ShardStoreSource",
    "StreamLoader",
    "StreamSource",
    "WeightedMix",
    "build_stream_loaders",
    "sample_nbytes",
    "streaming_requested",
]
