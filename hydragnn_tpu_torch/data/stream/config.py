"""Config-driven construction of the streaming data plane (port of
``data/stream/config.py``).

A run opts in with a ``Dataset.streaming`` section::

    "Dataset": {
      "streaming": {
        "sources": [
          {"format": "shard_store", "train": "dataset/qm9_trainset",
           "validate": "dataset/qm9_valset", "test": "dataset/qm9_testset",
           "weight": 2.0},
          {"format": "extxyz", "train": "oc20/train_xyz",
           "validate": "oc20/val_xyz", "test": "oc20/test_xyz",
           "weight": 1.0, "radius": 6.0, "max_neighbours": 50}
        ],
        "window_shards": 2,        // shard window per source (host RAM bound)
        "num_buckets": 4,          // auto-tuned bucket plan size
        "samples_per_epoch": null, // default: ceil(total / world)
        "seed": 42
      }
    }

The TRAIN split streams (weighted mix + window shuffle + auto bucket
plan); validate/test splits are materialized into regular
``GraphLoader``\\ s over the plan's layout — eval sets are the small end
of the pipeline and the epoch driver evaluates them every epoch.

``probe_loader`` (returned fourth) is a cursor-neutral materialized
loader over the first window's samples: ``update_config`` derives output
dims/PNA degrees from it, and the trainer's ``init_state`` takes its
example batch — neither may consume the stream.
"""

from typing import Optional

from hydragnn_tpu_torch.data.stream.loader import StreamLoader
from hydragnn_tpu_torch.data.stream.mix import WeightedMix
from hydragnn_tpu_torch.data.stream.planner import BucketPlanner
from hydragnn_tpu_torch.data.stream.source import (
    ExtxyzSource,
    ShardStoreSource,
    StreamSource,
)
from hydragnn_tpu_torch.utils.envparse import env_int


def streaming_requested(config: dict) -> bool:
    return bool(config.get("Dataset", {}).get("streaming"))


def _train_source(spec: dict) -> StreamSource:
    fmt = spec.get("format", "shard_store")
    name = spec.get("name")
    if fmt == "shard_store":
        return ShardStoreSource(spec["train"], name=name)
    if fmt == "extxyz":
        return ExtxyzSource(
            dirpath=spec["train"],
            radius=float(spec.get("radius", 6.0)),
            max_neighbours=int(spec.get("max_neighbours", 50)),
            energy_per_atom=bool(spec.get("energy_per_atom", True)),
            name=name,
        )
    raise ValueError(
        f"streaming source format {fmt!r} has no config mapping; build "
        "MPTrjSource/QM9RawSource through the API "
        "(hydragnn_tpu_torch.data.stream) instead"
    )


def _eval_dataset(spec: dict, split: str):
    fmt = spec.get("format", "shard_store")
    path = spec.get(split)
    if path is None:
        return []
    if fmt == "shard_store":
        from hydragnn_tpu_torch.data.shard_store import ShardDataset

        return ShardDataset(path)
    if fmt == "extxyz":
        from hydragnn_tpu_torch.data.extxyz import load_extxyz_dir

        return load_extxyz_dir(
            path,
            radius=float(spec.get("radius", 6.0)),
            max_neighbours=int(spec.get("max_neighbours", 50)),
            energy_per_atom=bool(spec.get("energy_per_atom", True)),
        )
    raise ValueError(f"streaming source format {fmt!r} has no config mapping")


def assemble_stream_loaders(
    sources, weights, batch_size: int, scfg: dict, valset, testset,
    num_buckets: Optional[int] = None,
):
    """The ONE streaming-pipeline assembly (the config driver and the
    API callers both route through here — env
    precedence and plan coverage must not drift between entry points):
    weighted mix, bucket plan over the train histogram PLUS the
    materialized eval splits (an eval graph larger than anything the
    train scan saw still needs a bucket), StreamLoader, eval
    GraphLoaders, cursor-neutral probe loader. The plan's
    ``bucket_plan`` payload rides on ``train_loader.plan_event`` for the
    caller to emit once telemetry is active (the driver builds loaders
    BEFORE ``init_run_telemetry``)."""
    from hydragnn_tpu_torch.data.loaders import GraphLoader

    window = env_int(
        "HYDRAGNN_STREAM_WINDOW",
        int(scfg.get("window_shards", 2)),
        minimum=1,
    )
    mix = WeightedMix(
        sources,
        weights,
        seed=int(scfg.get("seed", 42)),
        samples_per_epoch=scfg.get("samples_per_epoch"),
        window=window,
    )
    planner = BucketPlanner(
        sources,
        batch_size,
        num_buckets=int(
            scfg.get("num_buckets", num_buckets or 4)
        ),
        extra_datasets=[valset, testset],
    )
    layout = planner.plan(emit=False)
    train_loader = StreamLoader(mix, batch_size, layout)
    train_loader.plan_event = planner.plan_payload(layout)
    val_loader = GraphLoader(valset, batch_size, layout, shuffle=False)
    test_loader = GraphLoader(testset, batch_size, layout, shuffle=False)
    probe_loader = GraphLoader(
        mix.probe_samples(limit=max(batch_size * 4, 64)),
        batch_size,
        layout,
        shuffle=False,
    )
    return train_loader, val_loader, test_loader, probe_loader


def build_stream_loaders(config: dict):
    """(train StreamLoader, val GraphLoader, test GraphLoader,
    probe GraphLoader) from the ``Dataset.streaming`` section."""
    from hydragnn_tpu_torch.data.loaders import ConcatDataset

    scfg = config["Dataset"]["streaming"]
    if config["NeuralNetwork"]["Architecture"].get("partition_axis"):
        raise ValueError(
            "streaming ingestion and graph partitioning are mutually "
            "exclusive (the partitioner needs whole-dataset budgets)"
        )
    specs = scfg.get("sources") or []
    if not specs:
        raise ValueError("Dataset.streaming.sources is empty")
    training = config["NeuralNetwork"]["Training"]
    sources = [_train_source(s) for s in specs]
    weights = [float(s.get("weight", 1.0)) for s in specs]
    vals = [_eval_dataset(s, "validate") for s in specs]
    tests = [_eval_dataset(s, "test") for s in specs]
    return assemble_stream_loaders(
        sources,
        weights,
        int(training["batch_size"]),
        scfg,
        ConcatDataset([d for d in vals if len(d)]),
        ConcatDataset([d for d in tests if len(d)]),
        num_buckets=training.get("batch_buckets"),
    )
