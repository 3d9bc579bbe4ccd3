"""Serialized splits to padded training batches (port of the parts of
``data/loaders.py`` that ``run_training`` reaches).

:func:`dataset_loading_and_splitting` is the whole data path of a config:
raw files to serialized pickles (:func:`transform_raw_data_to_serialized`,
the ``LSMS``/``unit_test`` format), a ``total`` split cut into train,
validation and test (:func:`total_to_train_val_test_pkls`), each split read
(``data/serialized.py``), and one :class:`GraphLoader` per split over one
layout computed across all three (:func:`create_dataloaders`).

A :class:`GraphLoader` yields host batches (``GraphBatch`` of CPU
tensors, with every head's targets and the layout's extras), which the
trainer moves to the card in one copy each. Its order is the JAX
package's: a numpy permutation seeded ``seed + epoch`` (``set_epoch``),
``batch_size`` samples per batch; with ``Training.batch_buckets`` > 1 the
samples are binned by node count (the exact DP of ``data/layout.py``),
each bucket packed greedily under its budgets, and the batch order
shuffled across buckets. Collation runs on the calling thread: prefetch
threads, worker pools with CPU pinning, and sharding across processes are
not ported yet (``ROADMAP.md``, queue 1, items 8 and 9), and the
environment variables that ask for them raise.
"""

import bisect
import os
import pickle
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from hydragnn_tpu_torch.data.layout import (
    BatchLayout,
    _layout_from_maxima,
    _partition_node_bounds,
    collate_for_layout,
    needs_dense_neighbors,
    sample_triplets,
)
from hydragnn_tpu_torch.data.raw import serialized_dir
from hydragnn_tpu_torch.graph.batch import _round_up
from hydragnn_tpu_torch.ops.dense_agg import max_degree


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


@dataclass
class BucketedLayout:
    """Size buckets of one split plan: ``layouts[b]`` holds the samples
    with at most ``node_bounds[b]`` nodes (and more than the bound
    before), each sized at ``batch_size`` times its bucket's mean."""

    layouts: List[BatchLayout] = field(default_factory=list)
    node_bounds: List[int] = field(default_factory=list)

    def bucket_for(self, num_nodes: int) -> int:
        return min(bisect.bisect_left(self.node_bounds, num_nodes), len(self.layouts) - 1)

    @property
    def packs_triplets(self) -> bool:
        return self.layouts[0].packs_triplets


def _sample_stats(datasets, need_triplets: bool, need_neighbors: bool):
    """Per-sample node, edge and triplet counts and list widths over
    every split."""
    nodes, edges, trips, kis, kos = [], [], [], [], []
    for ds in datasets:
        for d in ds:
            nodes.append(d.num_nodes)
            edges.append(d.num_edges)
            trips.append(sample_triplets(d)[0].shape[0]
                         if need_triplets and not need_neighbors else 0)
            ki = ko = 0
            if need_neighbors and d.num_edges:
                ki, ko = max_degree(d.edge_index[0], d.edge_index[1])
            kis.append(ki)
            kos.append(ko)
    return tuple(np.asarray(a, np.int64) for a in (nodes, edges, trips, kis, kos))


def budget_bucket_layout(nodes, edges, trips, batch_size: int, mult: int,
                         need_triplets=False, need_neighbors=False, k_in=1, k_out=1):
    """One bucket sized at ``batch_size`` times its mean (at least its
    largest sample): the packer fills batches under these budgets, so
    every batch fits, and ``g_pad`` admits as many of its smallest graphs
    as the node budget holds."""
    n_pad = _round_up(int(max(batch_size * float(nodes.mean()), nodes.max()) + 1), mult)
    e_pad = _round_up(int(max(batch_size * float(edges.mean()), edges.max(), 1)), mult)
    g_pad = max(batch_size, n_pad // max(int(nodes.min()), 1)) + 1
    t_pad = 0
    if need_triplets and not need_neighbors:
        t_pad = _round_up(int(max(batch_size * float(trips.mean()), trips.max(), 1)), mult)
    return BatchLayout(n_pad, e_pad, g_pad, need_neighbors=need_neighbors,
                       k_in=max(int(k_in), 1), k_out=max(int(k_out), 1),
                       need_triplets=need_triplets, t_pad=t_pad)


def compute_layout(datasets, batch_size: int, need_triplets: bool = False,
                   need_neighbors: bool = False,
                   num_buckets: int = 1) -> Union[BatchLayout, BucketedLayout]:
    """One layout over all splits (every axis a multiple of 8: one card,
    no data axis to divide), or ``num_buckets`` size buckets."""
    mult = 8
    nodes, edges, trips, kis, kos = _sample_stats(datasets, need_triplets, need_neighbors)
    if num_buckets <= 1:
        return _layout_from_maxima(
            max(int(nodes.max()), 1), max(int(edges.max()), 1), batch_size, mult, 1,
            need_neighbors=need_neighbors, k_in=int(kis.max()), k_out=int(kos.max()),
            need_triplets=need_triplets, max_trip=int(trips.max()))
    bounds = _partition_node_bounds(nodes, num_buckets)
    layouts, lo = [], 0
    for hi in bounds:
        mask = (nodes > lo) & (nodes <= hi)
        layouts.append(budget_bucket_layout(
            nodes[mask], edges[mask], trips[mask], batch_size, mult, need_triplets,
            need_neighbors, k_in=int(kis[mask].max()), k_out=int(kos[mask].max())))
        lo = hi
    return BucketedLayout(layouts=layouts, node_bounds=bounds)


def _pack_indices(idx, nodes, edges, trips, layout: BatchLayout,
                  batch_size: Optional[int] = None) -> List[np.ndarray]:
    """Greedy packing: a batch closes when the next graph would overflow
    the node, edge or triplet budget, or the graph cap (``batch_size``
    when given: the configured step size)."""
    cap = layout.g_pad - 1
    if batch_size is not None:
        cap = min(cap, int(batch_size))
    batches, cur = [], []
    n = e = t = 0
    for i in idx:
        ni, ei, ti = int(nodes[i]), int(edges[i]), int(trips[i])
        if cur and (n + ni > layout.n_pad - 1 or e + ei > layout.e_pad
                    or (layout.packs_triplets and t + ti > layout.t_pad) or len(cur) >= cap):
            batches.append(np.asarray(cur, np.int64))
            cur, n, e, t = [], 0, 0, 0
        cur.append(int(i))
        n, e, t = n + ni, e + ei, t + ti
    if cur:
        batches.append(np.asarray(cur, np.int64))
    return batches


def head_schema(sample) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(head types, head dims)`` of a sample's targets."""
    return (tuple(sample.target_types),
            tuple(int(t.shape[-1] if t.ndim > 1 else t.shape[0]) for t in sample.targets))


class GraphLoader:
    """Padded host batches of one split, in the JAX package's order."""

    def __init__(self, dataset, batch_size: int, layout, shuffle: bool = True,
                 seed: int = 42, bucket_graph_cap: str = "batch"):
        if _env_int("HYDRAGNN_PREFETCH", 0) > 0 or _env_int("HYDRAGNN_NUM_WORKERS", 1) > 1:
            raise NotImplementedError(
                "HYDRAGNN_PREFETCH and HYDRAGNN_NUM_WORKERS (collation threads) are not "
                "ported yet: see ROADMAP.md, queue 1, items 8 and 9")
        if bucket_graph_cap not in ("batch", "budget"):
            raise ValueError(f"bucket_graph_cap must be 'batch' or 'budget', got {bucket_graph_cap!r}")
        if bucket_graph_cap == "budget" and not isinstance(layout, BucketedLayout):
            raise ValueError("bucket_graph_cap='budget' requires a bucketed layout "
                             "(Training.batch_buckets > 1)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.layout = layout
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.bucket_graph_cap = bucket_graph_cap
        self.heads = head_schema(dataset[0]) if len(dataset) else ((), ())
        self._plan_cache = None
        self._sizes = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _batch_plan(self):
        """The bucketed epoch plan: ``(bucket, sample indices)`` per batch,
        the same for the same ``(seed, epoch)``."""
        if self._plan_cache is not None and self._plan_cache[0] == self.epoch:
            return self._plan_cache[1]
        if self._sizes is None:
            ids = np.asarray([self.layout.bucket_for(d.num_nodes) for d in self.dataset], np.int64)
            sizes = _sample_stats([self.dataset], self.layout.packs_triplets, False)[:3]
            self._sizes = (ids,) + sizes
        ids, nodes, edges, trips = self._sizes
        cap = None if self.bucket_graph_cap == "budget" else self.batch_size
        rng = np.random.default_rng(self.seed + self.epoch)
        plan = []
        for b, lay in enumerate(self.layout.layouts):
            bidx = np.nonzero(ids == b)[0]
            if len(bidx) == 0:
                continue
            if self.shuffle:
                bidx = bidx[rng.permutation(len(bidx))]
            plan.extend((b, chunk) for chunk in
                        _pack_indices(bidx, nodes, edges, trips, lay, batch_size=cap))
        if self.shuffle and plan:
            plan = [plan[i] for i in rng.permutation(len(plan))]
        self._plan_cache = (self.epoch, plan)
        return plan

    def __len__(self):
        if isinstance(self.layout, BucketedLayout):
            return len(self._batch_plan())
        return -(-len(self.dataset) // self.batch_size)

    def batch_tasks(self):
        """``(layout, sample indices)`` of each batch of this epoch."""
        if isinstance(self.layout, BucketedLayout):
            for b, chunk in self._batch_plan():
                yield self.layout.layouts[b], chunk
            return
        idx = self._indices()
        for start in range(0, len(idx), self.batch_size):
            yield self.layout, idx[start : start + self.batch_size]

    def collate(self, layout, chunk):
        return collate_for_layout([self.dataset[i] for i in chunk], layout, *self.heads)

    def __iter__(self):
        for layout, chunk in self.batch_tasks():
            yield self.collate(layout, chunk)


def create_dataloaders(trainset, valset, testset, batch_size: int,
                       need_triplets: bool = False, need_neighbors: bool = False,
                       num_buckets: Optional[int] = None, bucket_graph_cap: str = "batch"):
    """Train, validation and test loaders over one layout (all three
    shuffled, as in the JAX package). ``HYDRAGNN_BATCH_BUCKETS`` overrides
    ``num_buckets``. Keeping a bucket's batches adjacent
    (``contiguous_buckets``) serves ``steps_per_dispatch``, which is not
    ported yet (``ROADMAP.md``, queue 1, item 5)."""
    contig = os.getenv("HYDRAGNN_BUCKET_CONTIGUOUS", "")
    if contig.strip().lower() not in ("", "0", "false", "no", "off"):
        raise NotImplementedError(
            "contiguous buckets are not ported yet: see ROADMAP.md, queue 1, item 5")
    num_buckets = max(_env_int("HYDRAGNN_BATCH_BUCKETS", num_buckets or 1), 1)
    layout = compute_layout([trainset, valset, testset], batch_size, need_triplets,
                            need_neighbors=need_neighbors, num_buckets=num_buckets)
    return tuple(GraphLoader(ds, batch_size, layout, shuffle=True,
                             bucket_graph_cap=bucket_graph_cap)
                 for ds in (trainset, valset, testset))


def _serialized_path(config: dict, split: Optional[str]) -> str:
    name = config["Dataset"]["name"]
    return os.path.join(serialized_dir(), f"{name}.pkl" if split is None else f"{name}_{split}.pkl")


def transform_raw_data_to_serialized(ds_config: dict):
    """Parse and serialize the raw files of a ``LSMS`` or ``unit_test``
    dataset."""
    fmt = ds_config["format"]
    if fmt not in ("LSMS", "unit_test"):
        raise NotImplementedError(
            f"the {fmt} raw format is not ported yet: see ROADMAP.md, queue 1, item 7")
    from hydragnn_tpu_torch.data.lsms import LSMSDataset

    LSMSDataset(ds_config).load_raw_data()


def total_to_train_val_test_pkls(config: dict):
    """Split the ``total`` pickle into train, validation and test pickles
    beside it (``data/split.py``) and point the config at them."""
    from hydragnn_tpu_torch.data.serialized import read_serialized
    from hydragnn_tpu_torch.data.split import split_dataset

    paths = config["Dataset"]["path"]
    file_dir = paths["total"] if list(paths.values())[0].endswith(".pkl") else \
        _serialized_path(config, None)
    minmax_node, minmax_graph, total = read_serialized(file_dir)
    splits = split_dataset(total, config["NeuralNetwork"]["Training"]["perc_train"],
                           config["Dataset"]["compositional_stratified_splitting"])
    out_dir = os.path.dirname(file_dir)
    config["Dataset"]["path"] = {}
    for name, ds in zip(("train", "validate", "test"), splits):
        target = os.path.join(out_dir, f"{config['Dataset']['name']}_{name}.pkl")
        config["Dataset"]["path"][name] = target
        with open(target, "wb") as f:
            pickle.dump(minmax_node, f)
            pickle.dump(minmax_graph, f)
            pickle.dump(ds, f)


def dataset_loading_and_splitting(config: dict):
    """Raw files to the three loaders of ``config`` (the JAX package's
    branch choice: the dense lists where ``needs_dense_neighbors`` says
    so, ``HYDRAGNN_AGG`` first)."""
    from hydragnn_tpu_torch.data.serialized import SerializedGraphLoader
    from hydragnn_tpu_torch.utils.config import arch_for_auto_policy

    paths = config["Dataset"]["path"]
    if not list(paths.values())[0].endswith(".pkl"):
        transform_raw_data_to_serialized(config["Dataset"])
    if "total" in paths:
        total_to_train_val_test_pkls(config)
    reader = SerializedGraphLoader(config)
    datasets = {
        name: reader.load_serialized_data(p if p.endswith(".pkl") else _serialized_path(config, name))
        for name, p in config["Dataset"]["path"].items()
    }
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"]["Training"]
    if training.get("contiguous_buckets"):
        raise NotImplementedError(
            "contiguous buckets are not ported yet: see ROADMAP.md, queue 1, item 5")
    return create_dataloaders(
        datasets["train"], datasets["validate"], datasets["test"],
        batch_size=training["batch_size"],
        need_triplets=arch.get("model_type") == "DimeNet",
        need_neighbors=needs_dense_neighbors(arch_for_auto_policy(config["NeuralNetwork"])),
        num_buckets=training.get("batch_buckets"),
        bucket_graph_cap=training.get("bucket_graph_cap", "batch"),
    )
