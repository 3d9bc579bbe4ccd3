"""Serving bucket plans: request -> static padding bucket -> padded batch
(port of ``serve/buckets.py``).

A plan is an ascending family of :class:`BatchLayout` paddings. A request
goes to the smallest bucket whose per-graph capacity covers both its node
and its edge count; a dense graph whose edges overflow its node-natural
bucket falls through to the next larger one. Packing is budget-greedy:
requests accumulate until the next one would overflow the bucket's pads,
so every packed batch fits its layout by construction.

A plan built with ``need_neighbors`` packs the dense neighbour lists into
every batch, at widths taken per bucket from its samples' degrees. Triplet
packing is not ported, and the port serves from one card, so graph pads
need no device multiple.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.layout import (
    BatchLayout,
    _layout_from_maxima,
    _lcm,
    _partition_node_bounds,
    collate_for_layout,
)
from hydragnn_tpu_torch.ops.dense_agg import max_degree


class GraphTooLarge(ValueError):
    """The graph exceeds the largest bucket's per-graph capacity."""


@dataclass(frozen=True)
class BucketCapacity:
    """Per-graph admission limits for one bucket (a single request must fit
    a batch alone: ``n_pad`` reserves one padding node)."""

    max_nodes: int
    max_edges: int

    def admits(self, num_nodes: int, num_edges: int) -> bool:
        return num_nodes <= self.max_nodes and num_edges <= self.max_edges


@dataclass
class ServingBucketPlan:
    """Ascending bucket layouts + per-bucket admission capacities.

    ``warmup_sample`` is a small :class:`GraphData` dispatched once per
    bucket at startup (it must fit bucket 0, so it fits all)."""

    layouts: List[BatchLayout]
    capacities: List[BucketCapacity]
    warmup_sample: Optional[GraphData] = None

    def __post_init__(self):
        if not self.layouts:
            raise ValueError("a serving plan needs at least one bucket")
        if len(self.layouts) != len(self.capacities):
            raise ValueError("layouts and capacities must pair up")

    @property
    def num_buckets(self) -> int:
        return len(self.layouts)

    @staticmethod
    def request_sizes(graph: GraphData) -> Tuple[int, int]:
        """(nodes, edges) of one request."""
        return int(graph.num_nodes), int(graph.num_edges)

    def admit(self, graph: GraphData) -> Tuple[int, Tuple[int, int]]:
        """``(bucket, (nodes, edges))`` for one request. Raises
        :class:`GraphTooLarge` when no bucket admits the graph."""
        sizes = self.request_sizes(graph)
        n, e = sizes
        for b, cap in enumerate(self.capacities):
            if cap.admits(n, e):
                return b, sizes
        raise GraphTooLarge(
            f"graph with {n} nodes / {e} edges exceeds the largest serving "
            f"bucket (max {self.capacities[-1].max_nodes} nodes / "
            f"{self.capacities[-1].max_edges} edges); re-plan with larger "
            "buckets or partition the graph"
        )

    def natural_bucket(self, num_nodes: int) -> int:
        """The bucket the node count alone would pick."""
        for b, cap in enumerate(self.capacities):
            if num_nodes <= cap.max_nodes:
                return b
        return len(self.capacities) - 1

    def pack(self, graphs: Sequence[GraphData], bucket: int):
        """Collate admitted requests into bucket ``bucket``'s static shapes
        (inputs only). Returns the padded host batch plus per-request
        ``(graph row, node offset, node count)`` for splitting the outputs."""
        batch = collate_for_layout(list(graphs), self.layouts[bucket])
        coords = []
        off = 0
        for g, sample in enumerate(graphs):
            n = int(sample.num_nodes)
            coords.append((g, off, n))
            off += n
        return batch, coords

    def fits_batch(self, bucket: int, acc_nodes: int, acc_edges: int,
                   acc_graphs: int, sizes: Tuple[int, int]) -> bool:
        """Would adding a request of ``sizes`` keep the accumulating batch
        inside bucket ``bucket``'s pads?"""
        lay = self.layouts[bucket]
        n, e = sizes
        return (
            acc_nodes + n <= lay.n_pad - 1
            and acc_edges + e <= lay.e_pad
            and acc_graphs + 1 <= lay.g_pad - 1
        )


def plan_from_samples(
    samples: Sequence[GraphData],
    max_batch_graphs: int = 8,
    num_buckets: int = 3,
    need_neighbors: bool = False,
    headroom: float = 1.0,
) -> ServingBucketPlan:
    """Derive a serving plan from representative graphs.

    Buckets are worst-case sized: ``max_batch_graphs`` graphs each at the
    bucket's observed maxima always fit. ``headroom`` multiplies the
    observed per-bucket maxima so slightly larger production graphs still
    admit. ``need_neighbors``: the batches carry the dense neighbour lists,
    each bucket at the largest in- and out-degree of its samples."""
    if not samples:
        raise ValueError("plan_from_samples needs at least one sample")
    if headroom < 1.0:
        raise ValueError("headroom must be >= 1.0")
    nodes = np.asarray([s.num_nodes for s in samples])
    edges = np.asarray([s.num_edges for s in samples])
    kis = kos = np.ones(len(samples), np.int64)
    if need_neighbors:
        deg = [
            max_degree(s.edge_index[0], s.edge_index[1]) if s.num_edges else (1, 1)
            for s in samples
        ]
        kis = np.asarray([d[0] for d in deg])
        kos = np.asarray([d[1] for d in deg])
    device_multiple = 1  # one card
    mult = _lcm(8, device_multiple)
    layouts, capacities = [], []
    lo = 0
    for hi in _partition_node_bounds(nodes, num_buckets):
        mask = (nodes > lo) & (nodes <= hi)
        if not mask.any():
            lo = hi
            continue
        cap_nodes = int(np.ceil(hi * headroom))
        cap_edges = max(int(np.ceil(int(edges[mask].max()) * headroom)), 1)
        layouts.append(
            _layout_from_maxima(
                cap_nodes, cap_edges, max_batch_graphs, mult, device_multiple,
                need_neighbors, int(kis[mask].max()), int(kos[mask].max()),
            )
        )
        capacities.append(BucketCapacity(max_nodes=cap_nodes, max_edges=cap_edges))
        lo = hi
    smallest = samples[int(np.argmin(nodes))]
    return ServingBucketPlan(
        layouts=layouts,
        capacities=capacities,
        warmup_sample=smallest.clone(),
    )
