"""Serving bucket plans: request -> static padding bucket -> padded batch
(port of ``serve/buckets.py``).

A plan is an ascending family of :class:`BatchLayout` paddings. A request
goes to the smallest bucket whose per-graph capacity covers both its node
and its edge count; a dense graph whose edges overflow its node-natural
bucket falls through to the next larger one. Packing is budget-greedy:
requests accumulate until the next one would overflow the bucket's pads,
so every packed batch fits its layout by construction.

A plan built with ``need_neighbors`` packs the dense neighbour lists into
every batch, at widths taken per bucket from its samples' degrees. A plan
built with ``need_triplets`` (DimeNet) packs the triplet tables, and a
request must also fit its bucket's triplet capacity; with the lists too,
it packs their slot tables instead. The port serves from one card, so
graph pads need no device multiple.
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
    sample_triplets,
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
    max_triplets: int = 0  # 0: the bucket packs no triplets

    def admits(self, num_nodes: int, num_edges: int, num_triplets: int = 0) -> bool:
        return (
            num_nodes <= self.max_nodes
            and num_edges <= self.max_edges
            and (self.max_triplets == 0 or num_triplets <= self.max_triplets)
        )


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

    def request_sizes(self, graph: GraphData) -> Tuple[int, int, int]:
        """(nodes, edges, triplets) of one request; the triplets are counted
        (and cached on the sample) only where the plan packs them."""
        t = 0
        if self.layouts[0].packs_triplets:
            t = int(sample_triplets(graph)[0].shape[0])
        return int(graph.num_nodes), int(graph.num_edges), t

    def select(self, graph: GraphData) -> int:
        """The smallest bucket that admits ``graph`` (:meth:`admit`'s
        bucket). Raises :class:`GraphTooLarge` when none does."""
        return self.admit(graph)[0]

    def admit(self, graph: GraphData) -> Tuple[int, Tuple[int, int, int]]:
        """``(bucket, (nodes, edges, triplets))`` for one request. Raises
        :class:`GraphTooLarge` when no bucket admits the graph."""
        sizes = self.request_sizes(graph)
        n, e, t = sizes
        for b, cap in enumerate(self.capacities):
            if cap.admits(n, e, t):
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
                   acc_graphs: int, sizes: Tuple[int, ...], acc_trips: int = 0) -> bool:
        """Would adding a request of ``sizes`` (``(nodes, edges[,
        triplets])``) keep the accumulating batch inside bucket
        ``bucket``'s pads?"""
        lay = self.layouts[bucket]
        n, e = sizes[0], sizes[1]
        t = sizes[2] if len(sizes) > 2 else 0
        return (
            acc_nodes + n <= lay.n_pad - 1
            and acc_edges + e <= lay.e_pad
            and (not lay.packs_triplets or acc_trips + t <= lay.t_pad)
            and acc_graphs + 1 <= lay.g_pad - 1
        )


def plan_from_samples(
    samples: Sequence[GraphData],
    max_batch_graphs: int = 8,
    num_buckets: int = 3,
    need_neighbors: bool = False,
    headroom: float = 1.0,
    need_triplets: bool = False,
) -> ServingBucketPlan:
    """Derive a serving plan from representative graphs.

    Buckets are worst-case sized: ``max_batch_graphs`` graphs each at the
    bucket's observed maxima always fit. ``headroom`` multiplies the
    observed per-bucket maxima so slightly larger production graphs still
    admit. ``need_neighbors``: the batches carry the dense neighbour lists,
    each bucket at the largest in- and out-degree of its samples.
    ``need_triplets``: DimeNet's triplet tables (or, with the lists, their
    slot tables), each bucket sized at its samples' largest triplet
    count."""
    if not samples:
        raise ValueError("plan_from_samples needs at least one sample")
    if headroom < 1.0:
        raise ValueError("headroom must be >= 1.0")
    nodes = np.asarray([s.num_nodes for s in samples])
    edges = np.asarray([s.num_edges for s in samples])
    kis = kos = np.ones(len(samples), np.int64)
    trips = np.zeros(len(samples), np.int64)
    if need_triplets and not need_neighbors:
        trips = np.asarray([sample_triplets(s)[0].shape[0] for s in samples])
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
        cap_trips = int(np.ceil(int(trips[mask].max()) * headroom))
        layouts.append(
            _layout_from_maxima(
                cap_nodes, cap_edges, max_batch_graphs, mult, device_multiple,
                need_neighbors, int(kis[mask].max()), int(kos[mask].max()),
                need_triplets, cap_trips,
            )
        )
        capacities.append(BucketCapacity(
            max_nodes=cap_nodes, max_edges=cap_edges,
            max_triplets=cap_trips if need_triplets else 0,
        ))
        lo = hi
    smallest = samples[int(np.argmin(nodes))]
    return ServingBucketPlan(
        layouts=layouts,
        capacities=capacities,
        warmup_sample=smallest.clone(),
    )


def plan_from_layout(layout, warmup_sample: GraphData,
                     node_bounds: Optional[Sequence[int]] = None) -> ServingBucketPlan:
    """A training layout (``data.loaders.compute_layout``: one
    :class:`BatchLayout` or a ``BucketedLayout``) as the serving plan, so
    that serving replays the shapes training captured. Each bucket admits
    one graph of up to ``n_pad - 1`` nodes (or its node bound, the
    smaller), ``e_pad`` edges and, where it packs them, ``t_pad``
    triplets."""
    layouts = list(layout.layouts) if hasattr(layout, "layouts") else [layout]
    bounds = list(node_bounds if node_bounds is not None else getattr(layout, "node_bounds", []))
    capacities = [
        BucketCapacity(
            max_nodes=min(bounds[i], lay.n_pad - 1) if i < len(bounds) else lay.n_pad - 1,
            max_edges=lay.e_pad,
            max_triplets=lay.t_pad if lay.packs_triplets else 0,
        )
        for i, lay in enumerate(layouts)
    ]
    return ServingBucketPlan(layouts=layouts, capacities=capacities,
                             warmup_sample=warmup_sample.clone())
