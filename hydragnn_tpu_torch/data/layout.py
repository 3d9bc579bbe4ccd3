"""Static batch layouts (the part of ``data/loaders.py`` that serving needs).

A :class:`BatchLayout` is one set of pad sizes; :func:`collate_for_layout`
packs samples into it. Node-count bucket boundaries come from an exact DP
over the distinct node counts (:func:`_partition_node_bounds`). A layout
with ``need_neighbors`` also carries the dense neighbour lists
(``ops/dense_agg.py``) at its widths ``k_in``/``k_out``;
:func:`needs_dense_neighbors` decides whether a stack's layouts do. A
layout with ``need_triplets`` (DimeNet) packs the triplet tables
(``graph.batch.pack_triplets``, ``[t_pad]``) unless it has the lists, in
which case the lists carry the slot tables instead (the dense branch
derives every triplet from them).
"""

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import (
    GraphBatch,
    collate_graphs,
    compute_triplets,
    pack_triplets,
    pad_sizes_for,
)
from hydragnn_tpu_torch.ops import autotune
from hydragnn_tpu_torch.ops.dense_agg import build_neighbor_lists


@dataclass
class BatchLayout:
    n_pad: int
    e_pad: int
    g_pad: int
    # dense neighbour lists: fixed in/out-degree widths
    need_neighbors: bool = False
    k_in: int = 0
    k_out: int = 0
    # DimeNet's triplets: packed tables of t_pad rows, or the slot tables
    need_triplets: bool = False
    t_pad: int = 0

    @property
    def packs_triplets(self) -> bool:
        """Whether collation packs the T-axis triplet tables (a dense
        layout never does)."""
        return self.need_triplets and not self.need_neighbors


def sample_triplets(sample):
    """The triplets of one ``GraphData`` (:func:`compute_triplets`), cached
    in its ``extras`` (the JAX package's ``_sample_triplets``)."""
    if "triplets" not in sample.extras:
        sample.extras["triplets"] = compute_triplets(sample.edge_index, sample.num_nodes)
    return sample.extras["triplets"]


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _partition_node_bounds(nodes: np.ndarray, num_buckets: int) -> List[int]:
    """Bucket boundaries minimising total padded node rows: exact DP over
    the distinct node counts (the cost of a bucket is its sample count
    times its max node count, the rows its padded layout allocates)."""
    uniq, counts = np.unique(nodes, return_counts=True)
    m = len(uniq)
    k = min(num_buckets, m)
    if k <= 1:
        return [int(uniq[-1])]
    prefix = np.concatenate([[0], np.cumsum(counts)]).astype(np.float64)
    dp = np.full((k + 1, m + 1), float("inf"))
    cut = np.zeros((k + 1, m + 1), np.int64)
    dp[0][0] = 0.0
    for b in range(1, k + 1):
        for j in range(1, m + 1):
            cand = dp[b - 1][:j] + (prefix[j] - prefix[:j]) * float(uniq[j - 1])
            i = int(np.argmin(cand))
            dp[b][j] = cand[i]
            cut[b][j] = i
    bounds = []
    j = m
    for b in range(k, 0, -1):
        bounds.append(int(uniq[j - 1]))
        j = int(cut[b][j])
    return bounds[::-1]


def needs_dense_neighbors(arch_config: dict) -> bool:
    """Whether a stack's batches carry the dense neighbour lists: the JAX
    package's rule (``data/loaders.py:129-166``) without its cache tier.
    ``HYDRAGNN_AGG`` first, then an explicit ``dense_aggregation``, then
    the static policy (``ops/autotune.py``). The JAX package also consults
    its measured per-width cache before the static policy; the port has no
    such cache yet (``ROADMAP.md``), so the static policy decides.
    Off under graph partitioning."""
    if arch_config.get("partition_axis"):
        return False
    forced = autotune.env_force()
    if forced is not None:
        return forced == "dense"
    flag = arch_config.get("dense_aggregation")
    if flag is not None:
        return bool(flag)
    return autotune.auto_dense_aggregation(arch_config)


def _layout_from_maxima(max_nodes: int, max_edges: int, batch_size: int,
                        mult: int, device_multiple: int, need_neighbors: bool = False,
                        k_in: int = 1, k_out: int = 1, need_triplets: bool = False,
                        max_trip: int = 0) -> BatchLayout:
    n_pad, e_pad, g_pad = pad_sizes_for(
        max_nodes,
        max_edges,
        batch_size,
        node_multiple=mult,
        edge_multiple=mult,
        graph_multiple=max(device_multiple, 1),
    )
    t_pad = 0
    if need_triplets and not need_neighbors:
        t_pad = int(-(-(batch_size * max(max_trip, 1)) // mult) * mult)
    return BatchLayout(n_pad, e_pad, g_pad, need_neighbors=need_neighbors,
                       k_in=max(int(k_in), 1), k_out=max(int(k_out), 1),
                       need_triplets=need_triplets, t_pad=t_pad)


def collate_for_layout(samples, layout: BatchLayout, head_types=(), head_dims=()) -> GraphBatch:
    """Collate ``samples`` into the static shapes of ``layout`` (on the
    host; move the batch with ``GraphBatch.to``), with the triplet tables
    and the dense neighbour lists (and their slot tables) in ``extras``
    when the layout asks for them. Inputs only, unless ``head_types`` and
    ``head_dims`` name the heads whose targets to pack (training)."""
    batch = collate_graphs(samples, layout.n_pad, layout.e_pad, layout.g_pad,
                           head_types=tuple(head_types), head_dims=tuple(head_dims))
    extras = {}
    if layout.packs_triplets:
        trips = [sample_triplets(s) + (s.num_nodes, s.num_edges) for s in samples]
        extras.update(pack_triplets(trips, layout.n_pad, layout.t_pad))
    if layout.need_neighbors:
        extras.update(build_neighbor_lists(
            batch.senders.numpy(), batch.receivers.numpy(), batch.edge_mask.numpy(),
            layout.n_pad, layout.k_in, layout.k_out, with_slot_tables=layout.need_triplets,
        ))
    if not extras:
        return batch
    return batch.with_extras({k: torch.from_numpy(v) for k, v in extras.items()})
