"""Static batch layouts (the part of ``data/loaders.py`` that serving needs).

A :class:`BatchLayout` is one set of pad sizes; :func:`collate_for_layout`
packs samples into it. Node-count bucket boundaries come from an exact DP
over the distinct node counts (:func:`_partition_node_bounds`). Only the
segment layout is ported: no DimeNet triplet tables and no dense
neighbour lists (see ``ROADMAP.md``).
"""

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from hydragnn_tpu_torch.graph.batch import GraphBatch, collate_graphs, pad_sizes_for


@dataclass
class BatchLayout:
    n_pad: int
    e_pad: int
    g_pad: int


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


def _layout_from_maxima(max_nodes: int, max_edges: int, batch_size: int,
                        mult: int, device_multiple: int) -> BatchLayout:
    n_pad, e_pad, g_pad = pad_sizes_for(
        max_nodes,
        max_edges,
        batch_size,
        node_multiple=mult,
        edge_multiple=mult,
        graph_multiple=max(device_multiple, 1),
    )
    return BatchLayout(n_pad, e_pad, g_pad)


def collate_for_layout(samples, layout: BatchLayout) -> GraphBatch:
    """Collate ``samples`` into the static shapes of ``layout`` (inputs
    only, on the host; move the batch with ``GraphBatch.to``)."""
    return collate_graphs(samples, layout.n_pad, layout.e_pad, layout.g_pad)
