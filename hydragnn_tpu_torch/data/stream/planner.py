"""Auto-tuned bucket plans from streamed size histograms (port of
``data/stream/planner.py``: the same bounds, budgets, ``est_waste`` and
``bucket_plan`` payload).

The padding-waste stats the obs layer collects (``epoch_padding_stats``
-> ``padding_waste_ratio``) exist so bucket tables stop being
hand-written. :class:`BucketPlanner`
runs a cheap size-histogram pass over the stream sources (index-only on
GraphPack stores — no payload decode), picks bucket boundaries with the
same exact-DP the materialized path uses
(:func:`~hydragnn_tpu_torch.data.layout._partition_node_bounds`), sizes each
bucket with the SAME budget rule
(:func:`~hydragnn_tpu_torch.data.loaders.budget_bucket_layout`), estimates the
plan's padding waste by simulating the loader's own greedy packing, and
emits one schema-valid ``bucket_plan`` event recording all of it.

One sizing rule shared with ``compute_layout`` means an auto plan can be
compared number-for-number against a hand table through the existing
``epoch_padding_stats`` accounting — the acceptance check.
"""

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from hydragnn_tpu_torch.data.layout import BatchLayout, _partition_node_bounds
from hydragnn_tpu_torch.data.loaders import (
    BucketedLayout,
    _pack_indices,
    budget_bucket_layout,
)
from hydragnn_tpu_torch.data.stream.source import StreamSource
from hydragnn_tpu_torch.utils.envparse import env_int


class BucketPlanner:
    """Builds a :class:`BucketedLayout` from streamed size statistics.

    ``plan_shards`` caps the histogram pass per source (default: the
    ``HYDRAGNN_STREAM_PLAN_SHARDS`` env knob, 0 = scan everything —
    index-backed sources scan everything cheaply regardless via their
    no-payload ``size_scan``). DimeNet triplet tables and dense neighbor
    lists need per-sample structure a size pass does not see — those
    layouts stay on the materialized ``compute_layout`` path.

    Every axis pads to a multiple of 8 and the graph count to no data
    axis: the port runs on one card (the JAX package's ``device_multiple``
    is its device count).
    """

    def __init__(
        self,
        sources: Sequence[StreamSource],
        batch_size: int,
        num_buckets: int = 4,
        plan_shards: Optional[int] = None,
        extra_datasets: Sequence = (),
    ):
        if not sources:
            raise ValueError("BucketPlanner needs at least one source")
        self.sources = list(sources)
        self.batch_size = int(batch_size)
        self.num_buckets = max(int(num_buckets), 1)
        # materialized splits (val/test) that will be served through the
        # SAME layout: their sizes join the histogram so an eval graph
        # larger than anything the train scan saw still has a bucket —
        # the materialized compute_layout covers all splits for exactly
        # this reason
        self.extra_datasets = list(extra_datasets)
        if plan_shards is None:
            plan_shards = env_int("HYDRAGNN_STREAM_PLAN_SHARDS", 0)
        self.plan_shards = plan_shards
        self._scan: Optional[Dict] = None

    # ---- histogram pass --------------------------------------------------
    def scan(self) -> Dict:
        if self._scan is not None:
            return self._scan
        nodes_all, edges_all = [], []
        per_source = {}
        cap = None if self.plan_shards <= 0 else self.plan_shards
        for s in self.sources:
            nodes, edges = s.size_scan(max_shards=cap)
            if nodes.size == 0:
                raise ValueError(
                    f"stream source {s.name!r} produced no samples in "
                    "the size scan"
                )
            per_source[s.name] = int(nodes.size)
            nodes_all.append(nodes)
            edges_all.append(edges)
        for ds in self.extra_datasets:
            n = [d.num_nodes for d in ds]
            if n:
                nodes_all.append(np.asarray(n, np.int64))
                edges_all.append(
                    np.asarray([d.num_edges for d in ds], np.int64)
                )
        probe = self.sources[0].probe_samples(limit=1)
        if not probe:
            raise ValueError("cannot probe head schema: empty first shard")
        first = probe[0]
        head_types = tuple(first.target_types)
        head_dims = tuple(
            t.shape[-1] if t.ndim > 1 else t.shape[0] for t in first.targets
        )
        self._scan = {
            "nodes": np.concatenate(nodes_all),
            "edges": np.concatenate(edges_all),
            "per_source": per_source,
            "head_types": head_types,
            "head_dims": head_dims,
        }
        return self._scan

    # ---- plan ------------------------------------------------------------
    def plan(self, emit: bool = True) -> Union[BatchLayout, BucketedLayout]:
        scan = self.scan()
        nodes, edges = scan["nodes"], scan["edges"]
        mult = 8
        bounds = _partition_node_bounds(nodes, self.num_buckets)
        layouts: List[BatchLayout] = []
        lo = 0
        kept_bounds: List[int] = []
        for hi in bounds:
            mask = (nodes > lo) & (nodes <= hi)
            lo = hi
            if not mask.any():
                continue
            kept_bounds.append(int(hi))
            layouts.append(
                budget_bucket_layout(
                    nodes[mask], edges[mask], np.zeros(int(mask.sum())),
                    self.batch_size, mult,
                )
            )
        layout = BucketedLayout(layouts=layouts, node_bounds=kept_bounds)
        if emit:
            from hydragnn_tpu_torch.obs import runtime as obs

            obs.emit("bucket_plan", **self.plan_payload(layout))
        return layout

    def plan_payload(self, layout: BucketedLayout) -> Dict:
        """The ``bucket_plan`` event's payload for a plan this planner
        built — separable from :meth:`plan` because the driver builds
        loaders BEFORE telemetry activates and must emit the record
        afterwards (an emit into inactive telemetry is a silent no-op)."""
        scan = self.scan()
        return {
            "num_buckets": len(layout.layouts),
            "bounds": list(layout.node_bounds),
            "samples_scanned": int(scan["nodes"].size),
            "est_waste": round(float(self.estimate_waste(layout)), 6),
            "batch_size": self.batch_size,
            "per_source": scan["per_source"],
            "buckets": [
                {
                    "bound": b,
                    "n_pad": lay.n_pad,
                    "e_pad": lay.e_pad,
                    "g_pad": lay.g_pad,
                }
                for b, lay in zip(layout.node_bounds, layout.layouts)
            ],
        }

    def estimate_waste(
        self, layout: Union[BatchLayout, BucketedLayout]
    ) -> float:
        """Expected padding-waste ratio (1 - real/padded node rows) of
        ``layout`` over the scanned histogram, simulating the loader's
        own greedy packing — the same integrals
        ``GraphLoader.epoch_padding_stats`` reports live, so the planner's
        estimate and the measured epoch waste are directly comparable."""
        scan = self.scan()
        nodes, edges = scan["nodes"], scan["edges"]
        trips = np.zeros(len(nodes), np.int64)
        real = padded = 0
        if isinstance(layout, BucketedLayout):
            assign = np.asarray(
                [layout.bucket_for(int(n)) for n in nodes], np.int64
            )
            for b in range(len(layout.layouts)):
                idx = np.nonzero(assign == b)[0]
                if not len(idx):
                    continue
                lay = layout.layouts[b]
                batches = _pack_indices(
                    idx, nodes, edges, trips, lay,
                    batch_size=self.batch_size,
                )
                real += int(nodes[idx].sum())
                padded += len(batches) * int(lay.n_pad)
        else:
            nb = -(-len(nodes) // self.batch_size)
            real = int(nodes.sum())
            padded = nb * int(layout.n_pad)
        return 1.0 - real / max(padded, 1)
