"""The streaming batch loader: mix -> bucket-pack -> collate -> prefetch
(port of ``data/stream/loader.py``).

Duck-types the :class:`~hydragnn_tpu_torch.data.loaders.GraphLoader` surface
the trainer and epoch driver consume (``set_epoch`` / ``__iter__`` /
``__len__`` / ``epoch_padding_stats``) while never materializing the
dataset: samples arrive one at a time from the
:class:`~hydragnn_tpu_torch.data.stream.mix.WeightedMix` (itself bounded by
the shard window), are routed to their size bucket, packed greedily
under the bucket's budgets (the same rule as ``_pack_indices``), and
collated through the one shared ``collate_for_layout`` path. With
``prefetch > 0`` the whole pipeline — shard I/O, on-the-fly radius
graphs, packing, collation — runs on the background ``prefetch_iter``
thread, bounded by the queue; the consumer only ever blocks on the
queue, which is the ``stream_stall_seconds`` gauge.

``state_dict()``/``load_state_dict()`` expose the mix cursor; the epoch
driver threads it through the checkpoint's ``train_meta`` so a killed
run resumes on the same data order. Batches are the port's host
``GraphBatch`` objects (CPU tensors, every head's targets), collated with the
head schema of the mix's first probe sample.
"""

import time
from typing import Dict, List, Optional, Union

from hydragnn_tpu_torch.data.layout import BatchLayout, collate_for_layout
from hydragnn_tpu_torch.data.loaders import BucketedLayout, head_schema, prefetch_iter
from hydragnn_tpu_torch.data.stream.mix import WeightedMix
from hydragnn_tpu_torch.utils.envparse import env_int


class StreamLoader:
    """Streaming epoch loader over a :class:`WeightedMix`.

    ``__iter__`` is one-shot per epoch and ADVANCES the mix cursors —
    probes must use :meth:`example_batch` (cursor-neutral). ``len()`` is
    an UPPER bound (every batch holds >= 1 graph); the trainer treats it
    as a cap, so iteration simply ends at the true batch count.
    """

    # this loader measures its own consumer-side stalls and reports them
    # through obs.stream_epoch_stats — the trainer's data-wait accounting
    # (goodput ledger) must not time the same waits a second time
    reports_stream_stats = True

    def __init__(
        self,
        mix: WeightedMix,
        batch_size: int,
        layout: Union[BatchLayout, BucketedLayout],
        prefetch: Optional[int] = None,
    ):
        self.mix = mix
        self.batch_size = int(batch_size)
        self.layout = layout
        if prefetch is None:
            prefetch = env_int(
                "HYDRAGNN_STREAM_QUEUE",
                env_int("HYDRAGNN_PREFETCH", 0),
            )
        self.prefetch = prefetch
        self.epoch = 0
        # the epoch driver probes len(train_loader.dataset) inside a
        # try/TypeError — None keeps its graphs/sec derivation off rather
        # than wrong (the mix's own counters feed the stream gauges)
        self.dataset = None
        self._epoch_stats: Optional[Dict] = None
        self._stats_epoch = -1
        # the builder parks the plan's bucket_plan payload here when the
        # emit must wait for telemetry activation (driver startup order)
        self.plan_event: Optional[Dict] = None
        probe = mix.probe_samples(limit=1)
        self.heads = head_schema(probe[0]) if probe else ((), ())

    # ---- GraphLoader surface --------------------------------------------
    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)
        self.mix.set_epoch(epoch)

    def __len__(self) -> int:
        return self.mix.samples_per_epoch()

    def state_dict(self) -> Dict:
        return {"epoch": int(self.epoch), "mix": self.mix.state_dict()}

    def load_state_dict(self, sd: Dict):
        self.mix.load_state_dict(sd["mix"])

    def example_batch(self):
        """A collated batch from cursor-neutral probe samples — feeds
        ``Trainer.init_state`` without consuming the stream."""
        probe = self.mix.probe_samples(limit=self.batch_size)
        if not probe:
            raise ValueError("stream sources yielded no probe samples")
        if isinstance(self.layout, BucketedLayout):
            b = self.layout.bucket_for(probe[0].num_nodes)
            lay = self.layout.layouts[b]
        else:
            lay = self.layout
        # greedy fill under the SAME budgets the epoch packer honors — a
        # probe batch must be a shape the compiled programs will see
        take, n, e = [], 0, 0
        for d in probe:
            ni, ei = d.num_nodes, d.num_edges
            if ni > lay.n_pad - 1 or ei > lay.e_pad:
                continue
            if take and (
                n + ni > lay.n_pad - 1
                or e + ei > lay.e_pad
                or len(take) >= min(self.batch_size, lay.g_pad - 1)
            ):
                break
            take.append(d)
            n += ni
            e += ei
        if not take:
            raise ValueError(
                "no probe sample fits the first bucket's layout"
            )
        return collate_for_layout(take, lay, *self.heads)

    # ---- pipeline --------------------------------------------------------
    def _layout_for(self, num_nodes: int):
        if isinstance(self.layout, BucketedLayout):
            b = self.layout.bucket_for(num_nodes)
            return b, self.layout.layouts[b]
        return 0, self.layout

    def _batches(self, stats: Dict):
        """One epoch's (bucket, samples) stream, packed greedily under
        each bucket's budgets. Deterministic in (seed, epoch, cursor):
        the flush order of end-of-epoch partials is bucket index."""
        n_buckets = (
            len(self.layout.layouts)
            if isinstance(self.layout, BucketedLayout)
            else 1
        )
        open_batches: List[List] = [[] for _ in range(n_buckets)]
        open_n = [0] * n_buckets
        open_e = [0] * n_buckets

        def emit(b):
            lay = (
                self.layout.layouts[b]
                if isinstance(self.layout, BucketedLayout)
                else self.layout
            )
            batch = collate_for_layout(open_batches[b], lay, *self.heads)
            stats["real_nodes"] += open_n[b]
            stats["padded_nodes"] += int(lay.n_pad)
            stats["batches"] += 1
            open_batches[b] = []
            open_n[b] = 0
            open_e[b] = 0
            return batch

        for k, d in self.mix:
            stats["samples"] += 1
            b, lay = self._layout_for(d.num_nodes)
            ni, ei = d.num_nodes, d.num_edges
            if ni > lay.n_pad - 1 or ei > lay.e_pad:
                # a sample no bucket can hold (planner scanned a subset):
                # drop loudly-countable rather than crash the epoch
                stats["oversize_dropped"] += 1
                continue
            if open_batches[b] and (
                open_n[b] + ni > lay.n_pad - 1
                or open_e[b] + ei > lay.e_pad
                or len(open_batches[b]) >= min(
                    self.batch_size, lay.g_pad - 1
                )
            ):
                yield emit(b)
            open_batches[b].append(d)
            open_n[b] += ni
            open_e[b] += ei
        for b in range(n_buckets):
            if open_batches[b]:
                yield emit(b)

    def __iter__(self):
        from hydragnn_tpu_torch.obs import runtime as obs

        stats = {
            "samples": 0,
            "batches": 0,
            "real_nodes": 0,
            "padded_nodes": 0,
            "oversize_dropped": 0,
            "stall_s": 0.0,
            "queue_depth": 0,
            "bytes": 0,
        }
        self._epoch_stats = stats
        self._stats_epoch = self.epoch
        bytes_before = self.mix.residency_stats()["bytes_read"]
        t_start = time.perf_counter()

        def probe(depth):
            stats["queue_depth"] = depth

        if self.prefetch > 0:
            it = prefetch_iter(
                self._batches(stats), self.prefetch,
                name="hydragnn-stream-collate", probe=probe,
            )
        else:
            it = self._batches(stats)
        t0 = time.perf_counter()
        for batch in it:
            # time blocked on the data plane (queue wait with prefetch on,
            # whole-pipeline time with it off)
            stats["stall_s"] += time.perf_counter() - t0
            yield batch
            t0 = time.perf_counter()
        wall = max(time.perf_counter() - t_start, 1e-9)
        res = self.mix.residency_stats()
        stats["bytes"] = res["bytes_read"] - bytes_before
        source_counts = {
            s.name: int(n)
            for s, n in zip(self.mix.sources, self.mix.epoch_draws)
        }
        obs.stream_epoch_stats(
            queue_depth=stats["queue_depth"],
            stall_s=stats["stall_s"],
            bytes_per_sec=stats["bytes"] / wall,
            open_shards_peak=res["open_shards_peak"],
            resident_bytes_peak=res["resident_bytes_peak"],
            samples=stats["samples"],
            oversize_dropped=stats["oversize_dropped"],
            source_counts=source_counts,
        )
        if stats["oversize_dropped"]:
            # size-biased data loss must be operator-visible even with
            # telemetry off — the capped plan scan missed these sizes
            import warnings

            warnings.warn(
                f"stream epoch {self.epoch}: {stats['oversize_dropped']} "
                "sample(s) fit no bucket of the plan and were dropped — "
                "raise HYDRAGNN_STREAM_PLAN_SHARDS (0 scans everything) "
                "or num_buckets"
            )

    def epoch_padding_stats(self):
        """(real, padded) node rows of the LAST iterated epoch — streamed
        accounting is exact (counted as batches emit), unlike the
        materialized loader's plan simulation. None before any epoch
        has run."""
        s = self._epoch_stats
        if s is None or not s["padded_nodes"]:
            return None
        return s["real_nodes"], s["padded_nodes"]

    def close(self):
        self.mix.close()
