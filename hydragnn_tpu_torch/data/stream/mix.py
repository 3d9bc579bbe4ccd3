"""Deterministic weighted multi-dataset interleave with checkpointable
cursors — the streaming plane's sampling layer (port of
``data/stream/mix.py``: the same draws, rank partition and cursor, so a
cursor saved by either package resumes in the other).

Three deterministic ingredients, all pure functions of ``(seed, ...)``
integers so every host derives the same plan with no communication and a
resumed run replays bitwise-identically:

- **per-pass shard permutation** (seekable sources): pass ``p`` of source
  ``k`` visits shards in ``default_rng(SeedSequence([seed, k, p, 1]))``
  order, partitioned by rank (``perm[rank::world]``, wrap-padded so every
  rank holds the same shard count — DistributedSampler's rule at shard
  granularity). An elastic ``world_resize`` re-derives the partition from
  the new ``(world, rank)``, as data shards are re-derived.
- **window shuffle**: each rank reads ``window`` shards, shuffles the
  concatenated samples with ``SeedSequence([seed, k, p, 2, ptr])``, and
  releases the buffer when drained — at most one window of shards per
  source is ever resident in host RAM.
- **epoch interleave**: epoch ``e`` draws its source-choice sequence from
  ``SeedSequence([seed, e, 3])`` against the cumulative weights. Because
  the choice sequence depends only on ``(seed, epoch)``, resuming from an
  epoch-boundary cursor replays the interrupted epoch exactly.

The cursor (:meth:`WeightedMix.state_dict`) is a few integers per source
(pass index, shard pointer, within-window offset) — it rides in the
checkpoint's ``train_meta`` (format 2) and restores in O(window)
shard reads.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.stream.source import StreamSource, sample_nbytes


def _rng(*ints) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(i) for i in ints]))


class _SourceStream:
    """One source's infinite deterministic sample stream for one rank:
    pass-permuted shards -> rank partition -> window shuffle -> samples.
    Holds at most ``window`` shards' samples; cursor = (passno, ptr,
    offset) where ``ptr`` indexes this rank's shard sequence at the
    current window's start and ``offset`` counts samples already yielded
    from it."""

    def __init__(self, source: StreamSource, seed: int, index: int,
                 rank: int, world: int, window: int):
        self.source = source
        self.seed = int(seed)
        self.index = int(index)
        self.rank = int(rank)
        self.world = max(int(world), 1)
        self.window = max(int(window), 1)
        self.passno = 0
        self.ptr = 0  # shards consumed of this rank's current-pass list
        self._buffer: Optional[List] = None
        self._buf_start = 0
        self._offset = 0
        # residency accounting (the "bounded by the shard window"
        # acceptance assertion reads these)
        self.open_shards_peak = 0
        self.resident_bytes = 0
        self.resident_bytes_peak = 0
        self.bytes_read = 0

    def _mine(self, passno: int) -> np.ndarray:
        s = self.source.num_shards()
        if self.source.seekable:
            perm = _rng(self.seed, self.index, passno, 1).permutation(s)
        else:
            perm = np.arange(s)
        if self.world > 1:
            total = -(-s // self.world) * self.world
            perm = np.resize(perm, total)  # wrap-pad: equal count per rank
            perm = perm[self.rank :: self.world]
        return perm

    def _load_window(self):
        guard = 0
        while True:
            mine = self._mine(self.passno)
            if self.ptr >= len(mine):
                self.passno += 1
                self.ptr = 0
                continue
            ids = mine[self.ptr : self.ptr + self.window]
            samples: List = []
            for sid in ids:
                samples.extend(self.source.read_shard(int(sid)))
            self._buf_start = self.ptr
            self.ptr += len(ids)
            if samples:
                order = _rng(
                    self.seed, self.index, self.passno, 2, self._buf_start
                ).permutation(len(samples))
                self._buffer = [samples[i] for i in order]
                self._offset = 0
                self.open_shards_peak = max(
                    self.open_shards_peak, len(ids)
                )
                self.resident_bytes = sum(
                    sample_nbytes(d) for d in self._buffer
                )
                self.bytes_read += self.resident_bytes
                self.resident_bytes_peak = max(
                    self.resident_bytes_peak, self.resident_bytes
                )
                return
            guard += 1
            if guard > self.source.num_shards() + 1:
                raise ValueError(
                    f"stream source {self.source.name!r} yields no samples"
                )

    def next_sample(self):
        if self._buffer is None:
            self._load_window()
        d = self._buffer[self._offset]
        self._offset += 1
        if self._offset >= len(self._buffer):
            # eager release: the window bound is a RESIDENCY bound, not a
            # high-water mark that only GC enforces
            self._buffer = None
            self.resident_bytes = 0
        return d

    def state_dict(self) -> Dict[str, int]:
        if self._buffer is None:
            return {"passno": int(self.passno), "ptr": int(self.ptr),
                    "offset": 0}
        return {
            "passno": int(self.passno),
            "ptr": int(self._buf_start),
            "offset": int(self._offset),
        }

    def load_state_dict(self, sd):
        self.passno = int(np.asarray(sd["passno"]))
        self.ptr = int(np.asarray(sd["ptr"]))
        offset = int(np.asarray(sd["offset"]))
        self._buffer = None
        self.resident_bytes = 0
        self._offset = 0
        if offset > 0:
            self._load_window()
            self._offset = offset


class WeightedMix:
    """Deterministic PRNG-driven interleave of several
    :class:`StreamSource`\\ s with per-source weights.

    One epoch = ``samples_per_epoch`` draws per rank (default
    ``ceil(total_samples / world)``); each draw picks a source by weight
    and takes its stream's next sample. Sources cycle independently
    across epochs — a 10%-weight source takes many epochs to cover, a
    150%-effective-weight source repeats within one — which is exactly
    the GFM multi-dataset semantics (QM9 + OC20 + MPTrj in one run).

    Head schemas must match across sources (asserted at first draw);
    the collator cannot mix graph/node target layouts.
    """

    def __init__(
        self,
        sources: Sequence[StreamSource],
        weights: Optional[Sequence[float]] = None,
        seed: int = 42,
        samples_per_epoch: Optional[int] = None,
        window: Optional[int] = None,
        num_shards: Optional[int] = None,
        shard_id: Optional[int] = None,
    ):
        from hydragnn_tpu_torch.utils.envparse import env_int

        if not sources:
            raise ValueError("WeightedMix needs at least one source")
        if weights is None:
            weights = [1.0] * len(sources)
        if len(weights) != len(sources):
            raise ValueError(
                f"{len(sources)} sources but {len(weights)} weights"
            )
        w = np.asarray(weights, np.float64)
        if not np.all(w > 0):
            raise ValueError(f"weights must be positive, got {list(w)}")
        self.weights = w / w.sum()
        self._cum = np.cumsum(self.weights)
        self.sources = list(sources)
        self.seed = int(seed)
        self.epoch = 0
        if window is None:
            window = env_int("HYDRAGNN_STREAM_WINDOW", 2, minimum=1)
        self.window = window
        from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

        world, rank = comm_size_and_rank()
        self.world = world if num_shards is None else int(num_shards)
        self.rank = rank if shard_id is None else int(shard_id)
        self.streams = [
            _SourceStream(s, self.seed, i, self.rank, self.world, self.window)
            for i, s in enumerate(self.sources)
        ]
        self._samples_per_epoch = samples_per_epoch
        self._schema_checked = False
        # per-epoch draw counts by source (the stream_source_mix gauges)
        self.epoch_draws = np.zeros(len(self.sources), np.int64)

    def samples_per_epoch(self) -> int:
        if self._samples_per_epoch is not None:
            return int(self._samples_per_epoch)
        total = sum(s.num_samples() for s in self.sources)
        return max(-(-total // self.world), 1)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _check_schema(self, first):
        if self._schema_checked:
            return
        self._schema_checked = True
        want = tuple(first.target_types)
        for s in self.sources:
            probe = s.probe_samples(limit=1)
            if probe and tuple(probe[0].target_types) != want:
                raise ValueError(
                    f"source {s.name!r} head schema "
                    f"{tuple(probe[0].target_types)} != {want}; mixed "
                    "sources must share one head layout"
                )

    def __iter__(self):
        """Yield ``(source_index, sample)`` for one epoch's draws. The
        per-sample ``graph_builder`` stage is applied here, so downstream
        stages always see complete graphs."""
        rng = _rng(self.seed, self.epoch, 3)
        self.epoch_draws = np.zeros(len(self.sources), np.int64)
        n = self.samples_per_epoch()
        for _ in range(n):
            u = float(rng.random())
            k = int(np.searchsorted(self._cum, u, side="right"))
            k = min(k, len(self.sources) - 1)
            d = self.streams[k].next_sample()
            builder = self.sources[k].graph_builder
            if builder is not None:
                d = builder(d)
            if not self._schema_checked:
                self._check_schema(d)
            self.epoch_draws[k] += 1
            yield k, d

    # ---- checkpointable cursor ------------------------------------------
    def state_dict(self) -> Dict:
        """The resume cursor: seed/epoch plus each stream's position.
        Plain ints in nested string-keyed dicts — rides through the
        checkpoint's msgpack ``train_meta`` unchanged."""
        return {
            "seed": int(self.seed),
            "epoch": int(self.epoch),
            "world": int(self.world),
            "window": int(self.window),
            "sources": {
                str(i): st.state_dict()
                for i, st in enumerate(self.streams)
            },
        }

    def load_state_dict(self, sd: Dict):
        saved_seed = int(np.asarray(sd["seed"]))
        if saved_seed != self.seed:
            raise ValueError(
                f"stream cursor was saved with seed {saved_seed}, this "
                f"run uses {self.seed} — refusing a silently different "
                "data order"
            )
        # the cursor's (ptr, offset) are positions in a WINDOW-strided
        # walk: a different window silently replays a different order —
        # the same failure mode the seed check refuses
        saved_window = int(np.asarray(sd.get("window", self.window)))
        if saved_window != self.window:
            raise ValueError(
                f"stream cursor was saved with window {saved_window}, "
                f"this run uses {self.window} — refusing a silently "
                "different data order"
            )
        self.epoch = int(np.asarray(sd["epoch"]))
        saved_world = int(np.asarray(sd.get("world", self.world)))
        if saved_world != self.world:
            # elastic world resize: the rank partition the cursors index
            # no longer exists — re-derive from the new layout (fresh
            # per-source positions), as data shards are re-derived.
            # The post-resize trajectory matches a clean restart
            # at the new world, not the old world's continuation.
            import warnings

            warnings.warn(
                f"stream cursor was saved at world {saved_world}, now "
                f"{self.world}: per-source positions re-derived from the "
                "new rank layout"
            )
            return
        for i, st in enumerate(self.streams):
            key = str(i)
            if key in sd.get("sources", {}):
                st.load_state_dict(sd["sources"][key])

    # ---- residency/telemetry accounting ---------------------------------
    def residency_stats(self) -> Dict[str, float]:
        return {
            "open_shards_peak": max(
                (st.open_shards_peak for st in self.streams), default=0
            ),
            "resident_bytes_peak": sum(
                st.resident_bytes_peak for st in self.streams
            ),
            "bytes_read": sum(st.bytes_read for st in self.streams),
        }

    def probe_samples(self, limit: int = 64):
        """Cursor-neutral schema/example probe across sources."""
        out = []
        for s in self.sources:
            out.extend(s.probe_samples(limit=limit))
            if len(out) >= limit:
                break
        return out[:limit]

    def close(self):
        for s in self.sources:
            s.close()
