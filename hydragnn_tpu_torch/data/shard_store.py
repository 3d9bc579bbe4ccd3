"""Sharded GraphPack dataset (port of ``data/shard_store.py``; the shard
files are the JAX package's, read and written by either package) — the
ADIOS2 data-plane replacement.

API parity with ``AdiosWriter``/``AdiosDataset``
(``hydragnn/utils/adiosdataset.py:77-278, 281-789``): a writer that each
process calls with its local samples (``add``), plus global attributes; a
dataset that presents the union of all shards with O(1) ``get(i)`` by global
index. Differences by design:

- Each process writes its OWN shard file (``<label>/shard.<rank:05d>.gpk``) — no
  MPI-collective global write; the "global shape/offset" bookkeeping the
  reference assembles with allgathers (``adiosdataset.py:207-270``) is
  recovered at open time from the per-shard count/offset indexes.
- The reference's node-local SharedMemory mode (``:458-506``) is free here:
  shard files are mmap'd MAP_SHARED, so all trainer processes on one host
  share the same page-cache pages. ``preload=True`` copies into RAM instead
  (slow remote filesystems).

Reads go through ``utils.faults.flaky_read`` and are retried on a transient
``OSError`` (``utils.retry.retry_io``), as the JAX package's are.
"""

import glob
import json
import os
from typing import Dict, List

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.native.graphpack import PackReader, PackWriter
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.retry import retry_io


class ShardWriter:
    """Per-process shard writer.

    >>> w = ShardWriter("dataset/trainset", rank=rank)
    >>> w.add(samples)           # list[GraphData], this process's share
    >>> w.add_global("pna_deg", deg_hist)
    >>> w.save()
    """

    def __init__(self, label: str, rank: int = 0):
        self.label = label
        self.rank = rank
        self.samples: List[GraphData] = []
        self.attrs: Dict[str, object] = {}

    def add(self, samples):
        if isinstance(samples, GraphData):
            self.samples.append(samples)
        else:
            self.samples.extend(samples)

    def add_global(self, name: str, value):
        if isinstance(value, np.ndarray):
            value = value.tolist()
        self.attrs[name] = value

    def save(self):
        os.makedirs(self.label, exist_ok=True)
        n = len(self.samples)
        path = os.path.join(self.label, f"shard.{self.rank:05d}.gpk")
        tmp = path + ".partial"
        w = PackWriter(tmp, n)
        try:
            self._pack(w)
            w.finish()
            os.replace(tmp, path)
        except Exception:
            w.abort()
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        if self.rank == 0:
            meta = dict(self.attrs)
            s0 = self.samples[0] if self.samples else None
            if s0 is not None:
                meta.setdefault("target_types", list(s0.target_types))
                meta.setdefault(
                    "target_dims",
                    [int(np.atleast_2d(t).shape[-1]) for t in s0.targets],
                )
            with open(os.path.join(self.label, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1)

    def _pack(self, w: PackWriter):
        ss = self.samples
        n = len(ss)
        nodes = np.array([s.num_nodes for s in ss], dtype=np.int64)
        edges = np.array([s.num_edges for s in ss], dtype=np.int64)
        w.add(
            "x",
            np.concatenate([s.x for s in ss]).astype(np.float32)
            if n
            else np.zeros((0, 1), np.float32),
            counts=nodes,
        )
        if n and all(s.pos is not None for s in ss):
            w.add(
                "pos",
                np.concatenate([s.pos for s in ss]).astype(np.float32),
                counts=nodes,
            )
        # edge_index stored edge-major [E, 2] so samples are contiguous
        w.add(
            "edge_index",
            np.concatenate([s.edge_index.T for s in ss]).astype(np.int64)
            if n
            else np.zeros((0, 2), np.int64),
            counts=edges,
        )
        if n and all(s.edge_attr is not None for s in ss):
            w.add(
                "edge_attr",
                np.concatenate([s.edge_attr for s in ss]).astype(np.float32),
                counts=edges,
            )
        if all(s.y is not None for s in ss) and n:
            w.add(
                "y",
                np.stack([np.ravel(s.y) for s in ss]).astype(np.float32),
            )
        if all(s.supercell_size is not None for s in ss) and n:
            w.add(
                "supercell_size",
                np.stack(
                    [np.asarray(s.supercell_size, np.float32) for s in ss]
                ),
            )
        num_heads = len(ss[0].targets) if n else 0
        for ih in range(num_heads):
            ttype = ss[0].target_types[ih]
            if ttype == "graph":
                w.add(
                    f"target{ih}",
                    np.stack(
                        [np.ravel(s.targets[ih]) for s in ss]
                    ).astype(np.float32),
                )
            else:
                w.add(
                    f"target{ih}",
                    np.concatenate(
                        [
                            np.asarray(s.targets[ih], np.float32).reshape(
                                s.num_nodes, -1
                            )
                            for s in ss
                        ]
                    ),
                    counts=nodes,
                )


def read_pack_sample(r: PackReader, i: int) -> GraphData:
    """Decode one sample out of an open :class:`PackReader` — THE gpk
    sample wire format, shared by :class:`ShardDataset` and the streaming
    shard source (``data/stream/source.py``) so the two
    paths cannot diverge."""
    d = GraphData()
    d.x = r.read("x", i)
    if "pos" in r.vars:
        d.pos = r.read("pos", i)
    d.edge_index = r.read("edge_index", i).T
    if "edge_attr" in r.vars:
        d.edge_attr = r.read("edge_attr", i)
    if "y" in r.vars:
        d.y = r.read("y", i).ravel()
    if "supercell_size" in r.vars:
        d.supercell_size = r.read("supercell_size", i).reshape(3, 3)
    ih = 0
    d.target_types = []
    while f"target{ih}" in r.vars:
        t = r.read(f"target{ih}", i)
        # variable-dim target vars (dims[0] == -1) are node heads
        is_node = r.vars[f"target{ih}"][2][0] == -1
        d.targets.append(t if is_node else t.reshape(-1))
        d.target_types.append("node" if is_node else "graph")
        ih += 1
    return d


class ShardDataset:
    """Reads every shard under ``label/``; presents a flat global index.

    ``get(i)`` is two array slices out of the mmap per variable — no pickle,
    no per-sample files, no remote fetch needed on a single host.
    """

    def __init__(self, label: str, preload: bool = False, subset=None):
        """``subset``: optional sequence of global sample indices that this
        dataset view exposes (the reference's AdiosDataset subset support,
        ``utils/adiosdataset.py:610-636``) — ``len``/``[i]`` then run over
        the subset while ``get`` keeps taking global indices."""
        self.label = label
        paths = sorted(glob.glob(os.path.join(label, "shard.*.gpk")))
        if not paths:
            raise FileNotFoundError(f"no GraphPack shards under {label}")
        # shared-filesystem opens are the reads most likely to hiccup at
        # job start (thousands of ranks hitting GPFS/NFS at once) — retry
        # with jittered backoff instead of dying on a transient EIO
        self.readers = [
            retry_io(
                lambda p=p: PackReader(p, preload=preload), what=p
            )
            for p in paths
        ]
        self._cum = np.cumsum([r.num_samples for r in self.readers])
        meta_path = os.path.join(label, "meta.json")
        self.meta: Dict[str, object] = {}
        if os.path.exists(meta_path):
            def _read_meta():
                faults.flaky_read(meta_path)
                with open(meta_path) as f:
                    return json.load(f)

            self.meta = retry_io(_read_meta, what=meta_path)
        self.target_types = list(self.meta.get("target_types", []))

        self.subset = None if subset is None else [int(i) for i in subset]

    def num_samples_total(self) -> int:
        return int(self._cum[-1]) if len(self._cum) else 0

    def graph_sizes(self) -> np.ndarray:
        """Per-sample node counts from the shard count indexes alone — no
        sample payloads are read, so dataset-wide size scans (layout
        maxima) stay cheap at millions of samples."""
        sizes = np.concatenate(
            [
                np.array(
                    [r.sample_rows("x", i) for i in range(r.num_samples)],
                    dtype=np.int64,
                )
                for r in self.readers
            ]
        ) if self.readers else np.zeros(0, np.int64)
        if self.subset is not None:
            sizes = sizes[np.asarray(self.subset, np.int64)]
        return sizes

    def __len__(self) -> int:
        if self.subset is not None:
            return len(self.subset)
        return self.num_samples_total()

    def _locate(self, idx: int):
        total = self.num_samples_total()
        if idx < 0:
            idx += total
        if not 0 <= idx < total:
            raise IndexError(idx)
        shard = int(np.searchsorted(self._cum, idx, side="right"))
        local = idx - (int(self._cum[shard - 1]) if shard else 0)
        return self.readers[shard], local

    def get(self, idx: int) -> GraphData:
        # mmap'd page faults can surface transient OSError on remote
        # filesystems; one sample read is cheap, so retry the whole thing
        return retry_io(lambda: self._get_once(idx), what=f"sample {idx}")

    def _get_once(self, idx: int) -> GraphData:
        faults.flaky_read(f"{self.label}[{idx}]")
        r, i = self._locate(idx)
        return read_pack_sample(r, i)

    def __getitem__(self, idx: int) -> GraphData:
        if self.subset is not None:
            idx = self.subset[idx]
        return self.get(idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]  # subset-relative: __getitem__ translates

    def close(self):
        for r in self.readers:
            r.close()
        self.readers = []
