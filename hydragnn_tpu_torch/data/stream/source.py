"""Shard-granular lazy dataset sources — the streaming data plane's
read layer (port of ``data/stream/source.py``, on the port's readers).

A :class:`StreamSource` exposes a dataset as an ordered list of SHARDS
(the unit of I/O, shuffling, and host-RAM residency): ``read_shard(i)``
materializes one shard's samples and nothing else, so a pipeline holding
a window of W shards never has more than W shards' samples resident no
matter how large the dataset is — the role ADIOS2 spans + DDStore chunk
fetches play in the reference's data plane (PAPER.md L3).

Sources over the existing backends:

- :class:`ShardStoreSource` — one GraphPack ``shard.*.gpk`` file per
  shard (the native store; index-only size scans, decode shared with
  ``ShardDataset`` via :func:`~hydragnn_tpu_torch.data.shard_store.
  read_pack_sample`). Its shards are in ``sorted(glob(...))`` order, which
  is lexical (``shard.10`` before ``shard.2``), as in the JAX package: the
  mix's permutations index into that order.
- :class:`ExtxyzSource` — one ``.extxyz`` file per shard; frames parse
  WITHOUT graph construction, the radius graph (PBC-aware) is attached
  as a per-sample pipeline stage (:attr:`StreamSource.graph_builder`) so
  neighbor search overlaps the device step instead of gating startup.
- :class:`MPTrjSource` / :class:`QM9RawSource` — sequential-format
  backends (one growing JSON / one SDF): shards are fixed-size record
  ranges; ``seekable=False`` keeps the per-pass shard order sequential
  (re-scanning a tens-of-GB JSON per random access would thrash), while
  window shuffling still decorrelates samples.
- :class:`ListSource` — in-memory list chunked into synthetic shards
  (tests, benchmarks, small datasets entering a mixed run).

``graph_builder`` (None = samples are complete) is applied per sample by
the stream pipeline AFTER the shard read — on-the-fly construction is a
stage, not a property of the reader.
"""

import glob
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.utils.retry import retry_io


def sample_nbytes(d: GraphData) -> int:
    """Host bytes one sample pins while buffered (the window-residency
    accounting's unit)."""
    total = 0
    for a in (d.x, d.pos, d.y, d.edge_index, d.edge_attr, d.supercell_size):
        if a is not None:
            total += np.asarray(a).nbytes
    for t in d.targets:
        total += np.asarray(t).nbytes
    return total


class StreamSource:
    """Protocol base. Subclasses set ``name``/``seekable`` and implement
    :meth:`num_shards` / :meth:`read_shard`; the optional cheap paths
    (:meth:`num_samples`, :meth:`size_scan`) have scanning defaults."""

    name: str = "source"
    #: seekable sources support random shard access at no extra cost, so
    #: the per-pass shard permutation applies; sequential formats keep
    #: file order (window shuffle still randomizes within the window)
    seekable: bool = True
    #: applied per sample by the pipeline (None = samples arrive complete)
    graph_builder: Optional[Callable[[GraphData], GraphData]] = None

    def num_shards(self) -> int:
        raise NotImplementedError

    def read_shard(self, i: int) -> List[GraphData]:
        raise NotImplementedError

    def num_samples(self) -> int:
        """Total samples (drives the default epoch budget). Default: one
        counting pass over all shards — override where an index makes it
        cheap."""
        if not hasattr(self, "_num_samples_cache"):
            self._num_samples_cache = sum(
                len(self.read_shard(i)) for i in range(self.num_shards())
            )
        return self._num_samples_cache

    def size_scan(self, max_shards: Optional[int] = None):
        """(node_counts, edge_counts) over up to ``max_shards`` shards —
        the :class:`~hydragnn_tpu_torch.data.stream.planner.BucketPlanner`'s
        histogram feed. The default materializes the sampled shards (and
        runs ``graph_builder`` so edge counts are real); index-backed
        sources override with a no-payload scan."""
        n_shards = self.num_shards()
        take = n_shards if max_shards is None else min(max_shards, n_shards)
        nodes, edges = [], []
        for i in range(take):
            for d in self.read_shard(i):
                if self.graph_builder is not None:
                    d = self.graph_builder(d)
                nodes.append(d.num_nodes)
                edges.append(d.num_edges)
        return np.asarray(nodes, np.int64), np.asarray(edges, np.int64)

    def probe_samples(self, limit: int = 64) -> List[GraphData]:
        """First-shard samples with graphs built — head-schema probes and
        example batches, WITHOUT touching any stream cursor."""
        out = []
        for d in self.read_shard(0)[:limit]:
            if self.graph_builder is not None:
                d = self.graph_builder(d)
            out.append(d)
        return out

    def close(self):
        pass


class ListSource(StreamSource):
    """In-memory samples chunked into synthetic shards."""

    def __init__(self, samples: Sequence[GraphData], shard_size: int = 64,
                 name: str = "list"):
        if shard_size < 1:
            raise ValueError("shard_size must be >= 1")
        self.samples = list(samples)
        self.shard_size = int(shard_size)
        self.name = name

    def num_shards(self) -> int:
        return max(-(-len(self.samples) // self.shard_size), 1)

    def read_shard(self, i: int) -> List[GraphData]:
        lo = i * self.shard_size
        return self.samples[lo : lo + self.shard_size]

    def num_samples(self) -> int:
        return len(self.samples)


class ShardStoreSource(StreamSource):
    """GraphPack shard store (``<label>/shard.*.gpk``), one file = one
    shard. Readers open on demand in :meth:`read_shard` and close after
    decoding — at no point does the source pin more than the shard being
    read (vs ``ShardDataset``, which opens every shard's mmap up front
    for O(1) global indexing)."""

    def __init__(self, label: str, name: Optional[str] = None):
        self.label = label
        self.paths = sorted(glob.glob(os.path.join(label, "shard.*.gpk")))
        if not self.paths:
            raise FileNotFoundError(f"no GraphPack shards under {label}")
        self.name = name or os.path.basename(os.path.normpath(label))
        self._counts: Optional[List[int]] = None

    def num_shards(self) -> int:
        return len(self.paths)

    def _open(self, i: int):
        from hydragnn_tpu_torch.native.graphpack import PackReader

        path = self.paths[i]
        return retry_io(lambda: PackReader(path), what=path)

    def read_shard(self, i: int) -> List[GraphData]:
        from hydragnn_tpu_torch.data.shard_store import read_pack_sample

        r = self._open(i)
        try:
            return [read_pack_sample(r, k) for k in range(r.num_samples)]
        finally:
            r.close()

    def _shard_counts(self) -> List[int]:
        if self._counts is None:
            counts = []
            for i in range(len(self.paths)):
                r = self._open(i)
                try:
                    counts.append(int(r.num_samples))
                finally:
                    r.close()
            self._counts = counts
        return self._counts

    def num_samples(self) -> int:
        return sum(self._shard_counts())

    def size_scan(self, max_shards: Optional[int] = None):
        """Index-only: row counts come from the pack's count tables, no
        sample payload is decoded — a full-store scan stays cheap at
        millions of samples."""
        n_shards = len(self.paths)
        take = n_shards if max_shards is None else min(max_shards, n_shards)
        nodes, edges = [], []
        for i in range(take):
            r = self._open(i)
            try:
                for k in range(r.num_samples):
                    nodes.append(r.sample_rows("x", k))
                    edges.append(r.sample_rows("edge_index", k))
            finally:
                r.close()
        return np.asarray(nodes, np.int64), np.asarray(edges, np.int64)


class ExtxyzSource(StreamSource):
    """Extended-XYZ files, one file = one shard. Frames parse into
    edge-LESS samples (z/pos/cell + energy/forces targets); the radius
    graph attaches via :attr:`graph_builder` as a pipeline stage — the
    first streaming run pays neighbor search per window, overlapped with
    training, instead of as a startup pass over the whole dataset."""

    def __init__(
        self,
        dirpath: Optional[str] = None,
        files: Optional[List[str]] = None,
        radius: float = 6.0,
        max_neighbours: int = 50,
        energy_per_atom: bool = True,
        energy_key: str = "energy",
        forces_norm_threshold: Optional[float] = 100.0,
        name: Optional[str] = None,
    ):
        if files is None:
            if dirpath is None:
                raise ValueError("need dirpath or files")
            files = [
                os.path.join(dirpath, fn)
                for fn in sorted(os.listdir(dirpath))
                if fn.endswith(".extxyz") or fn.endswith(".xyz")
            ]
        if not files:
            raise FileNotFoundError(f"no extxyz files under {dirpath!r}")
        self.files = files
        self.radius = float(radius)
        self.max_neighbours = int(max_neighbours)
        self.energy_per_atom = bool(energy_per_atom)
        self.energy_key = energy_key
        self.forces_norm_threshold = forces_norm_threshold
        self.name = name or (
            os.path.basename(os.path.normpath(dirpath)) if dirpath
            else "extxyz"
        )
        self.graph_builder = self._build_graph
        self._counts: Optional[List[int]] = None

    def num_shards(self) -> int:
        return len(self.files)

    def read_shard(self, i: int) -> List[GraphData]:
        from hydragnn_tpu_torch.data.extxyz import iter_extxyz

        out = []
        for frame in iter_extxyz(self.files[i]):
            forces = frame["arrays"].get("forces")
            if (
                self.forces_norm_threshold is not None
                and forces is not None
                and len(forces)
                and np.linalg.norm(forces, axis=1).max()
                > self.forces_norm_threshold
            ):
                continue
            if self.energy_key not in frame["info"]:
                raise KeyError(
                    f"{self.files[i]}: frame has no "
                    f"{self.energy_key!r} in its comment line"
                )
            d = GraphData(
                x=frame["z"].astype(np.float32).reshape(-1, 1),
                pos=frame["pos"].astype(np.float32),
                supercell_size=None
                if frame.get("cell") is None
                else np.asarray(frame["cell"], np.float32),
            )
            energy = float(frame["info"][self.energy_key])
            if self.energy_per_atom:
                energy /= max(d.num_nodes, 1)
            d.targets = [np.asarray([energy], np.float32)]
            d.target_types = ["graph"]
            if forces is not None and len(forces):
                d.targets.append(np.asarray(forces, np.float32))
                d.target_types.append("node")
            # the builder stage needs the per-axis pbc mask AND the
            # full-precision cell: frame_to_graph runs neighbor search on
            # the f64 lattice, and the streamed path must produce
            # bit-identical edge lengths (supercell_size is the f32 model
            # input, not the search geometry)
            d.extras["pbc"] = np.asarray(frame["pbc"], bool)
            if frame.get("cell") is not None:
                d.extras["cell"] = np.asarray(frame["cell"], np.float64)
            out.append(d)
        return out

    def _build_graph(self, d: GraphData) -> GraphData:
        """On-the-fly radius graph (PBC-aware), matching
        ``extxyz.frame_to_graph``'s edge construction exactly — the
        materialized and streamed paths must produce identical neighbor
        lists (regression-locked by the PBC shard-boundary tests)."""
        from hydragnn_tpu_torch.data.radius_graph import (
            radius_graph,
            radius_graph_pbc,
        )

        pbc = d.extras.get("pbc")
        cell = d.extras.get("cell")
        if cell is not None and pbc is not None and bool(np.any(pbc)):
            edge_index, lengths = radius_graph_pbc(
                d.pos.astype(np.float64),
                cell,
                self.radius,
                self.max_neighbours,
                pbc=pbc,
            )
        else:
            edge_index = radius_graph(d.pos, self.radius, self.max_neighbours)
            lengths = np.linalg.norm(
                d.pos[edge_index[0]] - d.pos[edge_index[1]], axis=1
            )
        d.edge_index = edge_index
        d.edge_attr = np.asarray(lengths, np.float32).reshape(-1, 1)
        return d

    def num_samples(self) -> int:
        # frame-count scan (headers only advance the parse; frames are
        # small text blocks) — done once, cached
        if self._counts is None:
            from hydragnn_tpu_torch.data.extxyz import iter_extxyz

            self._counts = [
                sum(1 for _ in iter_extxyz(p)) for p in self.files
            ]
        return sum(self._counts)


class MPTrjSource(StreamSource):
    """MPtrj JSON: shards are fixed-size runs of mp_id entries in file
    order. The format is one sequential JSON object (no random access
    without an offset index), so ``seekable=False``: passes walk entries
    in order and ``read_shard`` streams to its range — each shard read is
    O(prefix), which the sequential consumption pattern keeps amortized
    (the window advances monotonically within a pass)."""

    seekable = False

    def __init__(
        self,
        path: str,
        entries_per_shard: int = 16,
        radius: float = 5.0,
        max_neighbours: int = 50,
        energy_per_atom: bool = True,
        forces_norm_threshold: Optional[float] = 100.0,
        name: Optional[str] = None,
    ):
        self.path = path
        self.entries_per_shard = max(int(entries_per_shard), 1)
        self.radius = float(radius)
        self.max_neighbours = int(max_neighbours)
        self.energy_per_atom = bool(energy_per_atom)
        self.forces_norm_threshold = forces_norm_threshold
        self.name = name or os.path.basename(path)
        self.graph_builder = self._build_graph
        self._num_entries: Optional[int] = None
        self._num_samples_scan: Optional[int] = None

    def _count_entries(self) -> int:
        from hydragnn_tpu_torch.data.mptrj import iter_mptrj_entries

        if self._num_entries is None:
            n_e = n_s = 0
            for _, frames in iter_mptrj_entries(self.path):
                n_e += 1
                n_s += len(frames)
            self._num_entries = n_e
            self._num_samples_scan = n_s
        return self._num_entries

    def num_shards(self) -> int:
        return max(-(-self._count_entries() // self.entries_per_shard), 1)

    def num_samples(self) -> int:
        self._count_entries()
        return int(self._num_samples_scan or 0)

    def read_shard(self, i: int) -> List[GraphData]:
        from hydragnn_tpu_torch.data.mptrj import (
            iter_mptrj_entries,
            structure_from_dict,
        )

        lo = i * self.entries_per_shard
        hi = lo + self.entries_per_shard
        out: List[GraphData] = []
        for k, (mp_id, frames) in enumerate(iter_mptrj_entries(self.path)):
            if k < lo:
                continue
            if k >= hi:
                break
            for frame_id, rec in frames.items():
                z, pos, _lattice = structure_from_dict(rec["structure"])
                forces = np.asarray(rec.get("force", []), np.float64)
                if (
                    self.forces_norm_threshold is not None
                    and forces.size
                    and np.linalg.norm(forces, axis=1).max()
                    > self.forces_norm_threshold
                ):
                    continue
                if self.energy_per_atom:
                    energy = rec.get("energy_per_atom")
                    if energy is None:
                        energy = rec["corrected_total_energy"] / len(z)
                else:
                    energy = rec.get("corrected_total_energy")
                    if energy is None:
                        energy = rec["energy_per_atom"] * len(z)
                posf = pos.astype(np.float32)
                d = GraphData(
                    x=np.concatenate(
                        [
                            z.astype(np.float32).reshape(-1, 1),
                            posf - posf.mean(axis=0, keepdims=True),
                        ],
                        axis=1,
                    ),
                    pos=posf,
                )
                d.targets = [np.asarray([float(energy)], np.float32)]
                d.target_types = ["graph"]
                if forces.size:
                    d.targets.append(forces.astype(np.float32))
                    d.target_types.append("node")
                out.append(d)
        return out

    def _build_graph(self, d: GraphData) -> GraphData:
        from hydragnn_tpu_torch.data.radius_graph import radius_graph

        # non-periodic at 5 A / 50 neighbors by default — the reference's
        # deliberate choice on MPtrj bulk frames (data/mptrj.py docstring)
        d.edge_index = radius_graph(d.pos, self.radius, self.max_neighbours)
        lengths = np.linalg.norm(
            d.pos[d.edge_index[0]] - d.pos[d.edge_index[1]], axis=1
        )
        d.edge_attr = lengths.astype(np.float32).reshape(-1, 1)
        return d


class QM9RawSource(StreamSource):
    """QM9 PyG raw layout (``gdb9.sdf`` + csv + uncharacterized list):
    shards are fixed-size molecule ranges; the SDF streams block by block
    (``$$$$`` delimited) so only the shard's molecules materialize.
    Sequential format -> ``seekable=False``."""

    seekable = False

    def __init__(
        self,
        root: str,
        molecules_per_shard: int = 256,
        target_index: int = 10,
        per_atom: bool = True,
        radius: float = 7.0,
        max_neighbours: int = 5,
        name: Optional[str] = None,
    ):
        self.root = root
        self.sdf = os.path.join(root, "gdb9.sdf")
        if not os.path.exists(self.sdf):
            raise FileNotFoundError(
                f"QM9RawSource streams the sdf layout; no gdb9.sdf "
                f"under {root!r}"
            )
        self.molecules_per_shard = max(int(molecules_per_shard), 1)
        self.target_index = int(target_index)
        self.per_atom = bool(per_atom)
        self.radius = float(radius)
        self.max_neighbours = int(max_neighbours)
        self.name = name or "qm9"
        self.graph_builder = self._build_graph
        from hydragnn_tpu_torch.data.qm9_raw import (
            read_gdb9_csv,
            read_uncharacterized,
        )

        self._targets = read_gdb9_csv(self.sdf + ".csv")
        skip_path = os.path.join(root, "uncharacterized.txt")
        self._skips = set(
            read_uncharacterized(skip_path)
            if os.path.exists(skip_path)
            else []
        )

    def _iter_blocks(self):
        """Stream ``$$$$``-delimited molecule blocks without reading the
        whole SDF into memory."""
        buf: List[str] = []
        with open(self.sdf) as f:
            for line in f:
                if line.strip() == "$$$$":
                    yield "".join(buf)
                    buf = []
                else:
                    buf.append(line)
        if any(ln.strip() for ln in buf):
            yield "".join(buf)

    def num_molecules(self) -> int:
        return int(self._targets.shape[0])

    def num_shards(self) -> int:
        return max(
            -(-self.num_molecules() // self.molecules_per_shard), 1
        )

    def num_samples(self) -> int:
        n = self.num_molecules()
        return n - sum(1 for s in self._skips if s < n)

    def read_shard(self, i: int) -> List[GraphData]:
        from hydragnn_tpu_torch.data.elements import atomic_number
        from hydragnn_tpu_torch.data.qm9_raw import parse_sdf_v2000

        lo = i * self.molecules_per_shard
        hi = lo + self.molecules_per_shard
        out: List[GraphData] = []
        for mi, block in enumerate(self._iter_blocks()):
            if mi < lo:
                continue
            if mi >= hi:
                break
            if mi in self._skips:
                continue
            parsed = parse_sdf_v2000(block + "$$$$\n")
            if not parsed:
                continue
            syms, pos, _bonds = parsed[0]
            z = np.asarray(
                [atomic_number(s) for s in syms], dtype=np.float32
            )
            y = self._targets[mi]
            d = GraphData(
                x=z.reshape(-1, 1), pos=pos, y=y.astype(np.float32)
            )
            t = float(y[self.target_index])
            if self.per_atom:
                t /= len(z)
            d.targets = [np.asarray([t], np.float32)]
            d.target_types = ["graph"]
            out.append(d)
        return out

    def _build_graph(self, d: GraphData) -> GraphData:
        from hydragnn_tpu_torch.data.radius_graph import radius_graph

        d.edge_index = radius_graph(d.pos, self.radius, self.max_neighbours)
        return d
