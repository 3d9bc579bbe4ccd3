"""DistDataset — dataset spread across host RAM with remote fetch (port of
``data/distdataset.py``, over the port's copy of ``native/diststore.cpp``).

Parity with the reference's DDStore-backed ``DistDataset``
(``hydragnn/utils/distdataset.py:22-183``): each process contributes its
local shard of samples; the store presents the global index space and
``get(i)`` transparently fetches from the owning process (C++ TCP transport,
``native/diststore.cpp``) inside epoch_begin/epoch_end windows — the same
double-buffered usage the reference drives in its hot loop
(``train/train_validate_test.py:459-536``).

The counts exchange and the maxima go over ``torch.distributed`` when a
group is initialised (``parallel/distributed.py``); in one process they
are the process's own, or the caller's ``samples_per_rank`` and
``max_counts``. Ports are the caller's (``addresses`` or ``base_port``);
without them a deterministic block counter picks them, so SPMD processes
that create stores in the same order agree on every store's ports.
"""

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.native.build import load_library
from hydragnn_tpu_torch.parallel.distributed import host_allgather_int
from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("diststore", ["diststore.cpp"])
    lib.dds_create.restype = ctypes.c_void_p
    lib.dds_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
    lib.dds_set_partition.restype = ctypes.c_int
    lib.dds_set_partition.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dds_add_var.restype = ctypes.c_int
    lib.dds_add_var.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p,
        ctypes.c_uint64,
    ]
    lib.dds_epoch_begin.restype = ctypes.c_int
    lib.dds_epoch_begin.argtypes = [ctypes.c_void_p]
    lib.dds_epoch_end.restype = ctypes.c_int
    lib.dds_epoch_end.argtypes = [ctypes.c_void_p]
    lib.dds_get.restype = ctypes.c_int64
    lib.dds_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dds_total_samples.restype = ctypes.c_int64
    lib.dds_total_samples.argtypes = [ctypes.c_void_p]
    lib.dds_local_max_bytes.restype = ctypes.c_uint64
    lib.dds_local_max_bytes.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.dds_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


# Each store instance needs its own port block (one port per rank). The
# counter is deterministic, so SPMD processes creating stores in the same
# order (train/val/test) agree on every instance's ports.
_PORT_BLOCKS = iter(range(10_000))


def subgroup_of(rank: int, world: int, width: Optional[int]):
    """(group, group_rank, group_size, group_start) for a ``ddstore_width``
    style split: consecutive blocks of ``width`` ranks form replication
    subgroups (reference: ``hydragnn/utils/distdataset.py:43-46`` splits the
    MPI world by ``rank // ddstore_width``). The trailing group may be
    smaller when ``world % width != 0``."""
    if width is None or width <= 0 or width >= world:
        return 0, rank, world, 0
    group = rank // width
    start = group * width
    return group, rank - start, min(width, world - start), start


def subgroup_local_indices(
    n_total: int, rank: int, world: int, width: Optional[int] = None
) -> range:
    """Global sample indices THIS rank loads so every subgroup of ``width``
    ranks collectively holds the FULL dataset (samples replicate across
    subgroups; each subgroup partitions them contiguously). With no width
    this is the plain contiguous world partition."""
    _, grank, gsize, _ = subgroup_of(rank, world, width)
    base, rem = divmod(n_total, gsize)
    start = grank * base + min(grank, rem)
    return range(start, start + base + (1 if grank < rem else 0))


class DistSampleStore:
    """Low-level variable-oriented store (pyddstore.PyDDStore parity).

    ``subgroup_width`` is the ``ddstore_width`` analog: the world splits
    into consecutive blocks of that many ranks, each block serving a full
    replica of the dataset partitioned among its members, so every get()
    resolves within the caller's block (node-local at pod scale). The C++
    core is simply instantiated with the subgroup as its world — ranks
    outside the block are not even in its address list, making
    cross-subgroup traffic impossible by construction."""

    def __init__(
        self,
        rank: int,
        world: int,
        addresses: Optional[List[str]] = None,
        base_port: Optional[int] = None,
        subgroup_width: Optional[int] = None,
    ):
        self._lib = _load()
        self.global_rank = rank
        self.global_world = world
        if base_port is None:
            base_port = 33450 + next(_PORT_BLOCKS) * world
        if addresses is None:
            addresses = [f"127.0.0.1:{base_port + r}" for r in range(world)]
        if len(addresses) != world:
            raise ValueError(
                f"need {world} addresses (one per GLOBAL rank), got "
                f"{len(addresses)}"
            )
        group, grank, gsize, gstart = subgroup_of(rank, world, subgroup_width)
        self.group_index = group
        self.group_start = gstart
        addresses = addresses[gstart : gstart + gsize]
        rank, world = grank, gsize
        self.rank = rank
        self.world = world
        self._h = self._lib.dds_create(
            rank, world, ",".join(addresses).encode()
        )
        if not self._h:
            raise RuntimeError("dds_create failed (bad address list?)")
        self._vars: Dict[str, Tuple[int, np.dtype, Tuple[int, ...], int]] = {}
        self._partitioned = False

    def set_partition(self, samples_per_rank: List[int]):
        arr = (ctypes.c_int64 * self.world)(*samples_per_rank)
        self._lib.dds_set_partition(self._h, arr)
        self._partitioned = True

    def add(
        self,
        name: str,
        data: np.ndarray,
        counts: np.ndarray,
        max_row_count: Optional[int] = None,
    ):
        """Add the LOCAL partition of variable ``name``: ``data`` is the
        concatenation along dim 0, ``counts[i]`` the per-local-sample extent.
        ``max_row_count`` must be the GLOBAL max (host-allgathered by the
        caller when world > 1); defaults to the local max."""
        assert self._partitioned, "call set_partition first"
        data = np.ascontiguousarray(data)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        row_bytes = data.dtype.itemsize * int(
            np.prod(data.shape[1:], dtype=np.int64)
        )
        vid = self._lib.dds_add_var(
            self._h,
            name.encode(),
            row_bytes,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            data.ctypes.data_as(ctypes.c_void_p),
            data.nbytes,
        )
        if vid < 0:
            raise ValueError(f"dds_add_var({name}) failed: {vid}")
        gmax = int(max_row_count if max_row_count is not None
                   else (counts.max() if counts.size else 0))
        self._vars[name] = (vid, data.dtype, tuple(data.shape[1:]), gmax)

    def epoch_begin(self):
        rc = self._lib.dds_epoch_begin(self._h)
        if rc != 0:
            raise RuntimeError(f"dds_epoch_begin failed: {rc}")

    def epoch_end(self):
        self._lib.dds_epoch_end(self._h)

    def get(self, name: str, gidx: int) -> np.ndarray:
        vid, dtype, trailing, gmax = self._vars[name]
        row_bytes = dtype.itemsize * int(np.prod(trailing, dtype=np.int64))
        cap = max(1, gmax * row_bytes)
        out = np.empty(cap, dtype=np.uint8)
        nbytes = ctypes.c_uint64()
        rows = self._lib.dds_get(
            self._h,
            vid,
            gidx,
            out.ctypes.data_as(ctypes.c_void_p),
            cap,
            ctypes.byref(nbytes),
        )
        if rows < 0:
            raise RuntimeError(f"dds_get({name}, {gidx}) failed: {rows}")
        return (
            out[: nbytes.value]
            .view(dtype)
            .reshape((int(rows),) + trailing)
            .copy()
        )

    def __len__(self) -> int:
        return int(self._lib.dds_total_samples(self._h))

    def close(self):
        if self._h:
            self._lib.dds_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _gather_partition(local_count: int, world: int) -> List[int]:
    """All-processes sample counts: an all-gather over
    ``torch.distributed``; one process: trivial."""
    if world == 1:
        return [local_count]
    return host_allgather_int(local_count)


def _multiprocess() -> bool:
    return comm_size_and_rank()[0] > 1


def _allreduce(values: np.ndarray, op: str) -> np.ndarray:
    """Elementwise ``min`` or ``max`` of an int64 vector over the
    processes (an object all-gather, which every ``torch.distributed``
    backend carries)."""
    import torch.distributed as dist

    out = [None] * comm_size_and_rank()[0]
    dist.all_gather_object(out, np.asarray(values, np.int64))
    stacked = np.stack(out)
    return stacked.min(axis=0) if op == "min" else stacked.max(axis=0)


def _reduce_max(value: int) -> int:
    if not _multiprocess():
        return int(value)
    return int(_allreduce(np.asarray([value], np.int64), "max")[0])


def _resolve_schema(ss: List[GraphData]) -> Dict[str, object]:
    """Globally-consistent variable schema so every process registers the
    SAME var-id sequence (the wire protocol ships ordinal ids). A process
    with zero local samples adopts the schema the others agree on; presence
    flags are AND-reduced across processes, dims/num_heads MAX-reduced."""
    n = len(ss)
    num_heads_local = len(ss[0].targets) if n else 0
    slots = _reduce_max(num_heads_local)
    local = np.zeros(8 + 2 * max(slots, 1), np.int64)
    if n:
        local[0] = int(all(s.pos is not None for s in ss))
        local[1] = int(all(s.edge_attr is not None for s in ss))
        local[2] = int(all(s.y is not None for s in ss))
        local[3] = len(ss[0].targets)
        local[4] = ss[0].x.shape[1]
        local[5] = (
            ss[0].edge_attr.shape[1] if ss[0].edge_attr is not None else 0
        )
        local[6] = np.ravel(ss[0].y).shape[0] if ss[0].y is not None else 0
        for ih in range(num_heads_local):
            local[8 + 2 * ih] = int(ss[0].target_types[ih] == "node")
            local[8 + 2 * ih + 1] = int(
                np.atleast_2d(ss[0].targets[ih]).shape[-1]
            )
    else:
        local[0] = local[1] = local[2] = 1  # neutral for the AND-reduce
    if _multiprocess():
        flags = _allreduce(local[:3], "min")
        rest = _allreduce(local[3:], "max")
        local = np.concatenate([flags, rest])
    elif n == 0:
        local[:3] = 0  # nothing to serve, nothing to agree with
    return {
        "has_pos": bool(local[0]),
        "has_edge_attr": bool(local[1]),
        "has_y": bool(local[2]),
        "num_heads": int(local[3]),
        "x_dim": max(int(local[4]), 1),
        "edge_dim": max(int(local[5]), 1),
        "y_dim": max(int(local[6]), 1),
        "target_types": [
            "node" if local[8 + 2 * ih] else "graph"
            for ih in range(int(local[3]))
        ],
        "target_dims": [
            max(int(local[8 + 2 * ih + 1]), 1)
            for ih in range(int(local[3]))
        ],
    }


class DistDataset:
    """GraphData-level distributed dataset over ``DistSampleStore``.

    Each process passes its LOCAL samples; ``len()`` is global and
    ``get(i)`` works for any global index during an epoch window.
    """

    FIELDS = ("x", "pos", "edge_index", "edge_attr")

    def __init__(
        self,
        local_samples: List[GraphData],
        rank: int = 0,
        world: int = 1,
        addresses: Optional[List[str]] = None,
        samples_per_rank: Optional[List[int]] = None,
        base_port: Optional[int] = None,
        max_counts: Optional[Dict[str, int]] = None,
        subgroup_width: Optional[int] = None,
    ):
        """``subgroup_width``: replicate the dataset across blocks of that
        many ranks (``ddstore_width`` analog) — pass ``local_samples``
        sharded by :func:`subgroup_local_indices` so each block holds a
        full replica; ``samples_per_rank`` / the gathered partition then
        describe the caller's OWN subgroup."""
        self.store = DistSampleStore(
            rank, world, addresses, base_port, subgroup_width=subgroup_width
        )
        if samples_per_rank is None:
            per_global_rank = _gather_partition(len(local_samples), world)
            g0 = self.store.group_start
            samples_per_rank = per_global_rank[g0 : g0 + self.store.world]
        elif len(samples_per_rank) != self.store.world:
            raise ValueError(
                f"samples_per_rank must cover the subgroup "
                f"({self.store.world} ranks), got {len(samples_per_rank)}"
            )
        self.store.set_partition(samples_per_rank)
        ss = local_samples
        n = len(ss)
        max_counts = max_counts or {}
        schema = _resolve_schema(ss)
        nodes = np.array([s.num_nodes for s in ss], dtype=np.int64)
        edges = np.array([s.num_edges for s in ss], dtype=np.int64)
        ones = np.ones(n, dtype=np.int64)
        # receive buffers must cover the GLOBAL max sample size — reduce the
        # local maxima across processes unless the caller supplied them
        max_nodes = max_counts.get(
            "nodes", _reduce_max(int(nodes.max()) if n else 0)
        )
        max_edges = max_counts.get(
            "edges", _reduce_max(int(edges.max()) if n else 0)
        )

        def _cat(getter, dtype, cols):
            if not n:
                return np.zeros((0, cols), dtype)
            return np.concatenate([getter(s) for s in ss]).astype(dtype)

        self.store.add(
            "x", _cat(lambda s: s.x, np.float32, schema["x_dim"]),
            nodes, max_nodes,
        )
        self._has = {"x": True}
        self._has["pos"] = schema["has_pos"]
        if self._has["pos"]:
            self.store.add(
                "pos", _cat(lambda s: s.pos, np.float32, 3), nodes, max_nodes
            )
        self.store.add(
            "edge_index",
            _cat(lambda s: s.edge_index.T, np.int64, 2),
            edges,
            max_edges,
        )
        self._has["edge_attr"] = schema["has_edge_attr"]
        if self._has["edge_attr"]:
            self.store.add(
                "edge_attr",
                _cat(lambda s: s.edge_attr, np.float32, schema["edge_dim"]),
                edges,
                max_edges,
            )
        self._has["y"] = schema["has_y"]
        if self._has["y"]:
            self.store.add(
                "y",
                np.stack([np.ravel(s.y) for s in ss]).astype(np.float32)
                if n
                else np.zeros((0, schema["y_dim"]), np.float32),
                ones,
                1,
            )
        self.num_heads = schema["num_heads"]
        self.target_types = list(schema["target_types"])
        for ih in range(self.num_heads):
            dim = schema["target_dims"][ih]
            if self.target_types[ih] == "graph":
                self.store.add(
                    f"target{ih}",
                    np.stack([np.ravel(s.targets[ih]) for s in ss]).astype(
                        np.float32
                    )
                    if n
                    else np.zeros((0, dim), np.float32),
                    ones,
                    1,
                )
            else:
                self.store.add(
                    f"target{ih}",
                    np.concatenate(
                        [
                            np.asarray(s.targets[ih], np.float32).reshape(
                                s.num_nodes, -1
                            )
                            for s in ss
                        ]
                    )
                    if n
                    else np.zeros((0, dim), np.float32),
                    nodes,
                    max_nodes,
                )

        self._local_graph_sizes = nodes

    def graph_sizes(self) -> np.ndarray:
        """LOCAL per-sample node counts, index-only (no store traffic).

        Size statistics over a DistDataset must come from here — walking
        global indices would pull the whole dataset over the store
        transport and require an open epoch window. The method's presence
        also marks the dataset as store-backed for config derivation's
        cheap/expensive-scan gates (``utils/config.py``)."""
        return self._local_graph_sizes

    def epoch_begin(self):
        self.store.epoch_begin()

    def epoch_end(self):
        self.store.epoch_end()

    def __len__(self) -> int:
        return len(self.store)

    def get(self, idx: int) -> GraphData:
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            # IndexError (not RuntimeError) so sequence-protocol iteration
            # terminates like any list-ish dataset
            raise IndexError(idx)
        d = GraphData()
        d.x = self.store.get("x", idx)
        if self._has["pos"]:
            d.pos = self.store.get("pos", idx)
        d.edge_index = self.store.get("edge_index", idx).T
        if self._has["edge_attr"]:
            d.edge_attr = self.store.get("edge_attr", idx)
        if self._has["y"]:
            d.y = self.store.get("y", idx).ravel()
        for ih in range(self.num_heads):
            t = self.store.get(f"target{ih}", idx)
            if self.target_types[ih] == "graph":
                t = t.ravel()
            d.targets.append(t)
        d.target_types = list(self.target_types)
        return d

    def __getitem__(self, idx: int) -> GraphData:
        return self.get(idx)

    def close(self):
        self.store.close()
