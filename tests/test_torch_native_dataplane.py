"""The port's native data plane against the JAX package's: GraphPack shards
(``native/graphpack.py``, ``data/shard_store.py``), the distributed sample
store (``data/distdataset.py`` over ``native/diststore.cpp``) and the
region timer (``native/regiontimer.py``), on seeded numpy samples.

- The C++ sources are copies of the JAX package's, byte for byte, and the
  port builds its own into ``build/native/<hash>/``.
- The same samples written by either package's ``ShardWriter`` give
  byte-identical shard files and ``meta.json``; each package's
  ``ShardDataset`` reads the other's shards to equal arrays; so do the raw
  ``PackWriter`` variables (fixed and variable-length, every dtype).
- ``read_all`` is a read-only view equal to the per-sample reads; an empty
  shard and a subset view read as in the JAX package.
- Two in-process stores on free ports (bound to port 0 first, never the
  JAX tests' fixed bases) fetch each other's samples; the subgroup split
  and its index partition equal the JAX package's; four stores in two
  subgroups each serve a whole replica.
- The region timer's call tree (paths and counts) equals the JAX
  package's for the same nested regions.
"""

import filecmp
import json
import os
import socket
import sys

import numpy as np
import pytest

from hydragnn_tpu.data import distdataset as jax_dist
from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.data.shard_store import ShardDataset as JaxShardDataset
from hydragnn_tpu.data.shard_store import ShardWriter as JaxShardWriter
from hydragnn_tpu.native import graphpack as jax_graphpack
from hydragnn_tpu.native.regiontimer import NativeRegionTimer as JaxRegionTimer

from hydragnn_tpu_torch.data import distdataset
from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.shard_store import ShardDataset, ShardWriter
from hydragnn_tpu_torch.native import build, graphpack
from hydragnn_tpu_torch.native.regiontimer import NativeRegionTimer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_stream_data import family_samples  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_sample(a, b):
    for f in ("x", "pos", "edge_index", "edge_attr", "y", "supercell_size"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, f
    assert a.target_types == b.target_types
    for s, t in zip(a.targets, b.targets):
        np.testing.assert_array_equal(s, t)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def pytest_native_sources_are_the_jax_packages_copied():
    for name in ("graphpack.cpp", "diststore.cpp", "regiontimer.cpp"):
        assert filecmp.cmp(os.path.join(REPO, "hydragnn_tpu_torch", "native", name),
                           os.path.join(REPO, "hydragnn_tpu", "native", name), shallow=False)
    path = build.build_library("graphpack", ["graphpack.cpp"])
    assert path.startswith(os.path.join(REPO, "build", "native") + os.sep)
    mtime = os.path.getmtime(path)
    assert build.build_library("graphpack", ["graphpack.cpp"]) == path  # built once
    assert os.path.getmtime(path) == mtime
    assert not [f for f in os.listdir(os.path.dirname(path)) if f.endswith(".tmp")]


@pytest.mark.parametrize("writer_side", ["port", "jax"])
def pytest_shards_byte_identical_and_read_by_the_other(tmp_path, writer_side):
    ours = family_samples(GraphData, 7, 9, 3, 8, heads="graph,node")
    theirs = family_samples(JaxGraphData, 7, 9, 3, 8, heads="graph,node")
    for k, (a, b) in enumerate(zip(ours, theirs)):
        a.edge_attr = b.edge_attr = np.full((a.num_edges, 2), k, np.float32)
        a.y = b.y = np.arange(3, dtype=np.float32) + k
        a.supercell_size = b.supercell_size = np.eye(3, dtype=np.float32) * (k + 1)
    for cls, samples, label in ((ShardWriter, ours, "port"), (JaxShardWriter, theirs, "jax")):
        for rank, chunk in enumerate((samples[:5], samples[5:])):
            w = cls(str(tmp_path / label), rank=rank)
            w.add(chunk)
            w.add_global("pna_deg", np.arange(4))
            w.save()
    for name in ("shard.00000.gpk", "shard.00001.gpk", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    reader = ShardDataset if writer_side == "jax" else JaxShardDataset
    ds = reader(str(tmp_path / writer_side))
    assert len(ds) == 9 and ds.meta["pna_deg"] == [0, 1, 2, 3]
    assert ds.target_types == ["graph", "node"]
    np.testing.assert_array_equal(ds.graph_sizes(), [s.num_nodes for s in ours])
    for k in range(9):
        _same_sample(ds[k], ours[k] if writer_side == "jax" else theirs[k])
    ds.close()


def pytest_pack_variables_every_dtype_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    counts = np.asarray([2, 0, 3], np.int64)
    variables = {
        "f32": (rng.random((5, 2)).astype(np.float32), counts),
        "f64": (rng.random((3, 4)), None),
        "i32": (rng.integers(-9, 9, (5,)).astype(np.int32), counts),
        "i64": (rng.integers(-9, 9, (3, 2, 2)).astype(np.int64), None),
        "u8": (rng.integers(0, 255, (5, 3)).astype(np.uint8), counts),
    }
    for mod, name in ((graphpack, "port.gpk"), (jax_graphpack, "jax.gpk")):
        w = mod.PackWriter(str(tmp_path / name), 3)
        for var, (data, cnt) in variables.items():
            w.add(var, data, counts=cnt)
        w.finish()
    assert (tmp_path / "port.gpk").read_bytes() == (tmp_path / "jax.gpk").read_bytes()
    for mod, name in ((graphpack, "jax.gpk"), (jax_graphpack, "port.gpk")):
        r = mod.PackReader(str(tmp_path / name))
        assert r.num_samples == 3
        for var, (data, cnt) in variables.items():
            offs = np.concatenate([[0], np.cumsum(cnt)]) if cnt is not None else None
            for i in range(3):
                want = data[offs[i]:offs[i + 1]] if cnt is not None else data[i]
                got = r.read(var, i)
                np.testing.assert_array_equal(got.reshape(np.shape(want)), want)
                assert got.dtype == data.dtype
            if cnt is not None:
                np.testing.assert_array_equal(r.counts(var), cnt)
        r.close()


def pytest_bulk_view_empty_shard_and_subset(tmp_path):
    samples = family_samples(GraphData, 2, 6, 3, 7)
    w = ShardWriter(str(tmp_path / "s"), rank=0)
    w.add(samples)
    w.save()
    r = graphpack.PackReader(str(tmp_path / "s" / "shard.00000.gpk"))
    view = r.read_all("x")
    assert not view.flags.writeable
    np.testing.assert_array_equal(view, np.concatenate([s.x for s in samples]))
    own = r.read("x", 0)
    own[0, 0] = -1.0  # a per-sample read is a writeable copy
    assert view[0, 0] == samples[0].x[0, 0]
    assert r.sample_rows("edge_index", 2) == samples[2].num_edges
    r.close()
    # an empty shard beside a full one, and a subset view, in both packages
    for cls, label in ((ShardWriter, "port"), (JaxShardWriter, "jax")):
        w = cls(str(tmp_path / label), rank=0)
        w.add(samples[:3])
        w.save()
        cls(str(tmp_path / label), rank=1).save()
    assert ((tmp_path / "port" / "shard.00001.gpk").read_bytes()
            == (tmp_path / "jax" / "shard.00001.gpk").read_bytes())
    ours = ShardDataset(str(tmp_path / "jax"), subset=[2, 0])
    theirs = JaxShardDataset(str(tmp_path / "port"), subset=[2, 0])
    assert len(ours) == len(theirs) == 2 and ours.num_samples_total() == 3
    np.testing.assert_array_equal(ours.graph_sizes(), theirs.graph_sizes())
    for a, b in zip(ours, theirs):
        _same_sample(a, b)
    with pytest.raises(IndexError):
        ours.get(3)
    with pytest.raises(FileNotFoundError):
        ShardDataset(str(tmp_path / "none"))


def pytest_distributed_store_fetches_and_subgroups(tmp_path):
    samples = family_samples(GraphData, 4, 10, 3, 9, heads="graph,node")
    # the subgroup split and its partition are the JAX package's
    for world in (1, 4, 5):
        for width in (None, 2, 3):
            for rank in range(world):
                assert (distdataset.subgroup_of(rank, world, width)
                        == jax_dist.subgroup_of(rank, world, width))
                assert (list(distdataset.subgroup_local_indices(10, rank, world, width))
                        == list(jax_dist.subgroup_local_indices(10, rank, world, width)))
    nodes = max(s.num_nodes for s in samples)
    edges = max(s.num_edges for s in samples)
    # two stores, one process: each fetches the other's samples over TCP
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    stores = [distdataset.DistDataset(part, rank=k, world=2, addresses=addrs,
                                      samples_per_rank=[4, 6],
                                      max_counts={"nodes": nodes, "edges": edges})
              for k, part in enumerate((samples[:4], samples[4:]))]
    try:
        for s in stores:
            s.epoch_begin()
        for s in stores:
            assert len(s) == 10
            for i in range(10):
                _same_sample(s[i], samples[i])
        with pytest.raises(IndexError):
            stores[0][10]
    finally:
        for s in stores:
            s.epoch_end()
            s.close()
    # four ranks in two subgroups of 2: each subgroup holds a whole replica
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(4)]
    parts = [list(distdataset.subgroup_local_indices(10, r, 4, 2)) for r in range(4)]
    stores = [distdataset.DistDataset([samples[i] for i in parts[r]], rank=r, world=4,
                                      addresses=addrs, subgroup_width=2,
                                      samples_per_rank=[len(parts[2 * (r // 2)]),
                                                        len(parts[2 * (r // 2) + 1])],
                                      max_counts={"nodes": nodes, "edges": edges})
              for r in range(4)]
    try:
        for s in stores:
            s.epoch_begin()
        for r in (1, 2):
            assert stores[r].store.group_index == r // 2 and len(stores[r]) == 10
            for i in range(10):
                _same_sample(stores[r][i], samples[i])
    finally:
        for s in stores:
            s.epoch_end()
            s.close()


def pytest_region_timer_call_tree_as_jax(tmp_path):
    trees = []
    for cls in (NativeRegionTimer, JaxRegionTimer):
        t = cls()
        for _ in range(3):
            t.start("train")
            for _ in range(2):
                t.start("dataload")
                t.stop("dataload")
                t.start("train_step")
                t.stop("train_step")
            t.stop("train")
        t.start("eval")
        t.stop("eval")
        totals = t.totals()
        trees.append({p: t.count(p) for p in totals})
        assert all(v >= 0.0 for v in totals.values())
        t.pr_file(str(tmp_path / f"{cls.__module__}.txt"))
        t.chrome_trace(str(tmp_path / f"{cls.__module__}.json"))
        events = json.loads((tmp_path / f"{cls.__module__}.json").read_text())
        assert len(events["traceEvents"] if isinstance(events, dict) else events) >= 16
    assert trees[0] == trees[1] == {"train": 3, "train/dataload": 6, "train/train_step": 6,
                                    "eval": 1}
