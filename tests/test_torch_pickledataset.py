"""The port's per-sample pickle dataset (``data/pickledataset.py``) against
the JAX package's, on seeded numpy samples.

- A dataset written by either package reads in both to equal samples and
  an equal manifest (the port reads through ``SafeUnpickler``: the JAX
  package's ``GraphData`` loads as the port's without importing it).
- Subdirectory bucketing puts each file where the JAX package does; subset
  views, ``setsubset``, ``preload`` and ``var_config`` read as the JAX
  package's.
- A manifest that is not the versioned dict is refused as in the JAX
  package; a pickle naming another class is refused before it is built.
- Two processes (``torch.distributed``, ``gloo``) write their shares at
  the offsets of the counts' all-gather; the JAX package reads the union.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.data.pickledataset import SimplePickleDataset as JaxDataset
from hydragnn_tpu.data.pickledataset import SimplePickleWriter as JaxWriter

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.pickledataset import SimplePickleDataset, SimplePickleWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _samples(cls, n=7, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(3, 7))
        d = cls(x=rng.normal(size=(k, 3)).astype(np.float32),
                pos=rng.normal(size=(k, 3)).astype(np.float32),
                y=np.asarray([float(i), 2.0 * i], np.float32))
        d.edge_index = np.stack([np.arange(k, dtype=np.int64), (np.arange(k) + 1) % k])
        d.targets = [np.asarray([float(i)], np.float32)]
        d.target_types = ["graph"]
        out.append(d)
    return out


def _same(a, b):
    for f in ("x", "pos", "y", "edge_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.target_types == b.target_types
    for s, t in zip(a.targets, b.targets):
        np.testing.assert_array_equal(s, t)


@pytest.mark.parametrize("writer", ["port", "jax"])
def pytest_pickles_read_by_both_packages(tmp_path, writer):
    ours, theirs = _samples(GraphData), _samples(JaxGraphData)
    minmax = np.arange(6, dtype=np.float64).reshape(2, 3)
    cls, samples = (SimplePickleWriter, ours) if writer == "port" else (JaxWriter, theirs)
    cls(samples, str(tmp_path), "trainset", minmax_node_feature=minmax,
        minmax_graph_feature=minmax[:, :2], attrs={"pna_deg": [0, 3, 1]})
    mine, jaxs = SimplePickleDataset(str(tmp_path), "trainset"), JaxDataset(str(tmp_path),
                                                                            "trainset")
    assert len(mine) == len(jaxs) == 7 and mine.ntotal == jaxs.ntotal
    assert mine.attrs == jaxs.attrs == {"pna_deg": [0, 3, 1]}
    np.testing.assert_array_equal(mine.minmax_node_feature, jaxs.minmax_node_feature)
    np.testing.assert_array_equal(mine.minmax_graph_feature, minmax[:, :2])
    for a, b, want in zip(mine, jaxs, ours):
        assert type(a) is GraphData
        _same(a, want)
        _same(b, want)


def pytest_subdirectories_subsets_preload_and_var_config_as_jax(tmp_path):
    for cls, samples, label in ((SimplePickleWriter, _samples(GraphData, 9), "port"),
                                (JaxWriter, _samples(JaxGraphData, 9), "jax")):
        cls(samples, str(tmp_path / label), "total", use_subdir=True, nmax_persubdir=4)
    files = {label: sorted(os.path.relpath(os.path.join(d, f), tmp_path / label)
                           for d, _, fs in os.walk(tmp_path / label) for f in fs)
             for label in ("port", "jax")}
    assert files["port"] == files["jax"] and "2/total-8.pkl" in files["port"]
    var_config = {"type": ["graph", "node"], "output_index": [1, 0],
                  "graph_feature_dims": [1, 1], "node_feature_dims": [1, 2],
                  "input_node_features": [0]}
    for kw in ({"subset": [4, 1]}, {"preload": True}, {"var_config": var_config}):
        mine = SimplePickleDataset(str(tmp_path / "jax"), "total", **kw)
        jaxs = JaxDataset(str(tmp_path / "port"), "total", **kw)
        assert len(mine) == len(jaxs)
        for a, b in zip(mine, jaxs):
            _same(a, b)
        if "var_config" in kw:
            assert mine[0].x.shape[1] == 1 and mine[0].targets[1].shape == (mine[0].num_nodes, 1)
    mine.setsubset([2])
    jaxs.setsubset([2])
    _same(mine[0], jaxs[0])


class _Other:
    pass


def pytest_manifest_guard_and_refused_classes(tmp_path):
    with open(tmp_path / "total-meta.pkl", "wb") as f:
        pickle.dump([1, 2, 3], f)
    for cls in (SimplePickleDataset, JaxDataset):
        with pytest.raises(ValueError, match="manifest"):
            cls(str(tmp_path), "total")
    SimplePickleWriter(_samples(GraphData, 2), str(tmp_path / "ok"), "total")
    with open(tmp_path / "ok" / "total-1.pkl", "wb") as f:
        pickle.dump(_Other(), f)
    ds = SimplePickleDataset(str(tmp_path / "ok"), "total")
    assert ds[0].num_nodes > 0
    with pytest.raises(pickle.UnpicklingError, match="refusing to load"):
        ds[1]


_WRITER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from hydragnn_tpu_torch.data.dataobj import GraphData
    from hydragnn_tpu_torch.data.pickledataset import SimplePickleWriter

    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    samples = []
    for i in range(2 + rank):  # rank 0 writes 2 samples, rank 1 three
        d = GraphData(x=np.full((3, 1), 10 * rank + i, np.float32),
                      pos=np.zeros((3, 3), np.float32))
        d.edge_index = np.asarray([[0, 1], [1, 2]], np.int64)
        d.targets = [np.asarray([10.0 * rank + i], np.float32)]
        d.target_types = ["graph"]
        samples.append(d)
    SimplePickleWriter(samples, {out!r}, "total")
    dist.destroy_process_group()
""")


def pytest_two_process_writers_at_their_offsets(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "writer.py"
    script.write_text(_WRITER.format(repo=REPO, port=port, out=str(tmp_path / "ds")))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "RANK",
                                                                      "WORLD_SIZE"))}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    ds = JaxDataset(str(tmp_path / "ds"), "total")
    assert [float(d.targets[0][0]) for d in ds] == [0.0, 1.0, 10.0, 11.0, 12.0]
