"""The port's raw readers, periodic radius graph, knobs and public names
against the JAX package's, on the same files and arrays (numpy, made from
a seed).

- ``radius_graph_pbc``: the cases of ``tests/test_periodic_boundary_conditions.py``
  (BCC first and second shells, a dimer in a vacuum cell, a pair across
  the boundary), a slab with ``pbc="T T F"``, a jittered FCC supercell and
  the duplicate-edge guard: edges equal and in the same order, lengths
  within 1e-6 relative.
- The readers (CFG, XYZ, extxyz, MPtrj, QM9) on files the JAX package's
  writers (or the smoke's CFG generator) wrote: arrays equal; the error
  messages that ``tests/test_real_formats.py`` matches, word for word;
  the serialized PBC branch's edges and ``edge_attr``.
- The knobs: ``HYDRAGNN_FUSED_MP`` as the JAX package resolves it,
  ``HYDRAGNN_OBS_PORT`` refused, an unknown raw format's ``NameError``.
- The public names: ``graph.segment_mean/max/min/std``,
  ``plan_from_layout`` and ``ServingBucketPlan.select``,
  ``ModelRegistry.__len__``, ``print_model``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hydragnn_tpu.data import cfg as jax_cfg
from hydragnn_tpu.data import elements as jax_elements
from hydragnn_tpu.data import extxyz as jax_extxyz
from hydragnn_tpu.data import loaders as jax_loaders
from hydragnn_tpu.data import mptrj as jax_mptrj
from hydragnn_tpu.data import qm9_raw as jax_qm9
from hydragnn_tpu.data import xyz as jax_xyz
from hydragnn_tpu.data.radius_graph import radius_graph_pbc as jax_radius_graph_pbc
from hydragnn_tpu.data.serialized import SerializedGraphLoader as JaxSerializedGraphLoader
from hydragnn_tpu.graph import segment as jseg
from hydragnn_tpu.ops import autotune as jax_autotune

import chip_smoke
from hydragnn_tpu_torch import data as port_data
from hydragnn_tpu_torch import run_training
from hydragnn_tpu_torch.data import cfg, elements, extxyz, loaders, mptrj, qm9_raw, xyz
from hydragnn_tpu_torch.data.radius_graph import radius_graph_pbc
from hydragnn_tpu_torch.data.serialized import SerializedGraphLoader
from hydragnn_tpu_torch.graph import segment
from hydragnn_tpu_torch.ops import autotune
from hydragnn_tpu_torch.utils.config import model_aggregation

from test_real_formats import _GDB9_CSV, _GDB9_SDF

LENGTH_RTOL = 1e-6


def _bcc(n):
    pts = [[x + d, y + d, z + d] for x in range(n) for y in range(n) for z in range(n)
           for d in (0.0, 0.5)]
    return np.asarray(pts, np.float64), float(n) * np.eye(3)


def _fcc_jittered(seed=0):
    rng = np.random.default_rng(seed)
    scaled = chip_smoke.fcc_scaled(2)
    cell = np.eye(3) * chip_smoke.CFG_ALAT * 2
    return (scaled + rng.normal(0, 0.004, scaled.shape)) @ cell, cell


PBC_CASES = {
    "bcc_first_shell": lambda: (*_bcc(2), 0.9, 100, None),
    "bcc_second_shell": lambda: (*_bcc(3), 1.05, 100, None),
    "dimer_in_vacuum": lambda: (np.array([[0.0, 0, 0], [0.74, 0, 0]]), 20.0 * np.eye(3), 1.0,
                                10, None),
    "across_the_boundary": lambda: (np.array([[0.05, 0.5, 0.5], [0.95, 0.5, 0.5]]), np.eye(3),
                                    0.2, 10, None),
    "slab_TTF": lambda: (np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 2.5], [1.5, 0.5, 0.6]]),
                         np.diag([8.0, 8.0, 3.0]), 1.5, 8, np.array([True, True, False])),
    "fcc_capped": lambda: (*_fcc_jittered(), 3.2, 10, None),
    "diagonal_cell_vector": lambda: (_bcc(2)[0], np.array([2.0, 2.0, 2.0]), 0.9, 100, None),
}


@pytest.mark.parametrize("case", sorted(PBC_CASES))
def pytest_radius_graph_pbc_matches_jax_in_order(case):
    pos, cell, radius, cap, pbc = PBC_CASES[case]()
    want_e, want_l = jax_radius_graph_pbc(pos, cell, radius, cap, pbc=pbc)
    got_e, got_l = radius_graph_pbc(pos, cell, radius, cap, pbc=pbc)
    assert got_e.dtype == want_e.dtype and got_l.dtype == want_l.dtype
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_allclose(got_l, want_l, rtol=LENGTH_RTOL)
    if case == "fcc_capped":  # every atom of the jittered FCC cell: 12 neighbours, capped
        assert np.bincount(got_e[1]).tolist() == [10] * pos.shape[0]
    if case == "slab_TTF":  # no edge through the vacuum axis
        assert not np.any(np.isclose(got_l, 1.0))


def pytest_radius_graph_pbc_refuses_duplicate_edges():
    pos, cell = _bcc(1)
    for fn in (jax_radius_graph_pbc, radius_graph_pbc):
        with pytest.raises(ValueError, match="duplicate edges"):
            fn(pos, cell, radius=0.9, max_neighbors=100)


def pytest_element_table_is_the_jax_one():
    assert elements.SYMBOL_TO_Z == jax_elements.SYMBOL_TO_Z
    assert elements.Z_TO_SYMBOL == jax_elements.Z_TO_SYMBOL
    assert elements.atomic_number("fe") == 26 and elements.symbol(41) == "Nb"
    with pytest.raises(KeyError, match="unknown element"):
        elements.atomic_number("Xx")
    assert cfg._SYMBOLS == jax_cfg._SYMBOLS
    assert port_data.SYMBOL_TO_Z is elements.SYMBOL_TO_Z


def _ds_config(path, fmt, node_dim=(1,), node_col=(0,)):
    return {
        "name": "fmt", "format": fmt, "path": {"total": str(path)},
        "node_features": {"name": [f"n{i}" for i in range(len(node_dim))],
                          "dim": list(node_dim), "column_index": list(node_col)},
        "graph_features": {"name": ["energy"], "dim": [1], "column_index": [0]},
    }


def _same_graph_data(a, b, fields=("x", "pos", "y", "supercell_size")):
    for field in fields:
        va, vb = getattr(a, field), getattr(b, field)
        assert (va is None) == (vb is None), field
        if va is not None:
            assert np.asarray(va).dtype == np.asarray(vb).dtype, field
            np.testing.assert_array_equal(va, vb, err_msg=field)


def pytest_cfg_and_xyz_readers_match_jax(tmp_path):
    chip_smoke.write_cfg_data(str(tmp_path / "cfg"), 3, cells=2, seed=4)
    names = sorted(os.listdir(tmp_path / "cfg"))
    assert names == [f"config{i}.{ext}" for i in range(3) for ext in ("bulk", "cfg")]
    ds = _ds_config(tmp_path / "cfg", "CFG", (1, 3), (0, 1))
    for name in names:
        path = str(tmp_path / "cfg" / name)
        got = cfg.CFGDataset(ds).transform_input_to_data_object_base(path)
        want = jax_cfg.CFGDataset(ds).transform_input_to_data_object_base(path)
        assert (got is None) == (want is None) == name.endswith(".bulk")
        if got is not None:
            _same_graph_data(got, want)
            assert got.x.shape == (32, 4) and set(got.x[:, 0]) <= {28.0, 41.0}
    os.makedirs(tmp_path / "xyz")
    rng = np.random.default_rng(3)
    for i in range(2):
        n = 3 + i
        rows = [f"{s} {' '.join(f'{v:.5f}' for v in rng.random(4))}"
                for s in ("Ni", "Nb", "7", "Cu", "Fe")[:n]]
        (tmp_path / "xyz" / f"m{i}.xyz").write_text(f"{n}\n{-1.5 - i} 0.25\n" + "\n".join(rows))
    ds = _ds_config(tmp_path / "xyz", "XYZ", (1, 2), (0, 3))
    for name in sorted(os.listdir(tmp_path / "xyz")):
        path = str(tmp_path / "xyz" / name)
        _same_graph_data(xyz.XYZDataset(ds).transform_input_to_data_object_base(path),
                         jax_xyz.XYZDataset(ds).transform_input_to_data_object_base(path))


def _serialize(tmp_path, monkeypatch, ds, side):
    root = tmp_path / side
    root.mkdir()
    monkeypatch.setenv("SERIALIZED_DATA_PATH", str(root))
    (jax_loaders if side == "jax" else loaders).transform_raw_data_to_serialized(copy.deepcopy(ds))
    return str(root / "serialized_dataset" / "fmt.pkl")


def pytest_serialized_pbc_branch_matches_jax(tmp_path, monkeypatch):
    """The CFG files through both packages' raw loaders and the serialized
    loader's PBC branch: the pickles hold equal samples, and the radius
    graph, ``edge_attr`` (image lengths over the split's longest) and the
    unwrapped ``pos`` are the JAX package's."""
    chip_smoke.write_cfg_data(str(tmp_path / "raw"), 4, cells=2, seed=1)
    ds = _ds_config(tmp_path / "raw", "CFG")
    config = {"Dataset": ds, "NeuralNetwork": {
        "Architecture": {"radius": 3.2, "max_neighbours": 14,
                         "periodic_boundary_conditions": True},
        "Variables_of_interest": {"type": ["graph"], "output_index": [0],
                                  "input_node_features": [0]}}}
    jpath = _serialize(tmp_path, monkeypatch, ds, "jax")
    ppath = _serialize(tmp_path, monkeypatch, ds, "port")
    got = SerializedGraphLoader(config).load_serialized_data(ppath)
    want = JaxSerializedGraphLoader(config).load_serialized_data(jpath)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same_graph_data(a, b, ("x", "pos", "supercell_size"))
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_allclose(a.edge_attr, b.edge_attr, rtol=LENGTH_RTOL)
        np.testing.assert_array_equal(a.targets[0], b.targets[0])
        # FCC at a = 3.52: 12 first neighbours each, across the boundary too
        assert np.bincount(a.edge_index[1]).tolist() == [12] * a.num_nodes
    with pytest.raises(NameError, match="not recognized"):
        loaders.transform_raw_data_to_serialized({**ds, "format": "SDF"})


def _frames():
    rng = np.random.default_rng(7)
    return [
        {"z": np.array([29, 29, 1]), "pos": rng.random((3, 3)) * 3,
         "cell": np.diag([7.2, 7.2, 18.6]), "pbc": np.array([True, True, False]),
         "info": {"energy": -12.5, "note": "two words"},
         "arrays": {"forces": rng.standard_normal((3, 3)), "fixed": np.array([True, False, True]),
                    "tag": np.array(["s", "s", "a"])}},
        {"z": np.array([8, 1]), "pos": rng.random((2, 3)), "info": {"energy": -3.0},
         "arrays": {"forces": np.array([[0.0, 0, 500.0], [0, 0, 0]])}},
        {"z": np.array([26, 26, 26]), "pos": rng.random((3, 3)) * 2, "cell": np.eye(3) * 5.5,
         "info": {"energy": -9.0}, "arrays": {"forces": rng.standard_normal((3, 3))}},
    ]


def _same_frame(a, b):
    assert a.keys() == b.keys()
    assert a["symbols"] == b["symbols"] and a["info"] == b["info"]
    for key in ("z", "pos", "pbc"):
        np.testing.assert_array_equal(a[key], b[key])
    assert (a["cell"] is None) == (b["cell"] is None)
    if a["cell"] is not None:
        np.testing.assert_array_equal(a["cell"], b["cell"])
    assert a["arrays"].keys() == b["arrays"].keys()
    for key in a["arrays"]:
        np.testing.assert_array_equal(a["arrays"][key], b["arrays"][key])


def pytest_extxyz_reader_writer_and_graphs_match_jax(tmp_path):
    jpath, ppath = str(tmp_path / "a" / "f.extxyz"), str(tmp_path / "b" / "f.extxyz")
    os.makedirs(os.path.dirname(jpath))
    os.makedirs(os.path.dirname(ppath))
    jax_extxyz.write_extxyz(jpath, _frames())
    extxyz.write_extxyz(ppath, _frames())
    assert open(jpath).read() == open(ppath).read()  # the writers agree byte for byte
    got, want = extxyz.read_extxyz(jpath), jax_extxyz.read_extxyz(jpath)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_frame(a, b)
        ga = extxyz.frame_to_graph(a, radius=2.5, max_neighbours=6)
        gb = jax_extxyz.frame_to_graph(b, radius=2.5, max_neighbours=6)
        for field in ("x", "pos", "supercell_size", "edge_index", "edge_attr"):
            np.testing.assert_array_equal(getattr(ga, field), getattr(gb, field), err_msg=field)
        assert ga.target_types == gb.target_types
        for ta, tb in zip(ga.targets, gb.targets):
            np.testing.assert_array_equal(ta, tb)
    kw = dict(radius=2.5, max_neighbours=6, num_samples=5)
    got = extxyz.load_extxyz_dir(os.path.dirname(jpath), **kw)
    want = jax_extxyz.load_extxyz_dir(os.path.dirname(jpath), **kw)
    assert len(got) == len(want) == 2  # the 500 eV/A frame dropped
    for ga, gb in zip(got, want):
        np.testing.assert_array_equal(ga.edge_index, gb.edge_index)
    messages = []
    for mod in (jax_extxyz, extxyz):
        with pytest.raises(KeyError, match="refusing to train on silent zero labels") as err:
            mod.frame_to_graph({**mod.read_extxyz(jpath)[0], "info": {}}, radius=2.5)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("body,match", [
    ("3\nProperties=species:S:1:pos:R:3 energy=-1.0\nH 0.0 0.0 0.0\n",
     r"malformed extxyz frame 0: file ends inside atom table \(atom 1 of 3\)"),
    ("1\nProperties=species:S:1:pos:R:3 energy=-1.0\nH 0.0 0.0\n",
     "atom 0: 3 columns, Properties spec needs 4"),
])
def pytest_extxyz_errors_are_the_jax_messages(tmp_path, body, match):
    path = tmp_path / "bad.extxyz"
    path.write_text(body)
    messages = []
    for mod in (jax_extxyz, extxyz):
        with pytest.raises(ValueError, match=match) as err:
            list(mod.iter_extxyz(str(path)))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def _mptrj_records():
    rng = np.random.default_rng(11)
    return [{"mp_id": f"mp-{t // 2}", "frame_id": f"mp-{t // 2}-{t % 2}",
             "z": np.array([26, 8, 8]), "pos": rng.random((3, 3)) * 3,
             "lattice": np.diag([4.0, 4.2, 4.4]), "energy": -6.5 - t,
             "forces": rng.standard_normal((3, 3)), "stress": np.eye(3) * t,
             "magmom": np.array([2.0, 0.1, 0.0])} for t in range(5)]


def pytest_mptrj_streaming_reader_matches_jax(tmp_path):
    path = str(tmp_path / "MPtrj.json")
    jax_mptrj.write_mptrj_json(path, _mptrj_records())
    mine = str(tmp_path / "mine.json")
    mptrj.write_mptrj_json(mine, _mptrj_records())
    assert open(path).read() == open(mine).read()
    for chunk in (64, 1 << 22):  # small chunks: keys and values straddle refills
        assert ([k for k, _ in mptrj.iter_mptrj_entries(path, chunk=chunk)]
                == [k for k, _ in jax_mptrj.iter_mptrj_entries(path, chunk=chunk)]
                == ["mp-0", "mp-1", "mp-2"])
    got, want = mptrj.load_mptrj(path, radius=4.5), jax_mptrj.load_mptrj(path, radius=4.5)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for field in ("x", "pos", "edge_index", "edge_attr"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert a.extras.keys() == b.extras.keys() and a.extras["mp_id"] == b.extras["mp_id"]
        for ta, tb in zip(a.targets, b.targets):
            np.testing.assert_array_equal(ta, tb)
    raw = open(path).read()
    cut = tmp_path / "cut.json"
    cut.write_text(raw.rstrip()[:-1])
    for mod in (jax_mptrj, mptrj):
        with pytest.raises(ValueError, match="truncated MPtrj JSON \\(no closing brace\\)"):
            list(mod.iter_mptrj_entries(str(cut), chunk=64))
    record = json.loads(raw)["mp-0"]["mp-0-0"]
    del record["energy_per_atom"], record["corrected_total_energy"]
    bad = tmp_path / "noenergy.json"
    bad.write_text(json.dumps({"mp-0": {"mp-0-0": record}}))
    for per_atom in (True, False):
        messages = []
        for mod in (jax_mptrj, mptrj):
            with pytest.raises(KeyError, match="record has neither") as err:
                list(mod.iter_mptrj(str(bad), energy_per_atom=per_atom))
            messages.append(str(err.value))
        assert messages[0] == messages[1]


def pytest_qm9_readers_match_jax(tmp_path):
    root = tmp_path / "qm9"
    root.mkdir()
    (root / "gdb9.sdf").write_text(_GDB9_SDF)
    (root / "gdb9.sdf.csv").write_text(_GDB9_CSV)
    (root / "uncharacterized.txt").write_text("\n" * 9 + "  2  gdb_2 fails\n" + "1 compounds\n")
    for kw in ({}, {"edges": "bonds", "per_atom": False, "target_index": 7}):
        got, want = qm9_raw.QM9RawDataset(str(root), **kw), jax_qm9.QM9RawDataset(str(root), **kw)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for field in ("x", "pos", "y", "edge_index"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            np.testing.assert_array_equal(a.targets[0], b.targets[0])
    mols = [(s, p) for s, p, _ in jax_qm9.parse_sdf_v2000(_GDB9_SDF)]
    targets = np.random.default_rng(2).random((3, 19))
    for mod, side in ((jax_qm9, "jw"), (qm9_raw, "pw")):
        mod.write_qm9_sdf(str(tmp_path / side), mols, targets, skips=[1])
    for name in ("gdb9.sdf", "gdb9.sdf.csv", "uncharacterized.txt"):
        assert (tmp_path / "jw" / name).read_text() == (tmp_path / "pw" / name).read_text()
    np.testing.assert_array_equal(qm9_raw.read_gdb9_csv(str(tmp_path / "jw" / "gdb9.sdf.csv")),
                                  jax_qm9.read_gdb9_csv(str(tmp_path / "jw" / "gdb9.sdf.csv")))
    xyzfile = tmp_path / "dsgdb9nsd_000001.xyz"
    xyzfile.write_text("2\ngdb 1 157.7 157.7 157.7 0. 13.21 -0.3877 0.1171 0.5048 35.36 "
                       "0.0447 -40.47 -40.47 -40.47 -40.49 6.469\nC 0.1*^-1 1.0 0.0 0.0\n"
                       "H 0.0 0.0 0.0 0.0\n")
    for a, b in zip(qm9_raw.parse_dsgdb9nsd_xyz(str(xyzfile)),
                    jax_qm9.parse_dsgdb9nsd_xyz(str(xyzfile))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    header = tmp_path / "bad.csv"
    header.write_text("wrong,header,row\n")
    for mod in (jax_qm9, qm9_raw):
        with pytest.raises(ValueError, match=r"unexpected gdb9 csv header \['wrong', 'header'\]"):
            mod.read_gdb9_csv(str(header))


# ---- the knobs --------------------------------------------------------------

@pytest.mark.parametrize("agg,fused_mp,model_type", [
    ("fused", "0", "PNA"), ("fused", "", "PNA"), ("segment", "1", "PNA"), ("", "1", "PNA"),
    ("", "1", "GAT"), ("", "0", "GIN"), ("", "", "SAGE"), ("dense", "1", "PNA"),
])
def pytest_fused_mp_switch_resolves_as_in_jax(monkeypatch, agg, fused_mp, model_type):
    """``HYDRAGNN_FUSED_MP=0`` beats ``HYDRAGNN_AGG=fused``; with
    ``HYDRAGNN_AGG`` unset, ``=1`` picks the fused op where the stack has
    one. The JAX side: its ``use_fused`` decision order without the VMEM
    guard (the port's kernels have none)."""
    monkeypatch.setenv("HYDRAGNN_AGG", agg)
    monkeypatch.setenv("HYDRAGNN_FUSED_MP", fused_mp)
    forced = jax_autotune.env_force()
    if jax_autotune.fused_forbidden():
        jax_fused = False
    elif forced is not None:
        jax_fused = forced == "fused"
    else:
        jax_fused = jax_autotune.fused_forced() and model_type in autotune.FUSED_STACKS
    assert (model_aggregation(model_type) == "fused") == jax_fused
    assert autotune.fused_forbidden() == jax_autotune.fused_forbidden()
    assert autotune.fused_forced() == jax_autotune.fused_forced()


def pytest_obs_port_is_refused(monkeypatch, tmp_path):
    """The knob works since the training telemetry was ported: a run's
    telemetry serves ``/healthz`` on the port ``HYDRAGNN_OBS_PORT`` asks for
    (0: an ephemeral one), as the JAX package's does."""
    import json
    import urllib.request

    from hydragnn_tpu.obs import runtime as jax_runtime
    from hydragnn_tpu_torch.obs import runtime

    monkeypatch.setenv("HYDRAGNN_OBS_PORT", "0")
    for mod, name in ((runtime, "port"), (jax_runtime, "jax")):
        t = mod.init_run_telemetry({}, name, path=str(tmp_path))
        try:
            host, port = t.address
            with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10) as r:
                assert json.loads(r.read())["run"] == name
        finally:
            mod.deactivate()
        assert t.address is None


# ---- the public names ---------------------------------------------------------

@pytest.mark.parametrize("name", ["segment_mean", "segment_max", "segment_min", "segment_std"])
def pytest_segment_reductions_match_jax(name):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((12, 3)).astype(np.float32)
    ids = np.array([0, 0, 2, 2, 2, 3, 3, 5, 1, 1, 7, 0], np.int32)  # segments 4 and 6 empty
    want = np.asarray(getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 8))
    got = getattr(segment, name)(torch.from_numpy(data), torch.from_numpy(ids), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def pytest_plan_from_layout_select_registry_len_and_print_model(capsys):
    from hydragnn_tpu.models.create import print_model as jax_print_model
    from hydragnn_tpu_torch.models import create_model_config, print_model
    from hydragnn_tpu_torch.serve import ModelRegistry, plan_from_layout
    from hydragnn_tpu_torch.serve.buckets import GraphTooLarge

    from hydragnn_tpu.graph import collate_graphs as jax_collate
    from hydragnn_tpu.models import create_model_config as jax_create_model_config
    import jax

    from test_torch_gin_sage import jax_variables
    from test_torch_pna import arch
    from test_torch_serve import PLAN_SIZES, _graphs

    graphs = _graphs(port_data.GraphData, PLAN_SIZES, seed=3)
    layout = loaders.compute_layout([graphs], batch_size=4, num_buckets=2)
    plan = plan_from_layout(layout, graphs[0])
    assert plan.num_buckets == 2
    for g in graphs:
        assert plan.select(g) == plan.admit(g)[0]
        assert g.num_nodes <= plan.capacities[plan.select(g)].max_nodes
    big = copy.copy(graphs[0])
    big.x = np.zeros((10_000, 1), np.float32)
    with pytest.raises(GraphTooLarge):
        plan.select(big)
    assert len(ModelRegistry()) == 0

    cfg = arch()
    model = create_model_config(cfg, device="cpu")
    jmodel = jax_create_model_config(cfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_collate(graphs[:3], 64, 256, 4))
    want = jax_print_model(jmodel, jax_variables(jmodel, jbatch), verbosity=2)
    jax_text = capsys.readouterr().out
    assert print_model(model, verbosity=2) == want
    assert capsys.readouterr().out == jax_text.replace(type(jmodel).__name__,
                                                       type(model).__name__)
