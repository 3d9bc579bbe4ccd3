"""``run_training`` and ``run_prediction`` of the port against the JAX
package's, through the entry points, on the ``unit_test`` data of
``ci.json`` (``tests/synthetic.py``, 40 configurations: 28 train, 6
validate, 6 test).

- The data path: the LSMS parse, the min-max normalisation, the radius
  graph and the targets equal the JAX package's arrays on the same files,
  and the port reads the JAX package's pickles; the numpy stratified split
  gives scikit-learn's indices; ``update_config`` derives the JAX
  package's Architecture; ``GraphLoader`` batches hold the JAX package's
  samples in its order for two epochs.
- Trajectory parity: the JAX package writes a starting checkpoint
  (``init_state`` + ``save_model``); JAX's and the port's
  ``run_training`` each continue from it (``startfrom``, a warm start) for
  2 epochs. The per-epoch losses agree at rtol 1e-4 / atol 1e-5, the
  final weights and statistics at rtol 1e-3 / atol 1e-5
  (``test_torch_train.py``'s tolerances). The biases of each encoder
  conv's last two layers are left out of the weights: a BatchNorm in
  training mode cancels them, their gradients are rounding noise, and Adam
  turns that noise into updates that differ between the packages
  (``test_torch_train.py`` shows it); they and the BatchNorm running
  means, which average them, are held at the bound that drift gives
  (:func:`_null_space_bound`). The evaluation losses (2 steps in, the
  drift is ~4e-3) hold at the loss tolerance. Each package's
  ``run_prediction`` on the other's checkpoint gives the other's errors and
  predictions (rtol 1e-4 / atol 1e-5: the same weights).
- Every stack (all nine) trains one epoch through the port's
  ``run_training`` on the CPU with finite losses, and its checkpoint is
  served by ``ModelRegistry.load_checkpoint`` through ``InferenceServer``
  as ``run_prediction`` predicts it.
"""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest

import hydragnn_tpu
from hydragnn_tpu.data import loaders as jax_loaders
from hydragnn_tpu.data.serialized import SerializedGraphLoader as JaxSerializedGraphLoader
from hydragnn_tpu.train import checkpoint as jax_ckpt
from hydragnn_tpu.train import driver as jax_driver
from hydragnn_tpu.utils import config as jax_config

import hydragnn_tpu_torch
from hydragnn_tpu_torch.data import loaders
from hydragnn_tpu_torch.data.serialized import SerializedGraphLoader, read_serialized
from hydragnn_tpu_torch.data.split import split_dataset, stratified_shuffle_split
from hydragnn_tpu_torch.serve import InferenceServer, ModelRegistry, plan_from_samples
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.utils import config as port_config

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from synthetic import deterministic_graph_data  # noqa: E402

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
NUM_CONFIGS = 40
CI_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inputs", "ci.json")
NULL_SPACE = ("post_nn", "lin")
STACKS = ["PNA", "GIN", "SAGE", "SchNet", "EGNN", "GAT", "MFC", "CGCNN", "DimeNet"]


@pytest.fixture(scope="module")
def raw_dirs(tmp_path_factory):
    """The ci.json splits as raw unit_test files."""
    root = tmp_path_factory.mktemp("ci_raw")
    with open(CI_JSON) as f:
        config = json.load(f)
    perc = config["NeuralNetwork"]["Training"]["perc_train"]
    for name, rel in config["Dataset"]["path"].items():
        num = int(NUM_CONFIGS * perc) if name == "train" else int(NUM_CONFIGS * (1 - perc) * 0.5)
        path = str(root / f"{os.path.basename(rel)}_{num}")
        deterministic_graph_data(path, number_configurations=num)
        config["Dataset"]["path"][name] = path
    return config


def _in_dir(monkeypatch, path):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)
    monkeypatch.setenv("SERIALIZED_DATA_PATH", str(path))


def _loaders(config, jax_side):
    mod = jax_loaders if jax_side else loaders
    cfg = copy.deepcopy(config)
    return cfg, mod.dataset_loading_and_splitting(cfg)


# ---- the data path -------------------------------------------------------------

def pytest_lsms_parse_normalisation_and_radius_graph_match_jax(raw_dirs, tmp_path, monkeypatch):
    _in_dir(monkeypatch, tmp_path / "jax")
    jax_loaders.transform_raw_data_to_serialized(copy.deepcopy(raw_dirs["Dataset"]))
    _in_dir(monkeypatch, tmp_path / "port")
    loaders.transform_raw_data_to_serialized(copy.deepcopy(raw_dirs["Dataset"]))
    for split in ("train", "validate", "test"):
        name = f"unit_test_singlehead_{split}.pkl"
        jpath = str(tmp_path / "jax" / "serialized_dataset" / name)
        ppath = str(tmp_path / "port" / "serialized_dataset" / name)
        jnode, jgraph, jdata = read_serialized(jpath)  # the JAX pickle, read by the port
        pnode, pgraph, pdata = read_serialized(ppath)
        np.testing.assert_array_equal(pnode, jnode)
        np.testing.assert_array_equal(pgraph, jgraph)
        assert len(pdata) == len(jdata) > 0
        for a, b in zip(pdata, jdata):
            assert type(a) is type(b) is hydragnn_tpu_torch.GraphData
            for field in ("x", "pos", "y"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        jsamples = JaxSerializedGraphLoader(raw_dirs).load_serialized_data(jpath)
        psamples = SerializedGraphLoader(raw_dirs).load_serialized_data(ppath)
        for a, b in zip(psamples, jsamples):
            np.testing.assert_array_equal(a.edge_index, b.edge_index)
            np.testing.assert_array_equal(a.edge_attr, b.edge_attr)
            np.testing.assert_array_equal(a.x, b.x)
            assert a.target_types == b.target_types
            for ta, tb in zip(a.targets, b.targets):
                np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("seed", range(4))
def pytest_stratified_split_matches_sklearn(seed):
    from sklearn.model_selection import StratifiedShuffleSplit

    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 400))
    y = rng.integers(0, int(rng.integers(2, 9)), n) * 1000 + rng.integers(0, 2, n)
    _, counts = np.unique(y, return_counts=True)
    for value in np.unique(y)[counts < 2]:
        y = np.concatenate([y, [value]])
    for train_size in (0.7, 0.5):
        want = next(StratifiedShuffleSplit(n_splits=1, train_size=train_size,
                                           random_state=0).split(y, y))
        got = stratified_shuffle_split(y, train_size, random_state=0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def pytest_total_path_split_matches_jax(tmp_path, monkeypatch):
    """``ci_multihead.json``'s ``total`` path: serialized, split
    compositionally (duplicating singletons) and written back as three
    pickles, by each package, from 300 configurations."""
    with open(CI_JSON.replace("ci.json", "ci_multihead.json")) as f:
        config = json.load(f)
    raw = str(tmp_path / "raw")
    deterministic_graph_data(raw, number_configurations=300)
    config["Dataset"]["path"] = {"total": raw}
    splits = {}
    for side, mod in (("jax", jax_loaders), ("port", loaders)):
        _in_dir(monkeypatch, tmp_path / side)
        cfg = copy.deepcopy(config)
        mod.transform_raw_data_to_serialized(cfg["Dataset"])
        mod.total_to_train_val_test_pkls(cfg)
        assert sorted(cfg["Dataset"]["path"]) == ["test", "train", "validate"]
        splits[side] = {k: read_serialized(p)[2] for k, p in cfg["Dataset"]["path"].items()}
    for name, want in splits["jax"].items():
        got = splits["port"][name]
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.pos, b.pos)
            np.testing.assert_array_equal(a.y, b.y)
    # the split itself, on the same samples, in both packages
    from hydragnn_tpu.data.split import split_dataset as jax_split_dataset

    total = splits["port"]["train"]
    for g, w in zip(split_dataset(total, 0.7, True), jax_split_dataset(total, 0.7, True)):
        assert [id(d) for d in g if d in total] == [id(d) for d in w if d in total]


@pytest.mark.parametrize("buckets", [1, 2])
def pytest_update_config_and_loader_batches_match_jax(raw_dirs, tmp_path, monkeypatch, buckets):
    """One layout, or two node-count buckets packed under their budgets
    (``HYDRAGNN_BATCH_BUCKETS``, read by both packages)."""
    _in_dir(monkeypatch, tmp_path)
    monkeypatch.setenv("HYDRAGNN_BATCH_BUCKETS", str(buckets))
    jcfg, jl = _loaders(raw_dirs, True)
    pcfg, pl = _loaders(raw_dirs, False)
    jcfg = jax_config.update_config(jcfg, *jl)
    pcfg = port_config.update_config(pcfg, *pl)
    assert pcfg["NeuralNetwork"] == jcfg["NeuralNetwork"]
    assert port_config.get_log_name_config(pcfg) == jax_config.get_log_name_config(jcfg)
    assert pcfg["NeuralNetwork"]["Architecture"]["dense_aggregation"] is False
    for jloader, ploader in zip(jl, pl):
        assert isinstance(ploader.layout, loaders.BucketedLayout) == (buckets > 1)
        for epoch in range(2):
            jloader.set_epoch(epoch)
            ploader.set_epoch(epoch)
            if buckets == 1:
                np.testing.assert_array_equal(ploader._indices(), jloader._indices())
            else:
                assert [(b, c.tolist()) for b, c in ploader._batch_plan()] == \
                    [(b, c.tolist()) for b, c in jloader._batch_plan()]
            jbatches, pbatches = list(jloader), list(ploader)
            assert len(pbatches) == len(jbatches) == len(ploader)
            for p, j in zip(pbatches, jbatches):
                nm, jnm = p.node_mask.numpy(), np.asarray(j.node_mask)
                gm, jgm = p.graph_mask.numpy(), np.asarray(j.graph_mask)
                em, jem = p.edge_mask.numpy(), np.asarray(j.edge_mask)
                np.testing.assert_array_equal(p.x.numpy()[nm], np.asarray(j.x)[jnm])
                np.testing.assert_array_equal(p.pos.numpy()[nm], np.asarray(j.pos)[jnm])
                np.testing.assert_array_equal(p.senders.numpy()[em], np.asarray(j.senders)[jem])
                np.testing.assert_array_equal(p.receivers.numpy()[em],
                                              np.asarray(j.receivers)[jem])
                np.testing.assert_array_equal(p.edge_attr.numpy()[em],
                                              np.asarray(j.edge_attr)[jem])
                np.testing.assert_array_equal(p.n_node.numpy()[gm], np.asarray(j.n_node)[jgm])
                for t, jt, kind in zip(p.targets, j.targets, ("graph",)):
                    mask, jmask = (gm, jgm) if kind == "graph" else (nm, jnm)
                    np.testing.assert_array_equal(t.numpy()[mask], np.asarray(jt)[jmask])


# ---- trajectory and prediction parity through the entry points -------------------

def _scalars(path):
    """``{tag: [value per epoch]}`` of the JAX run's scalars.jsonl."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[int(rec["step"])] = float(rec["value"])
    return {tag: [v[k] for k in sorted(v)] for tag, v in out.items()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _null_space(path):
    parts = path.split("/")
    return (parts[0].startswith("encoder_conv_") and len(parts) == 3
            and parts[1] in NULL_SPACE and parts[2] == "bias")


def _null_space_bound(lr, steps):
    """How far the null-space biases can drift apart: Adam moves a
    parameter by at most ``lr`` (times ~1 for a gradient far above eps) a
    step, in either direction in each package."""
    return 2.0 * lr * steps


@pytest.fixture(scope="module")
def parity_runs(raw_dirs, tmp_path_factory):
    """One JAX starting checkpoint, then JAX's and the port's run_training
    from it (2 epochs) in directories of their own."""
    root = tmp_path_factory.mktemp("parity")
    mp = pytest.MonkeyPatch()
    try:
        config = copy.deepcopy(raw_dirs)
        config["NeuralNetwork"]["Training"]["num_epoch"] = 2
        start = root / "start"
        _in_dir(mp, start)
        jcfg, jl = _loaders(config, True)
        jcfg = jax_config.update_config(jcfg, *jl)
        _, jtrainer, jstate = jax_driver._build_model_and_trainer(jcfg, jl[0], 0)
        jax_ckpt.save_model(jstate, "start", path=str(start / "logs"))
        config["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": "start"})
        runs = {}
        for side in ("jax", "port"):
            where = root / side
            _in_dir(mp, where)
            shutil.copytree(start / "logs", where / "logs")
            if side == "jax":
                hydragnn_tpu.run_training(copy.deepcopy(config))
            else:
                state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
                runs["history"] = state.info["history"]
                runs["log_name"] = state.info["log_name"]
            runs[side] = where
        runs["config"] = config
        runs["lr"] = float(config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"])
        yield runs
    finally:
        mp.undo()


def pytest_run_training_continues_a_jax_checkpoint_as_jax_does(parity_runs):
    name = parity_runs["log_name"]
    jax_scalars = _scalars(parity_runs["jax"] / "logs" / name / "scalars.jsonl")
    history = parity_runs["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    steps = len(history)  # 28 training graphs, batch 32: one step an epoch
    # training losses (BatchNorm on the batch: the null space cancels)
    np.testing.assert_allclose([h["train_loss"] for h in history], jax_scalars["train error"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for key, tag in (("val_loss", "validate error"), ("test_loss", "test error")):
        np.testing.assert_allclose([h[key] for h in history], jax_scalars[tag],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
    bound = _null_space_bound(parity_runs["lr"], steps)
    jfinal = ckpt.load_state_dict(name, path=str(parity_runs["jax"] / "logs"), fallback=False)
    pfinal = ckpt.load_state_dict(name, path=str(parity_runs["port"] / "logs"), fallback=False)
    jmeta, pmeta = ckpt.pop_train_meta(jfinal), ckpt.pop_train_meta(pfinal)
    assert int(jmeta["epoch"]) == int(pmeta["epoch"]) == 1
    np.testing.assert_allclose(float(pmeta["plateau"]["lr"]), float(jmeta["plateau"]["lr"]),
                               rtol=1e-7)
    assert int(np.asarray(pfinal["step"])) == int(np.asarray(jfinal["step"])) == steps
    want = dict(_flat(jfinal["params"]))
    got = dict(_flat(pfinal["params"]))
    assert got.keys() == want.keys()
    compared = 0
    for path in want:
        if _null_space(path):
            np.testing.assert_allclose(got[path], want[path], atol=bound, err_msg=path)
            continue
        np.testing.assert_allclose(got[path], want[path], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=path)
        compared += 1
    assert compared > 20
    for path, w in _flat(jfinal["batch_stats"]):
        g = dict(_flat(pfinal["batch_stats"]))[path]
        # a running mean averages the batch means of the null space's output
        atol = bound if path.endswith("mean") else PARAM_ATOL
        np.testing.assert_allclose(g, w, rtol=PARAM_RTOL, atol=atol, err_msg=path)


def _hold_predictions(got, want):
    err, tasks, tv, pv = got
    werr, wtasks, wtv, wpv = want
    np.testing.assert_allclose(err, werr, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(tasks, wtasks, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for a, b in zip(tv, wtv):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pv, wpv):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("owner", ["port", "jax"])
def pytest_each_run_prediction_reads_the_others_checkpoint(parity_runs, owner, monkeypatch):
    _in_dir(monkeypatch, parity_runs[owner])
    config = parity_runs["config"]
    got = hydragnn_tpu_torch.run_prediction(copy.deepcopy(config), device="cpu")
    want = hydragnn_tpu.run_prediction(copy.deepcopy(config))
    assert len(got[2]) == 1 and got[2][0].shape == (6, 1)
    _hold_predictions(got, want)


def pytest_run_training_resumes_its_own_run(raw_dirs, tmp_path, monkeypatch):
    """``Training.continue`` on the run's own name resumes after the epoch
    its ``train_meta`` records, with the saved plateau and early-stopping
    state and the saved key: a checkpoint rewritten as if the run had been
    preempted after epoch 0 trains epoch 1 only."""
    _in_dir(monkeypatch, tmp_path)
    config = copy.deepcopy(raw_dirs)
    config["NeuralNetwork"]["Training"]["num_epoch"] = 2
    name = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu").info["log_name"]
    restored = ckpt.load_state_dict(name)
    meta = ckpt.pop_train_meta(restored)
    assert int(meta["epoch"]) == 1 and np.asarray(meta["rng"]).tolist() == [0, 1337]
    meta = dict(meta, epoch=0, rng=np.asarray([7, 9], np.uint32),
                plateau=dict(meta["plateau"], lr=0.005, num_bad_epochs=2))
    ckpt.save_model(dict(restored), name, train_meta=meta)
    config["NeuralNetwork"]["Training"]["continue"] = 1
    state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
    assert [h["epoch"] for h in state.info["history"]] == [1]
    assert state.info["history"][0]["lr"] == pytest.approx(0.005)
    final = ckpt.pop_train_meta(ckpt.load_state_dict(name))
    assert int(final["epoch"]) == 1 and np.asarray(final["rng"]).tolist() == [7, 9]
    assert int(final["plateau"]["num_bad_epochs"]) in (0, 3)


# ---- every stack through the port's entry points ---------------------------------

@pytest.mark.parametrize("model_type", STACKS)
def pytest_every_stack_trains_saves_and_serves(raw_dirs, model_type, tmp_path, monkeypatch):
    _in_dir(monkeypatch, tmp_path)
    config = copy.deepcopy(raw_dirs)
    config["NeuralNetwork"]["Architecture"]["model_type"] = model_type
    config["NeuralNetwork"]["Training"]["num_epoch"] = 1
    state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
    (epoch,) = state.info["history"]
    assert all(np.isfinite([epoch["train_loss"], epoch["val_loss"], epoch["test_loss"]]))
    name = state.info["log_name"]
    assert ckpt.checkpoint_exists(name) and state.info["last_save"]["bytes"] > 0
    _, _, true_values, predicted = hydragnn_tpu_torch.run_prediction(copy.deepcopy(config),
                                                                      device="cpu")
    registry = ModelRegistry()
    entry = registry.load_checkpoint(name, device="cpu")
    cfg, (_, _, test_loader) = _loaders(config, False)
    samples = [test_loader.dataset[i] for _, chunk in test_loader.batch_tasks() for i in chunk]
    plan = plan_from_samples(samples, max_batch_graphs=4,
                             need_triplets=model_type == "DimeNet")
    with InferenceServer(registry, plan, device="cpu") as server:
        served = [server.predict(g, model=entry.name, timeout=60) for g in samples]
    rows = np.concatenate([np.asarray(s[0]).reshape(-1, 1) for s in served])
    assert rows.shape == predicted[0].shape
    np.testing.assert_allclose(rows, predicted[0], rtol=1e-3, atol=1e-4)
