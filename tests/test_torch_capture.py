"""The compiled-program layer of the port against the JAX package's, on the
CPU: there the port's programs run their bodies eagerly, with the same
shape-key cache and counters as on the card (``train/capture.py``).

- ``stack_batches`` equals JAX's array for array and refuses ragged input.
- The bucketed batch plan with ``contiguous_buckets`` and the trainer's
  dispatch plan (``_group_plan``) equal JAX's for the same seed and epoch.
- On PNA (hidden 8, 2 layers, ``segment``: JAX's XLA segment sums, the
  port's plain versions; f32) from the same weights: ``train_multi`` over
  K = 3 stacked batches against JAX ``Trainer._train_multi``; the staged
  epoch with a fixed order against JAX ``_epoch_scan``; ``evaluate_staged``
  and the device-resident ``predict`` against JAX's. Losses and tasks at
  rtol 1e-4 / atol 1e-5; parameters as updates (new minus old) at
  ``test_torch_train.py``'s update tolerances (rtol 1e-4, atol 2e-7) a
  step. The biases BatchNorm cancels (``test_torch_train.py``) are left
  out: their gradients are rounding noise, and Adam makes updates of up to
  ``lr`` of it a step, differently in each package; the BatchNorm running
  means, which average them after the first step, are held at the bound
  that drift gives (2 ``lr`` a step, ``test_torch_run_training.py``).
  Between the comparisons the port takes JAX's state again
  (``load_flax_variables``, ``load_optax_adam_state``, in place).
- ``run_training`` on ``ci.json``'s ``unit_test`` data (40 configurations)
  for 2 epochs from a JAX starting checkpoint, with ``steps_per_dispatch:
  2`` (batch 14: one stacked pair an epoch) and with
  ``device_resident_dataset`` (the staged epochs, evaluations and
  predict), against JAX's ``run_training`` in the same modes: the
  per-epoch losses at rtol 1e-4 / atol 1e-5. The staged training order
  is each package's own draw (the port's from a ``torch.Generator``), so
  the staged run keeps the whole training split in one batch (batch 32),
  where the order is the same. With batch 14 an epoch takes 2 steps, and
  the evaluations after the second epoch (4 steps in) feel the drift of
  the biases BatchNorm cancels through the running means (above): the
  port's own single-step run lies as far from JAX's there (2e-4 to 7e-4
  relative on the validation loss of this data). So that run holds the
  training losses and the first epoch's evaluations to JAX, and its
  second epoch's evaluations and its predictions to the port's
  single-step run, which it must equal: the same bodies on the same
  batches.
- ``InferenceServer`` counts ``compiles_total`` once per (model version,
  bucket), none under traffic, and ``warm_version`` verifies a new version.
"""

import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hydragnn_tpu
from hydragnn_tpu.data import GraphData as JaxGraphData
from hydragnn_tpu.data import loaders as jax_loaders
from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph.batch import stack_batches as jax_stack_batches
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.train import checkpoint as jax_ckpt
from hydragnn_tpu.train import driver as jax_driver
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer
from hydragnn_tpu.utils import config as jax_config

import hydragnn_tpu_torch
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.data import loaders
from hydragnn_tpu_torch.graph import collate_graphs, stack_batches
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.bridge import load_optax_adam_state
from hydragnn_tpu_torch.serve import InferenceServer, ModelRegistry, plan_from_samples
from hydragnn_tpu_torch.train import Trainer, capture_counts

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_pna import arch
from test_torch_run_training import _in_dir, _loaders, _scalars, raw_dirs  # noqa: F401
from test_torch_train import ADAMW, HEADS, PADS, _graphs, _np, _null_space, _port_variables

RTOL, ATOL = 1e-4, 1e-5
UPDATE_RTOL, UPDATE_ATOL = 1e-4, 2e-7  # a step (test_torch_train.py)
LR = ADAMW["Optimizer"]["learning_rate"]
K = 3
FIELDS = ("x", "pos", "senders", "receivers", "edge_attr", "node_graph", "n_node", "n_edge",
          "node_mask", "edge_mask", "graph_mask")


def _hosts(collate, seeds=range(K)):
    return [collate(_graphs(seed=s), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
            for s in seeds]


# ---- stack_batches and the plans -----------------------------------------------

def pytest_stack_batches_matches_jax_and_refuses_ragged():
    got = stack_batches(_hosts(collate_graphs))
    want = jax_stack_batches(_hosts(jax_collate))
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:  # no edge features
            assert g is None, name
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert len(got.targets) == len(want.targets) == 2
    for t, w in zip(got.targets, want.targets):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert got.x.shape[0] == K
    small = (64, 240, 4)  # another graph pad: ragged
    for collate, stack in ((collate_graphs, stack_batches), (jax_collate, jax_stack_batches)):
        ragged = [collate(_graphs()[:3], *small, head_types=HEADS[0], head_dims=HEADS[1]),
                  collate(_graphs()[:3], *PADS, head_types=HEADS[0], head_dims=HEADS[1])]
        with pytest.raises(ValueError):
            stack(ragged)


def _sized_samples(cls, num, seed):
    """``num`` small graphs of 3-14 nodes (three node-count buckets) with
    one graph target."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        n = int(rng.integers(3, 15))
        src = np.arange(n)
        g = cls(x=rng.random((n, 1)).astype(np.float32),
                pos=rng.random((n, 3)).astype(np.float32),
                edge_index=np.stack([src, (src + 1) % n]).astype(np.int64))
        g.edge_attr = rng.random((n, 1)).astype(np.float32)
        g.targets = [np.array([g.x.sum()], np.float32)]
        g.target_types = ["graph"]
        out.append(g)
    return out


@pytest.mark.parametrize("contiguous", [True, False])
def pytest_contiguous_batch_plan_and_group_plan_match_jax(contiguous):
    sets = [(_sized_samples(GraphData, n, s), _sized_samples(JaxGraphData, n, s))
            for n, s in ((60, 0), (12, 1), (12, 2))]
    ploaders = loaders.create_dataloaders(*(p for p, _ in sets), batch_size=4, num_buckets=3,
                                          contiguous_buckets=contiguous)
    jloaders = jax_loaders.create_dataloaders(*(j for _, j in sets), batch_size=4, num_buckets=3,
                                              contiguous_buckets=contiguous)
    ploader, jloader = ploaders[0], jloaders[0]
    for epoch in range(2):
        ploader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        plan = [(b, c.tolist()) for b, c in ploader._batch_plan()]
        assert plan == [(b, c.tolist()) for b, c in jloader._batch_plan()]
        if contiguous:  # each bucket's batches form one run
            runs = [b for i, (b, _) in enumerate(plan) if i == 0 or plan[i - 1][0] != b]
            assert len(runs) == len(set(runs)) == 3
        pgroups = list(Trainer._group_plan(iter(ploader), 2))
        jgroups = list(JaxTrainer._group_plan(jloader, len(jloader), 2))
        assert [[b.num_nodes for b in g] for g in pgroups] == \
            [[np.asarray(b.x).shape[0] for b in g] for g in jgroups]
        assert any(len(g) == 2 for g in pgroups)


# ---- the programs against JAX's ------------------------------------------------

def _sync(model, optimizer, jstate):
    """The port takes JAX's state, in place."""
    load_flax_variables(model, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    load_optax_adam_state(optimizer, _np(jstate.opt_state))


def _updates(model, cfg, jstate, old):
    """``(port update, JAX update)`` per tensor name from ``old``."""
    ref = create_model_config(cfg, device="cpu", aggregation="segment")
    load_flax_variables(ref, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    new, want = _port_variables(model), _port_variables(ref)
    return {name: (new[name] - old[name], want[name] - old[name]) for name in old}


def _hold_updates(updates, steps):
    compared = 0
    for name, (got, want) in updates.items():
        if _null_space(name):
            continue
        if name.endswith("running_mean") and steps > 1:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=2.0 * LR * steps, err_msg=name)
            continue
        np.testing.assert_allclose(got, want, rtol=UPDATE_RTOL, atol=UPDATE_ATOL * steps,
                                   err_msg=name)
        compared += 1
    assert compared > 20


@pytest.fixture(scope="module")
def program_runs():
    """JAX's and the port's trainer from the same weights, through
    train_multi, the staged epoch, evaluate_staged and the device-resident
    predict; the port takes JAX's state again before each."""
    cfg = arch(hidden=8, layers=2)
    training = dict(ADAMW, device_resident_dataset=True)
    jhosts, hosts = _hosts(jax_collate), _hosts(collate_graphs)
    jtrainer = JaxTrainer(jax_create_model_config(cfg), training)
    jstate = jtrainer.init_state(jhosts[0])
    model = create_model_config(cfg, device="cpu", aggregation="segment")
    trainer = Trainer(model, training)
    state = trainer.init_state(hosts[0])
    _sync(model, state.optimizer, jstate)
    out = {"cfg": cfg}
    rngs = jax.random.split(jax.random.PRNGKey(0), K)

    old = _port_variables(model)
    jstate, jmet = jtrainer._train_multi(jstate, jtrainer.put_batch_stacked(
        jax_stack_batches(jhosts)), rngs)
    state, met = trainer.train_multi(state, stack_batches(hosts))
    out["multi"] = (met, _np(jmet), _updates(model, cfg, jstate, old), state.step)

    _sync(model, state.optimizer, jstate)
    perm = [2, 0, 1]
    old = _port_variables(model)
    jstate, jmet = jtrainer._epoch_scan(jstate, jtrainer.stage_batches(jhosts),
                                        jnp.asarray(perm), rngs)
    staged = trainer.stage_batches(hosts)
    state, loss, tasks = trainer.train_epoch_staged(state, staged, perm=perm)
    out["epoch"] = (staged.rows.numpy().copy(), loss, tasks, _np(jmet),
                    _updates(model, cfg, jstate, old))

    _sync(model, state.optimizer, jstate)
    out["eval"] = (trainer.evaluate_staged(state, staged),
                   jtrainer.evaluate_staged(jstate, jtrainer.stage_batches(jhosts)))
    out["predict"] = (trainer.predict(state, hosts), jtrainer.predict(jstate, jhosts))
    out["programs"] = trainer.programs(state).counts()
    return out


def pytest_train_multi_matches_jax(program_runs):
    met, jmet, updates, step = program_runs["multi"]
    np.testing.assert_allclose(met["loss"].numpy(), jmet["loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(met["tasks"].numpy(), jmet["tasks"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(met["num_graphs"].numpy(), jmet["num_graphs"])
    assert met["loss"].shape == (K,) and step == K
    _hold_updates(updates, K)


def pytest_staged_epoch_matches_jax_epoch_scan(program_runs):
    rows, loss, tasks, jmet, updates = program_runs["epoch"]
    np.testing.assert_allclose(rows[:, 0], jmet["loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(rows[:, 1], jmet["num_graphs"])
    np.testing.assert_allclose(rows[:, 2:], jmet["tasks"], rtol=RTOL, atol=ATOL)
    g = np.asarray(jmet["num_graphs"], np.float64)
    np.testing.assert_allclose(loss, np.asarray(jmet["loss"], np.float64) @ g / g.sum(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tasks, (np.asarray(jmet["tasks"]) * g[:, None]).sum(0) / g.sum(),
                               rtol=RTOL, atol=ATOL)
    _hold_updates(updates, K)


def pytest_evaluate_staged_and_device_resident_predict_match_jax(program_runs):
    (loss, tasks), (jloss, jtasks) = program_runs["eval"]
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tasks, jtasks, rtol=RTOL, atol=ATOL)
    got, want = program_runs["predict"]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[3], want[3]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # one program per key: each ran one shape
    assert {k: v["captures"] for k, v in program_runs["programs"].items()} == {
        "train_multi": 1, "epoch_scan": 1, "eval_epoch": 1, "predict_scan": 1}


def pytest_predict_falls_back_as_jax_does(monkeypatch):
    """A ragged test set and a stage over its budget stream, with the
    device-resident pass's answers; a malformed budget raises."""
    cfg = arch(hidden=8, layers=2)
    model = create_model_config(cfg, device="cpu", aggregation="segment")
    trainer = Trainer(model, dict(ADAMW, predict_device_resident=True))
    hosts = _hosts(collate_graphs)
    state = trainer.init_state(hosts[0])
    staged = trainer.predict(state, hosts)
    ragged = hosts + [collate_graphs(_graphs()[:3], 64, 240, 4, head_types=HEADS[0],
                                     head_dims=HEADS[1])]
    streamed = trainer.predict(state, ragged)
    assert streamed[2][0].shape[0] == staged[2][0].shape[0] + 3
    monkeypatch.setenv("HYDRAGNN_PREDICT_STAGE_BUDGET", "1e3")
    over = trainer.predict(state, hosts)
    for a, b in zip(over[3], staged[3]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert trainer.programs(state).counts()["predict_scan"]["captures"] == 1
    monkeypatch.setenv("HYDRAGNN_PREDICT_STAGE_BUDGET", "lots")
    with pytest.raises(ValueError, match="byte count"):
        trainer.predict(state, hosts)


# ---- run_training in the new modes -------------------------------------------------

MODES = {
    "steps_per_dispatch": {"steps_per_dispatch": 2, "batch_size": 14},
    "device_resident": {"device_resident_dataset": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def pytest_run_training_in_the_new_modes_matches_jax(raw_dirs, tmp_path, monkeypatch, mode):  # noqa: F811
    config = copy.deepcopy(raw_dirs)
    config["NeuralNetwork"]["Training"].update(num_epoch=2, **MODES[mode])
    start = tmp_path / "start"
    _in_dir(monkeypatch, start)
    jcfg, jl = _loaders(config, True)
    jcfg = jax_config.update_config(jcfg, *jl)
    _, _, jstate = jax_driver._build_model_and_trainer(jcfg, jl[0], 0)
    jax_ckpt.save_model(jstate, "start", path=str(start / "logs"))
    config["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": "start"})
    for side in ("jax", "port"):
        _in_dir(monkeypatch, tmp_path / side)
        shutil.copytree(start / "logs", tmp_path / side / "logs")
        if side == "jax":
            hydragnn_tpu.run_training(copy.deepcopy(config))
            jpred = hydragnn_tpu.run_prediction(copy.deepcopy(config))
        else:
            before = capture_counts()["captures"]
            state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
            pred = hydragnn_tpu_torch.run_prediction(copy.deepcopy(config), device="cpu")
            captures = capture_counts()["captures"] - before
    name = state.info["log_name"]
    scalars = _scalars(tmp_path / "jax" / "logs" / name / "scalars.jsonl")
    history = state.info["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    # steps_per_dispatch: 4 steps before the last evaluation (the drift above)
    drift = mode == "steps_per_dispatch"
    for key, tag in (("train_loss", "train error"), ("val_loss", "validate error"),
                     ("test_loss", "test error")):
        n = 1 if drift and key != "train_loss" else 2
        np.testing.assert_allclose([h[key] for h in history][:n], scalars[tag][:n], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    if drift:  # the rest against the port's single steps, which it must equal
        single = copy.deepcopy(config)
        single["NeuralNetwork"]["Training"]["steps_per_dispatch"] = 1
        _in_dir(monkeypatch, tmp_path / "single")
        shutil.copytree(start / "logs", tmp_path / "single" / "logs")
        one = hydragnn_tpu_torch.run_training(copy.deepcopy(single), device="cpu").info["history"]
        for key in ("train_loss", "val_loss", "test_loss"):
            np.testing.assert_allclose([h[key] for h in history], [h[key] for h in one],
                                       rtol=1e-6, atol=0, err_msg=key)
        jpred = hydragnn_tpu_torch.run_prediction(copy.deepcopy(single), device="cpu")
    np.testing.assert_allclose(pred[0], jpred[0], rtol=RTOL, atol=ATOL)
    for a, b in zip(pred[3], jpred[3]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if mode == "device_resident":  # the train, val and test stacks and the test predict
        assert captures == 4
    else:  # train: the stacked pair, the single; eval: its one pad, the predict pass's
        assert captures >= 2


# ---- the server's compile counter ----------------------------------------------------

def pytest_server_counts_compiles_per_version_and_bucket_and_warm_version_verifies():
    cfg = arch(hidden=8, layers=2)
    graphs = [GraphData(x=g.x, pos=g.pos, edge_index=g.edge_index)
              for g in _graphs() + _graphs(seed=1)]
    plan = plan_from_samples(graphs, max_batch_graphs=4, num_buckets=2)
    registry = ModelRegistry()
    registry.register("pna", create_model_config(cfg, device="cpu", aggregation="segment"))
    server = InferenceServer(registry, plan, device="cpu")
    with server:
        assert server.metrics.snapshot()["compiles_total"] == plan.num_buckets
        answers = [f.result(30) for f in [server.submit(g) for g in graphs]]
        assert len(answers) == len(graphs)
        assert server.metrics.snapshot()["compiles_total"] == plan.num_buckets
        registry.register("pna", create_model_config(cfg, device="cpu", aggregation="segment",
                                                     seed=1))
        warm = server.warm_version("pna")
        assert warm == {"buckets": plan.num_buckets, "first_pass_compiles": plan.num_buckets,
                        "later_pass_compiles": 0, "verified": True}
        server.submit(graphs[0]).result(30)
        assert server.metrics.snapshot()["compiles_total"] == 2 * plan.num_buckets
    assert server._programs is None  # stop freed them


def _chained(*messages):
    """An error raised while handling the one before it, for each message."""
    error = None
    for m in messages:
        try:
            try:
                if error is not None:
                    raise error
            finally:
                raise RuntimeError(m)
        except RuntimeError as e:
            error = e
    return error


@pytest.mark.parametrize("messages, again", [
    # broken from outside: seen at the capture's end, or first at a launch
    (["CUDA error: operation failed due to a previous error during capture"], True),
    (["CUDA error: operation failed due to a previous error during capture\n"
      "Search for `cudaErrorStreamCaptureInvalidated'"] * 2, True),
    # the body's own illegal operation, then the capture's end: never again
    (["CUDA error: operation not permitted when stream is capturing",
      "CUDA error: operation failed due to a previous error during capture"], False),
    (["shapes do not match", "CUDA error: operation failed due to a previous error during capture"],
     False),
    (["CUDA error: an illegal memory access was encountered"], False),
])
def pytest_only_a_capture_broken_from_outside_is_recorded_again(messages, again):
    from hydragnn_tpu_torch.train.capture import _invalidated

    assert _invalidated(_chained(*messages)) is again
