"""Whole-run training of the port (``Trainer.fit_staged`` and the chunked
epoch driver) against the JAX package's, on the CPU, where the port's
programs run their bodies eagerly (the same code the card captures).

- ``fit_staged`` against JAX ``Trainer.fit_staged`` from the same weights
  (``load_flax_variables``, ``load_optax_adam_state``), both with
  ``shuffle=False`` (each package draws its own order otherwise), on PNA
  (hidden 8, 2 layers, ``segment``: JAX's XLA segment sums, the port's
  plain versions; 3 staged batches, a staged validation set), in four
  cases after ``tests/test_multistep.py:229-348``: two chunks carrying
  ``sched`` and ``best_state`` against one, an inert ``pad_to`` tail, a
  plateau that halves the rate, and an early stop in the middle of a
  chunk (the epochs after it NaN rows, the state unchanged through them).
  The series' losses at rtol 1e-4 / atol 1e-5 (``test_torch_capture.py``'s);
  its learning rate and stop flags, and ``SchedState``'s counts, exactly;
  the final and the best states as updates from the start at the update
  tolerances (rtol 1e-4, atol 2e-7 a step), the biases BatchNorm cancels
  left out and the running means held at 2 ``lr`` a step
  (``test_torch_capture.py`` documents both).
- ``fit_staged`` (shuffled) against the port's own per-epoch staged loop
  (``train_epoch_staged`` + ``evaluate_staged``) drawing the same orders:
  the same state bit for bit; the series' losses (float32 sums on the
  device against the loop's float64 on the host) at rtol 1e-6.
- ``run_training`` with ``fit_chunk_epochs`` 2 over 4 epochs (two
  chunks; and with ``restage_per_chunk``) against JAX's on ``ci.json``'s
  ``unit_test`` data (40 configurations, batch 32: one training batch, so
  that each package's order is the same) from one JAX starting
  checkpoint: the training losses at the loss tolerance, the final
  checkpoints' ``train_meta`` ``fit_sched`` counts exactly, and their
  weights as ``test_torch_run_training.py`` holds them (rtol 1e-3 / atol
  1e-5; the biases BatchNorm cancels, and the running means, within 2
  ``lr`` a step). ``ci.json``'s
  rate (0.02) makes the biases BatchNorm cancels drift apart through the
  running means, which the evaluations after the first epoch feel (2e-4
  to 7e-4 relative, ``test_torch_capture.py``): as there, the first
  epoch's evaluations are held to JAX and the later ones, with
  ``fit_sched``'s losses, to the port's own per-epoch staged run, which
  the chunks must equal (float32 sums on the device against float64 on
  the host: rtol 1e-6; with ``restage_per_chunk`` the second chunk's
  batch holds its samples in the next epoch's order, so only the first
  chunk is the per-epoch run's). Each package resumes the other's checkpoint of
  the first chunk, and its last two epochs' training losses equal the
  other's own continuation at the loss tolerance.
- A guarded streaming ``run_training`` (``divergence_guard``, batch 14:
  two steps an epoch, step 1 poisoned by ``HYDRAGNN_FAULT_NAN_AT_STEP``)
  against JAX's: the training losses, ``train_meta``'s ``guard`` section
  (1 skipped, 0 restores) and the final weights, held as above.
"""

import copy
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hydragnn_tpu
from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.train import checkpoint as jax_ckpt
from hydragnn_tpu.train import driver as jax_driver
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer
from hydragnn_tpu.utils import config as jax_config

import hydragnn_tpu_torch
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.train import Trainer
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.train.capture import state_tensors
from hydragnn_tpu_torch.train.common import FIT_SCHED_FIELDS

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_capture import _hold_updates, _hosts, _sync, _updates
from test_torch_pna import arch
from test_torch_run_training import (  # noqa: F401
    PARAM_ATOL,
    PARAM_RTOL,
    _flat,
    _in_dir,
    _loaders,
    _null_space,
    _null_space_bound,
    _scalars,
    raw_dirs,
)
from test_torch_train import ADAMW, HEADS, PADS, _graphs, _port_variables

RTOL, ATOL = 1e-4, 1e-5
COUNTS = ("plateau_bad", "early_count", "stopped", "epoch")

# the four cases: (Training keys, chunks of (epochs, pad_to), a validation
# set whose targets the training moves away from)
CASES = {
    "two_chunks_carry": ({}, ((2, None), (2, None)), False),
    "pad_to_inert": ({}, ((3, 5),), False),
    # every epoch that does not halve the best is bad: the rate halves
    # every second epoch
    "plateau_drop": ({"scheduler": {"patience": 1, "threshold": 0.5}}, ((5, None),), False),
    # the validation loss rises from the second epoch: the stop comes there
    "early_stop_mid_chunk": ({"EarlyStopping": True, "patience": 1}, ((4, 6),), True),
}


def _val_hosts(collate, contrary):
    """The validation batch: the first training batch, or its graphs with
    targets the training moves away from (``-3 - t``)."""
    graphs = _graphs(seed=0)
    if contrary:
        for g in graphs:
            g.targets = [-3.0 - t for t in g.targets]
    return [collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])]


def _training(extra):
    training = copy.deepcopy(ADAMW)  # lr 1e-3: the update tolerances' rate
    training.update(copy.deepcopy(extra))
    return training


def _run_both(case):
    """JAX's and the port's ``fit_staged`` through the case's chunks from
    the same weights; returns what each gave and the port's start."""
    extra, chunks, contrary = CASES[case]
    cfg = arch(hidden=8, layers=2)
    training = _training(extra)
    jhosts, hosts = _hosts(jax_collate), _hosts(collate_graphs)
    jtrainer = JaxTrainer(jax_create_model_config(cfg), training)
    jstate = jtrainer.init_state(jhosts[0])
    model = create_model_config(cfg, device="cpu", aggregation="segment")
    trainer = Trainer(model, training)
    state = trainer.init_state(hosts[0])
    _sync(model, state.optimizer, jstate)
    old = _port_variables(model)
    jstaged = jtrainer.stage_batches(jhosts)
    jval = jtrainer.stage_batches(_val_hosts(jax_collate, contrary))
    staged, val = trainer.stage_batches(hosts), trainer.stage_batches(
        _val_hosts(collate_graphs, contrary))
    rng = jax.random.PRNGKey(0)
    jsched = jbest = sched = best = None
    jseries, series = [], []
    for epochs, pad_to in chunks:
        jstate, jbest, jsched, rng, js = jtrainer.fit_staged(
            jstate, jstaged, epochs, rng, staged_val=jval, shuffle=False, sched=jsched,
            best_state=jbest, pad_to=pad_to)
        state, best, sched, s = trainer.fit_staged(
            state, staged, epochs, staged_val=val, shuffle=False, sched=sched, best_state=best,
            pad_to=pad_to)
        jseries.append(js)
        series.append(s)
    join = lambda ss, k: np.concatenate([np.asarray(x[k]) for x in ss])  # noqa: E731
    return {
        "cfg": cfg, "old": old, "model": model, "jstate": jstate, "jbest": jbest,
        "best": best, "sched": sched.to_host(), "jsched": {k: np.asarray(getattr(jsched, k))
                                                          for k in FIT_SCHED_FIELDS},
        "series": {k: join(series, k) for k in ("train_loss", "val_loss", "test_loss", "lr",
                                                 "stopped", "train_tasks")},
        "jseries": {k: join(jseries, k) for k in ("train_loss", "val_loss", "test_loss", "lr",
                                                   "stopped", "train_tasks")},
        "host_sched": series[-1]["sched"], "state": state,
    }


@pytest.mark.parametrize("case", sorted(CASES))
def pytest_fit_staged_matches_jax(case):
    out = _run_both(case)
    got, want = out["series"], out["jseries"]
    for key in ("train_loss", "val_loss", "test_loss", "train_tasks"):
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(want[key]), err_msg=key)
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(got["lr"], want["lr"])
    np.testing.assert_array_equal(got["stopped"], want["stopped"])
    for k in FIT_SCHED_FIELDS:
        if k in COUNTS:
            assert out["sched"][k] == out["jsched"][k], k
            assert out["sched"][k].dtype == out["jsched"][k].dtype, k
        else:
            np.testing.assert_allclose(out["sched"][k], out["jsched"][k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        # the series' own copy of the state (the chunk's one readback)
        np.testing.assert_array_equal(out["host_sched"][k], out["sched"][k], err_msg=k)
    steps = int(out["sched"]["epoch"]) * 3
    _hold_updates(_updates(out["model"], out["cfg"], out["jstate"], out["old"]), steps)
    # the best state: its own weights and count against JAX's best
    _hold_updates(_updates(out["best"].model, out["cfg"], out["jbest"], out["old"]), steps)
    assert out["best"].step == int(np.asarray(out["jbest"].step))
    assert out["state"].step == int(np.asarray(out["jstate"].step)) == steps
    if case == "plateau_drop":
        assert len(set(got["lr"].tolist())) >= 2
    if case == "early_stop_mid_chunk":
        stop = int(np.argmax(got["stopped"]))
        assert got["stopped"].any() and stop < 3, got
        assert np.isnan(got["train_loss"][stop + 1:]).all()
        assert steps == 3 * (stop + 1)


def pytest_fit_staged_equals_the_per_epoch_staged_loop():
    cfg = arch(hidden=8, layers=2)
    training = _training({"EarlyStopping": True, "patience": 3})
    hosts = _hosts(collate_graphs)
    runs = []
    for _ in range(2):
        model = create_model_config(cfg, device="cpu", aggregation="segment")
        trainer = Trainer(model, training)
        runs.append((trainer, trainer.init_state(hosts[0]), trainer.stage_batches(hosts),
                     trainer.stage_batches(hosts[:1])))
    (t1, s1, st1, v1), (t2, s2, st2, v2) = runs
    train, vals = [], []
    for _ in range(4):
        s1, loss, _ = t1.train_epoch_staged(s1, st1)
        train.append(loss)
        vals.append(t1.evaluate_staged(s1, v1)[0])
    s2, _, sched, series = t2.fit_staged(s2, st2, 4, staged_val=v2, pad_to=6)
    np.testing.assert_allclose(series["train_loss"], train, rtol=1e-6, atol=0)
    np.testing.assert_allclose(series["val_loss"], vals, rtol=1e-6, atol=0)
    for a, b in zip(state_tensors(s1.model, s1.optimizer), state_tensors(s2.model, s2.optimizer)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert s1.step == s2.step == 12 and int(sched.epoch) == 4


# ---- run_training in chunks --------------------------------------------------------

def _chunked(raw_dirs, restage):  # noqa: F811
    config = copy.deepcopy(raw_dirs)
    config["NeuralNetwork"]["Training"].update(
        num_epoch=4, fit_chunk_epochs=2, device_resident_dataset=True,
        restage_per_chunk=restage, checkpoint_keep_last=3, checkpoint_warmup=1)
    return config


def _meta(path):
    return ckpt.pop_train_meta(ckpt.parse_checkpoint_bytes(open(path, "rb").read(), path))


def _first_chunk(logs, name):
    """The rolling checkpoint of the first chunk (epoch 1)."""
    for path in glob.glob(os.path.join(logs, name, name + ".roll-*.pk")):
        if int(_meta(path)["epoch"]) == 1:
            return path
    raise AssertionError(f"no epoch-1 checkpoint under {logs}")


def _hold_final_weights(port_dir, jax_dir, name, lr, steps):
    """The final checkpoints' weights and statistics, as
    ``test_torch_run_training.py`` holds them."""
    jfinal = ckpt.load_state_dict(name, path=str(jax_dir / "logs"), fallback=False)
    pfinal = ckpt.load_state_dict(name, path=str(port_dir / "logs"), fallback=False)
    assert int(np.asarray(pfinal["step"])) == int(np.asarray(jfinal["step"])) == steps
    bound = _null_space_bound(lr, steps)
    want, got = dict(_flat(jfinal["params"])), dict(_flat(pfinal["params"]))
    assert got.keys() == want.keys()
    for path in want:
        if _null_space(path):
            np.testing.assert_allclose(got[path], want[path], atol=bound, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], want[path], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=path)
    stats = dict(_flat(pfinal["batch_stats"]))
    for path, w in _flat(jfinal["batch_stats"]):
        atol = bound if path.endswith("mean") else PARAM_ATOL
        np.testing.assert_allclose(stats[path], w, rtol=PARAM_RTOL, atol=atol, err_msg=path)
    return ckpt.pop_train_meta(pfinal), ckpt.pop_train_meta(jfinal)


def _start_checkpoint(config, start, monkeypatch):
    """JAX's starting checkpoint of ``config`` under ``start``; returns the
    config that continues from it."""
    _in_dir(monkeypatch, start)
    jcfg, jl = _loaders(config, True)
    jcfg = jax_config.update_config(jcfg, *jl)
    _, _, jstate = jax_driver._build_model_and_trainer(jcfg, jl[0], 0)
    jax_ckpt.save_model(jstate, "start", path=str(start / "logs"))
    warm = copy.deepcopy(config)
    warm["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": "start"})
    return warm


def _resume_from(path, tmp, name):
    os.makedirs(tmp / "logs" / name, exist_ok=True)
    shutil.copy(path, tmp / "logs" / name / (name + ".pk"))


# JAX's starting checkpoint and the port's per-epoch run from it, shared by
# both cases of the chunked test: the start is one JAX init, and the
# per-epoch path reads no restage flag
_PER_EPOCH = {}


def _per_epoch_run(config, tmp_path, monkeypatch):
    """``(start directory, per-epoch run directory, its history)``."""
    if not _PER_EPOCH:
        start = tmp_path / "start"
        per_epoch = _start_checkpoint(config, start, monkeypatch)
        per_epoch["NeuralNetwork"]["Training"]["fit_chunk_epochs"] = 0
        _in_dir(monkeypatch, tmp_path / "per_epoch")
        shutil.copytree(start / "logs", tmp_path / "per_epoch" / "logs")
        own = hydragnn_tpu_torch.run_training(copy.deepcopy(per_epoch), device="cpu")
        _PER_EPOCH.update(start=start, run=tmp_path / "per_epoch", history=own.info["history"])
    return _PER_EPOCH["start"], _PER_EPOCH["run"], _PER_EPOCH["history"]


@pytest.mark.parametrize("restage", [False, True])
def pytest_run_training_in_chunks_matches_jax_and_resumes_across(raw_dirs, tmp_path,  # noqa: F811
                                                                 monkeypatch, restage):
    config = _chunked(raw_dirs, restage)
    start, per_epoch_dir, own = _per_epoch_run(config, tmp_path, monkeypatch)
    warm = copy.deepcopy(config)
    warm["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": "start"})
    for side in ("jax", "port"):
        _in_dir(monkeypatch, tmp_path / side)
        shutil.copytree(start / "logs", tmp_path / side / "logs")
        if side == "jax":
            hydragnn_tpu.run_training(copy.deepcopy(warm))
        else:
            state = hydragnn_tpu_torch.run_training(copy.deepcopy(warm), device="cpu")
    name = state.info["log_name"]
    history = state.info["history"]
    assert [h["epoch"] for h in history] == [h["epoch"] for h in own] == [0, 1, 2, 3]
    assert [h["chunk"] for h in history] == [0, 0, 2, 2]
    scalars = _scalars(tmp_path / "jax" / "logs" / name / "scalars.jsonl")
    for key, tag in (("train_loss", "train error"), ("val_loss", "validate error"),
                     ("test_loss", "test error")):
        n = 4 if key == "train_loss" else 1  # the drift above
        np.testing.assert_allclose([h[key] for h in history][:n], scalars[tag][:n], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        m = 2 if restage else 4  # a restaged chunk sums its batch in another order
        np.testing.assert_allclose([h[key] for h in history][:m], [h[key] for h in own][:m],
                                   rtol=1e-6, atol=0, err_msg=key)
    lr = float(config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"])
    pmeta, jmeta = _hold_final_weights(tmp_path / "port", tmp_path / "jax", name, lr, steps=4)
    hmeta = _meta(str(per_epoch_dir / "logs" / name / (name + ".pk")))
    assert int(pmeta["epoch"]) == int(jmeta["epoch"]) == 3
    for k in FIT_SCHED_FIELDS:
        got, want = np.asarray(pmeta["fit_sched"][k]), np.asarray(jmeta["fit_sched"][k])
        assert got.dtype == want.dtype and got.shape == want.shape == (), k
        if k in COUNTS:
            assert got == want, k
    if not restage:
        # the losses it holds: the host trackers' of the per-epoch run
        for k, (section, key) in (("plateau_best", ("plateau", "best")),
                                  ("early_best", ("early", "best")),
                                  ("best_val", ("best_ckpt", "best"))):
            np.testing.assert_allclose(float(pmeta["fit_sched"][k]), float(hmeta[section][key]),
                                       rtol=1e-6, atol=0, err_msg=k)
        # the host trackers mirrored from the device's state
        for section in ("plateau", "early"):
            for key, value in hmeta[section].items():
                np.testing.assert_allclose(float(pmeta[section][key]), float(value),
                                           rtol=1e-6, err_msg=f"{section}.{key}")
    # each package resumes the other's first chunk, onto the other's own run
    resume = copy.deepcopy(config)
    resume["NeuralNetwork"]["Training"]["continue"] = 1
    for side, other in (("port_from_jax", "jax"), ("jax_from_port", "port")):
        _in_dir(monkeypatch, tmp_path / side)
        _resume_from(_first_chunk(str(tmp_path / other / "logs"), name), tmp_path / side, name)
        if side == "port_from_jax":
            resumed = hydragnn_tpu_torch.run_training(copy.deepcopy(resume), device="cpu")
            got = [h["train_loss"] for h in resumed.info["history"]]
            assert [h["epoch"] for h in resumed.info["history"]] == [2, 3]
            want = scalars["train error"][2:]
        else:
            hydragnn_tpu.run_training(copy.deepcopy(resume))
            got = _scalars(tmp_path / side / "logs" / name / "scalars.jsonl")["train error"]
            want = [h["train_loss"] for h in history][2:]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=side)


def pytest_guarded_run_training_matches_jax(raw_dirs, tmp_path, monkeypatch):  # noqa: F811
    config = copy.deepcopy(raw_dirs)
    config["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=14,
                                               divergence_guard=True)
    warm = _start_checkpoint(config, tmp_path / "start", monkeypatch)
    monkeypatch.setenv("HYDRAGNN_FAULT_NAN_AT_STEP", "1")
    for side in ("jax", "port"):
        _in_dir(monkeypatch, tmp_path / side)
        shutil.copytree(tmp_path / "start" / "logs", tmp_path / side / "logs")
        if side == "jax":
            hydragnn_tpu.run_training(copy.deepcopy(warm))
        else:
            state = hydragnn_tpu_torch.run_training(copy.deepcopy(warm), device="cpu")
    name = state.info["log_name"]
    assert state.info["guard"] == {"skipped": 1, "restores": 0}
    scalars = _scalars(tmp_path / "jax" / "logs" / name / "scalars.jsonl")
    np.testing.assert_allclose([h["train_loss"] for h in state.info["history"]],
                               scalars["train error"], rtol=RTOL, atol=ATOL)
    lr = float(config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"])
    pmeta, jmeta = _hold_final_weights(tmp_path / "port", tmp_path / "jax", name, lr, steps=3)
    assert {k: int(v) for k, v in pmeta["guard"].items()} == {
        k: int(v) for k, v in jmeta["guard"].items()} == {"skipped": 1, "restores": 0}
