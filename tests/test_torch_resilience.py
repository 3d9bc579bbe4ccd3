"""The port's fault tolerance against the JAX package's, on the CPU, with
injected faults (``hydragnn_tpu_torch/utils/faults.py``), after
``tests/test_resilience.py``.

- The divergence guard on PNA (hidden 8, 2 layers, ``segment``; the three
  batches of ``test_torch_capture.py``, AdamW at lr 1e-3), the port's
  ``Trainer.train_epoch`` against JAX's from the same weights under the
  same ``HYDRAGNN_FAULT_NAN_AT_STEP``, four batches an epoch, last-good
  committed after each epoch as the epoch driver does: one poisoned step
  skipped; three in a row (in the second epoch) restored with the rate
  halved; every step poisoned raising
  ``RuntimeError`` past ``HYDRAGNN_GUARD_MAX_RESTORES``, with JAX's
  message. The counters, the step count and the rate equal JAX's; the
  epoch losses at rtol 1e-4 / atol 1e-5 and the final weights, as updates
  from the start, at ``test_torch_capture.py``'s update tolerances (rtol
  1e-4, atol 2e-7 a step; the biases BatchNorm cancels as that file
  documents).
- The NaN sentinel (``HYDRAGNN_NAN_SENTINEL=1``): the order it searches
  and the JAX paths it prints are those of JAX's ``(state, metrics)``
  tree; a parameter set to NaN is named by its key and path; a poisoned
  step raises ``NonFiniteError`` naming the first non-finite tensor in
  that order, where the JAX sentinel raises too. Which tensors a NaN
  input reaches through masks differs between the packages (JAX's
  ``where`` stops it where the port's products carry it: after the same
  poisoned step JAX's first BatchNorm bias is finite and the port's is
  not), so the two need not name the same first tensor.
- Faults and retry: a flaky serialized read is retried, ``retry_io``
  gives up after its budget, a missing file is not retried, and a
  corrupted checkpoint falls back to its last good rolling copy; the
  ``fit_sched`` section's 0-d bool, int32 and float32 arrays are flax's
  bytes; the guard's counters and ``check_remaining``'s parse equal JAX's.
- Kill and resume (``tests/_torch_resilience_worker.py``, in subprocesses):
  a run killed by ``HYDRAGNN_FAULT_KILL_AT_STEP`` in the middle of epoch 2
  (streaming) or of its second chunk (``fit_chunk_epochs`` 2) resumes from
  the last checkpoint, trains only the remaining epochs, and ends on the
  uninterrupted run's weights and rate bit for bit.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.parallel import distributed as jax_distributed
from hydragnn_tpu.train.guard import DivergenceGuard as JaxGuard
from hydragnn_tpu.train.optimizer import get_learning_rate as jax_get_learning_rate
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

import torch

from hydragnn_tpu_torch.analysis import NonFiniteError, nan_origin
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.data.serialized import SerializedGraphLoader
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.parallel import distributed
from hydragnn_tpu_torch.train import DivergenceGuard, Trainer
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.train import msgpack_codec
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.train.optimizer import get_learning_rate
from hydragnn_tpu_torch.train.steps import sentinel_tree
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.retry import backoff_delay, retry_io

from _torch_resilience_worker import make_samples
from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_capture import _hold_updates, _hosts, _sync, _updates
from test_torch_pna import arch
from test_torch_train import ADAMW, _port_variables

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_resilience_worker.py")


CFG = arch(hidden=8, layers=2)


def _pair():
    """JAX's and the port's trainer, state and four batches (a list serves
    as the loader) from the same weights (the JAX trainer's)."""
    training = dict(ADAMW)
    jloader, loader = _hosts(jax_collate, range(4)), _hosts(collate_graphs, range(4))
    jtrainer = JaxTrainer(jax_create_model_config(CFG), training)
    jstate = jtrainer.init_state(jloader[0])
    trainer = Trainer(create_model_config(CFG, device="cpu", aggregation="segment"), training)
    state = trainer.init_state(loader[0])
    _sync(state.model, state.optimizer, jstate)
    return (jtrainer, jstate, jloader), (trainer, state, loader)


def _epochs(jax_side, trainer, state, loader, n):
    rng = jax.random.PRNGKey(0)
    losses = []
    for _ in range(n):
        if jax_side:
            state, rng, loss, _ = trainer.train_epoch(state, loader, rng)
        else:
            state, loss, _ = trainer.train_epoch(state, loader)
        if trainer.guard is not None:
            trainer.guard.commit(state)  # the epoch driver's finite-epoch commit
        losses.append(loss)
    return state, losses


# (HYDRAGNN_FAULT_NAN_AT_STEP, epochs of 4 steps, skipped, restores)
GUARD_CASES = {"one_step_skipped": ("2", 3, 1, 0),
               "streak_restores_with_halved_rate": ("4:7", 3, 3, 1)}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def pytest_guard_matches_jax_trainer(monkeypatch, case):
    spec, epochs, skipped, restores = GUARD_CASES[case]
    monkeypatch.setenv("HYDRAGNN_DIVERGENCE_GUARD", "1")
    monkeypatch.setenv("HYDRAGNN_FAULT_NAN_AT_STEP", spec)
    (jtrainer, jstate, jloader), (trainer, state, loader) = _pair()
    old = _port_variables(state.model)
    jstate, jlosses = _epochs(True, jtrainer, jstate, jloader, epochs)
    state, losses = _epochs(False, trainer, state, loader, epochs)
    assert (trainer.guard.skipped, trainer.guard.restores) == (skipped, restores)
    assert (jtrainer.guard.skipped, jtrainer.guard.restores) == (skipped, restores)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    assert get_learning_rate(state.optimizer) == float(jax_get_learning_rate(jstate.opt_state))
    if restores:
        assert get_learning_rate(state.optimizer) == pytest.approx(5e-4, rel=1e-6)
    steps = int(np.asarray(jstate.step))
    # a restore goes back to the last commit: here that undoes no good step
    assert state.step == steps == 4 * epochs - skipped
    _hold_updates(_updates(state.model, CFG, jstate, old), steps)


def pytest_unbounded_divergence_fails_loudly_as_jax(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_DIVERGENCE_GUARD", "1")
    monkeypatch.setenv("HYDRAGNN_FAULT_NAN_AT_STEP", "0:")
    monkeypatch.setenv("HYDRAGNN_GUARD_MAX_RESTORES", "1")
    (jtrainer, jstate, jloader), (trainer, state, loader) = _pair()
    messages = []
    for jax_side, (t, s, ld) in ((True, (jtrainer, jstate, jloader)),
                                 (False, (trainer, state, loader))):
        with pytest.raises(RuntimeError, match="divergence guard") as err:
            _epochs(jax_side, t, s, ld, 4)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert (trainer.guard.skipped, trainer.guard.restores) == (
        jtrainer.guard.skipped, jtrainer.guard.restores)


def pytest_guard_counters_round_trip_as_jax():
    port, ref = DivergenceGuard({}), JaxGuard({})
    assert (port.max_bad_steps, port.max_restores, port.lr_factor) == (
        ref.max_bad_steps, ref.max_restores, ref.lr_factor) == (3, 2, 0.5)
    ref.skipped, ref.restores = 5, 1
    port.load_state_dict(ref.state_dict())
    assert port.state_dict() == ref.state_dict() == {"skipped": 5, "restores": 1}


def pytest_nan_sentinel_names_the_tensor_in_jax_order(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_NAN_SENTINEL", "1")
    (jtrainer, jstate, jloader), (trainer, state, loader) = _pair()
    tree = sentinel_tree(state.model, state.optimizer, {"loss": torch.zeros(())})
    paths = [name.split(" = ")[1] for name, _ in tree if " = [0]." in name]
    want = [f"[0].{part}" + jax.tree_util.keystr(path)
            for part in ("params", "batch_stats")
            for path, _ in jax.tree_util.tree_flatten_with_path(getattr(jstate, part))[0]]
    assert paths == want
    # a parameter set to NaN: named by its key and its JAX path
    name, param = list(state.model.named_parameters())[5]
    with torch.no_grad():
        saved = param.clone()
        param.view(-1)[0] = float("nan")
    origin = nan_origin(sentinel_tree(state.model, state.optimizer, {}), "t")
    assert origin["origin"].startswith(name + " = [0].params[") and origin["leaves"] == 1
    with torch.no_grad():
        param.copy_(saved)
    # a poisoned step: the first non-finite tensor in that order
    jbatch = jtrainer.put_batch(jloader[0])
    with pytest.raises(Exception) as jerr:
        jtrainer._train_step(jstate, jbatch.replace(x=jbatch.x * jnp.nan),
                             jax.random.PRNGKey(0))
    assert type(jerr.value).__name__ == "NonFiniteError"
    assert jerr.value.origin["origin"] in paths
    with pytest.raises(NonFiniteError) as err:
        trainer.train_step(state, dataclasses.replace(loader[0], x=loader[0].x * float("nan")))
    first = next(n for n, t in sentinel_tree(state.model, state.optimizer, {})
                 if not torch.isfinite(t).all())
    assert err.value.origin["origin"] == first and " = [0].params[" in first
    assert first.split(" = ")[0] in str(err.value)
    # a finite step passes through the sentinel
    model = create_model_config(CFG, device="cpu", aggregation="segment")
    fresh = Trainer(model, dict(ADAMW))
    fresh.train_step(fresh.init_state(loader[0]), loader[0])


# ---- faults and retry ---------------------------------------------------------------

def _serialized(tmp_path):
    samples = []
    for g in make_samples(GraphData, 3):
        samples.append(GraphData(x=g.x, pos=g.pos * 3.0, y=np.array([g.x.sum()], np.float32)))
    path = tmp_path / "split.pkl"
    with open(path, "wb") as f:
        for obj in (np.zeros((2, 1)), np.zeros((2, 1)), samples):
            pickle.dump(obj, f)
    config = {"Dataset": {"node_features": {"dim": [1]}, "graph_features": {"dim": [1]}},
              "NeuralNetwork": {"Architecture": {"radius": 2.0, "max_neighbours": 8},
                                "Variables_of_interest": {"type": ["graph"], "output_index": [0],
                                                          "input_node_features": [0]}}}
    return str(path), config, samples


def pytest_flaky_serialized_reads_are_retried(monkeypatch, tmp_path):
    path, config, samples = _serialized(tmp_path)
    monkeypatch.setenv("HYDRAGNN_IO_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("HYDRAGNN_FAULT_FLAKY_READ", "2")
    faults.reset()
    got = SerializedGraphLoader(config).load_serialized_data(path)
    assert len(got) == 3
    np.testing.assert_allclose(got[1].x, samples[1].x)
    monkeypatch.setenv("HYDRAGNN_IO_RETRIES", "2")
    faults.reset()
    with pytest.raises(OSError, match="injected"):
        SerializedGraphLoader(config).load_serialized_data(path)
    faults.reset()


def pytest_retry_gives_up_after_budget_and_skips_missing_files(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_FAULT_FLAKY_READ", "10")
    faults.reset()
    attempts = []

    def read():
        attempts.append(1)
        faults.flaky_read("t")
        return 1

    with pytest.raises(OSError, match="injected"):
        retry_io(read, attempts=3, base_delay=0.001)
    assert len(attempts) == 3
    faults.reset()
    missing = []

    def gone():
        missing.append(1)
        raise FileNotFoundError("gone")

    with pytest.raises(FileNotFoundError):
        retry_io(gone, attempts=5, base_delay=0.001)
    assert len(missing) == 1
    for attempt in range(4):
        delay = backoff_delay(attempt, 0.01)
        assert 0.01 * 2 ** attempt <= delay <= 1.5 * 0.01 * 2 ** attempt


def pytest_corrupt_checkpoint_falls_back_to_last_good(monkeypatch, tmp_path):
    faults.reset()
    monkeypatch.setenv("HYDRAGNN_FAULT_CORRUPT_CHECKPOINT", "2")
    tree = lambda step: {"params": {"w": np.arange(4, dtype=np.float32) + step},  # noqa: E731
                         "batch_stats": {}, "opt_state": {}, "step": np.int32(step)}
    for step in (0, 1):
        ckpt.save_model(tree(step), "m", path=str(tmp_path), train_meta={"epoch": step},
                        keep_last=3)
    with pytest.warns(UserWarning, match="last good"):
        restored = ckpt.load_state_dict("m", path=str(tmp_path))
    assert int(ckpt.pop_train_meta(restored)["epoch"]) == 1
    np.testing.assert_array_equal(restored["params"]["w"], tree(1)["params"]["w"])
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.load_state_dict("m", path=str(tmp_path), fallback=False)
    faults.reset()


def pytest_fit_sched_section_is_flax_bytes():
    section = {"plateau_best": np.asarray(0.25, np.float32), "plateau_bad": np.asarray(2, np.int32),
               "early_best": np.asarray(np.inf, np.float32), "early_count": np.asarray(0, np.int32),
               "stopped": np.asarray(True), "epoch": np.asarray(7, np.int32),
               "best_val": np.asarray(0.25, np.float32)}
    tree = {"train_meta": {"fit_sched": section}}
    raw = msgpack_codec.packb(tree)
    assert raw == serialization.msgpack_serialize(tree)
    back = msgpack_codec.unpackb(raw)["train_meta"]["fit_sched"]
    for k, v in section.items():
        assert back[k].dtype == v.dtype and back[k].shape == () and back[k] == v, k


@pytest.mark.parametrize("text", ["1-02:03:04", "02:03:04", "03:04", "59", "INVALID", ""])
def pytest_slurm_time_left_parses_as_jax(text):
    assert distributed._parse_slurm_timeleft(text) == jax_distributed._parse_slurm_timeleft(text)


def pytest_check_remaining_outside_slurm(monkeypatch):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    assert distributed.check_remaining(1e9) is True


# ---- kill and resume --------------------------------------------------------------

def _spawn(workdir, mode, kind, env=None):
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith(("HYDRAGNN_FAULT_", "HYDRAGNN_RESUME", "HYDRAGNN_CKPT_",
                                  "HYDRAGNN_GUARD_"))}
    clean.update(env or {})
    return subprocess.Popen([sys.executable, WORKER, str(workdir), mode, kind], env=clean,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _worker(workdir, mode, kind, env=None):
    return _finish(_spawn(workdir, mode, kind, env))


@pytest.mark.parametrize("kind", ["stream", "chunk"])
def pytest_kill_and_resume_equals_the_uninterrupted_run(tmp_path, kind):
    ref, killed = tmp_path / "ref", tmp_path / "killed"
    ref.mkdir()
    killed.mkdir()
    # the uninterrupted run and the killed one side by side (two directories)
    procs = (_spawn(ref, "run", kind),
             # 4 steps an epoch: step 9 is in epoch 2, and in the second chunk (2-3)
             _spawn(killed, "run", kind, {"HYDRAGNN_FAULT_KILL_AT_STEP": "9"}))
    done, dead = (_finish(p) for p in procs)
    assert done.returncode == 0, done.stderr[-2000:]
    assert dead.returncode == faults.KILL_EXIT_CODE, dead.stderr[-2000:]
    assert not (killed / "result.json").exists()
    meta = ckpt.pop_train_meta(ckpt.load_state_dict("resil", path=str(killed / "logs")))
    assert int(meta["epoch"]) == 1
    assert ("fit_sched" in meta) == (kind == "chunk")
    resumed = _worker(killed, "resume", kind)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    got = json.load(open(killed / "result.json"))
    want = json.load(open(ref / "result.json"))
    assert got["resumed_from_epoch"] == 2
    assert got["epochs_run"] == [2, 3, 4] and want["epochs_run"] == [0, 1, 2, 3, 4]
    assert got["final_lr"] == want["final_lr"]
    for name, value in want["final_params"].items():
        np.testing.assert_array_equal(np.asarray(got["final_params"][name]), np.asarray(value),
                                      err_msg=name)
