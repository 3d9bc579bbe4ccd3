"""The port's checkpoints against the JAX package's: the payload codec
(``train/msgpack_codec.py``) against ``flax.serialization``, files written
by either package read by the other (``train/checkpoint.py``,
``models/bridge.py``'s two directions), the refusals, the rolling
fallback, the asynchronous writer, and ``ModelRegistry``'s checkpoint
loading and activation stack.

One JAX multi-head PNA state (hidden 16, 2 layers, AdamW after three
steps, its learning rate lowered to 7.5e-4 as ReduceLROnPlateau would)
is shared by the module. Forwards are compared on the real rows at rtol
1e-4 / atol 1e-5 (``test_torch_pna.py``'s); weights and optimizer moments
carried across must be equal exactly (a layout change, no arithmetic).
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import pad_sizes_for
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.train import checkpoint as jax_ckpt
from hydragnn_tpu.train.optimizer import get_learning_rate as jax_lr
from hydragnn_tpu.train.optimizer import set_learning_rate as jax_set_lr
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.models.bridge import (
    flax_variables_of,
    restore_state,
    state_dict_of,
)
from hydragnn_tpu_torch.serve import ModelRegistry
from hydragnn_tpu_torch.train import Trainer, get_learning_rate, set_learning_rate
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.train import msgpack_codec

from test_torch_pna import arch, samples

RTOL, ATOL = 1e-4, 1e-5
HEADS = (("graph", "node"), (1, 2))
PADS = pad_sizes_for(10, 40, 6)
ADAMW = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
LOWERED_LR = 7.5e-4


def _targets(graphs):
    rng = np.random.default_rng(3)
    for g in graphs:
        g.targets = [rng.random(1).astype(np.float32),
                     rng.random((g.x.shape[0], 2)).astype(np.float32)]
    return graphs


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model, a trained state (three AdamW steps, lr lowered) and
    the batch, on the XLA path."""
    cfg = arch()
    graphs = _targets(samples())
    host = jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    jmodel = jax_create_model_config(cfg)
    jtrainer = JaxTrainer(jmodel, ADAMW)
    jstate = jtrainer.init_state(host)
    jbatch = jtrainer.put_batch(host)
    for i in range(3):
        jstate, _ = jtrainer._train_step(jstate, jbatch, jax.random.PRNGKey(i))
    jstate = jstate.replace(opt_state=jax_set_lr(jstate.opt_state, LOWERED_LR))
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    return {"cfg": cfg, "model": jmodel, "trainer": jtrainer, "state": jstate,
            "jbatch": jbatch, "batch": batch, "graphs": graphs}


def _jax_forward(run, state):
    out = run["model"].apply({"params": state.params, "batch_stats": state.batch_stats},
                             run["jbatch"], train=False)
    return [np.asarray(o) for o in out]


def _port_forward(model, batch):
    model.eval()
    with torch.no_grad():
        return [o.numpy() for o in model(batch)]


def _hold_forward(got, want, batch):
    masks = (batch.graph_mask.numpy(), batch.node_mask.numpy())
    for g, w, m in zip(got, want, masks):
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL)


def _port_state(cfg, batch):
    model = create_model_config(cfg, device="cpu", aggregation="segment")
    return Trainer(model, ADAMW).init_state(batch)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(got, torch.Tensor):  # a bfloat16 leaf of the port's decoder
        assert np.asarray(want).dtype.name == "bfloat16", path
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                      np.asarray(want).view(np.uint16), err_msg=path)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, type(got), got)
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert type(got) is type(want) and got == want, (path, got, want)


# ---- the codec ---------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(0)
    bf16 = rng.normal(size=(3, 5)).astype(jnp.bfloat16)
    return {
        "f32": {"a": rng.normal(size=(4, 3)).astype(np.float32)},
        "bf16": {"w": bf16, "b": np.asarray(bf16[0])},
        "int32": {"ids": rng.integers(-5, 2**20, 17).astype(np.int32),
                  "u": np.arange(6, dtype=np.uint32).reshape(2, 3)},
        "scalars": {"npf": np.float32(1.5), "npi": np.int64(-3), "zero_d": np.asarray(2, np.int32),
                    "f": 0.25, "i": 70000, "neg": -40, "big": 2**40, "t": True, "n": None,
                    "s": "x" * 40, "bytes": b"\x00\x01"},
        "nested": {str(i): {"k": {"kernel": rng.normal(size=(2, i + 1)).astype(np.float32)},
                            "empty": {}} for i in range(18)},
        "train_meta": {"format": 2, "epoch": 7, "rng": np.asarray([0, 1337], np.uint32),
                       "plateau": {"lr": 0.02, "best": None, "num_bad_epochs": 3},
                       "early": {"best": 0.125, "counter": 1, "early_stop": False}},
    }


def _to_port_leaves(tree):
    """The same tree with bf16 leaves as torch tensors (the port's form)."""
    if isinstance(tree, dict):
        return {k: _to_port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return tree


@pytest.mark.parametrize("case", sorted(_trees()))
def pytest_codec_round_trips_against_flax(case):
    tree = _trees()[case]
    flax_bytes = serialization.msgpack_serialize(tree)
    mine = msgpack_codec.packb(_to_port_leaves(tree))
    assert mine == flax_bytes
    _assert_trees_equal(msgpack_codec.unpackb(flax_bytes), tree)
    _assert_trees_equal(serialization.msgpack_restore(mine), tree)


def pytest_codec_reads_and_writes_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25), "small": np.ones(3, np.float32)}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    _assert_trees_equal(msgpack_codec.unpackb(flax_bytes), tree)
    mine = msgpack_codec.packb(tree)
    assert mine == flax_bytes
    _assert_trees_equal(serialization.msgpack_restore(mine), tree)


def pytest_codec_refuses_what_it_does_not_know():
    with pytest.raises(ValueError, match="truncated"):
        msgpack_codec.unpackb(msgpack_codec.packb({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_codec.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(TypeError):
        msgpack_codec.packb({"a": [1, 2]})


# ---- files across the packages -----------------------------------------------

def pytest_jax_checkpoint_loads_in_the_port(jax_run, tmp_path):
    jstate = jax_run["state"]
    jax_ckpt.save_model(jstate, "jax_run", path=str(tmp_path))
    restored = ckpt.load_state_dict("jax_run", path=str(tmp_path), fallback=False)
    assert ckpt.pop_train_meta(restored) is None
    state = restore_state(_port_state(jax_run["cfg"], jax_run["batch"]), restored)
    assert state.step == 3
    assert get_learning_rate(state.optimizer) == pytest.approx(LOWERED_LR, rel=1e-7)
    _hold_forward(_port_forward(state.model, jax_run["batch"]), _jax_forward(jax_run, jstate),
                  jax_run["batch"])
    # the tree comes back as the JAX package wrote it: weights, moments and
    # counts exactly, in flax's layout
    _assert_trees_equal(state_dict_of(state), _np(serialization.to_state_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats,
         "opt_state": jstate.opt_state, "step": jstate.step})))


def pytest_port_checkpoint_loads_in_jax(jax_run, tmp_path):
    state = _port_state(jax_run["cfg"], jax_run["batch"])
    trainer = Trainer(state.model, ADAMW)
    for _ in range(2):
        state, _ = trainer.train_step(state, jax_run["batch"])
    set_learning_rate(state.optimizer, LOWERED_LR)
    meta = {"format": 2, "epoch": 4, "rng": np.asarray([0, 1337], np.uint32),
            "plateau": {"lr": LOWERED_LR, "best": 0.5, "num_bad_epochs": 1}}
    ckpt.save_model(state, "port_run", path=str(tmp_path), train_meta=meta)
    fname = tmp_path / "port_run" / "port_run.pk"
    raw = fname.read_bytes()
    parsed = jax_ckpt._parse_checkpoint_bytes(raw, str(fname))
    restored = jax_ckpt.load_state_dict("port_run", path=str(tmp_path), fallback=False)
    jmeta = jax_ckpt.pop_train_meta(restored)
    _assert_trees_equal(jmeta, _np(meta))  # leaves as np.asarray makes them, as JAX writes
    assert jax.random.split(jnp.asarray(jmeta["rng"], jnp.uint32)).shape == (2, 2)
    jstate = jax_ckpt.restore_into(jax_run["state"], restored)
    assert int(jstate.step) == 2 and parsed.keys() == restored.keys() | {"train_meta"}
    assert jax_lr(jstate.opt_state) == pytest.approx(LOWERED_LR, rel=1e-7)
    _hold_forward(_port_forward(state.model, jax_run["batch"]), _jax_forward(jax_run, jstate),
                  jax_run["batch"])
    # JAX's own save of the restored state writes the same bytes back
    jax_ckpt.save_model(jstate, "again", path=str(tmp_path), train_meta=jmeta)
    assert (tmp_path / "again" / "again.pk").read_bytes() == raw
    # and the JAX optimizer steps on from the port's moments and lr
    stepped, metrics = jax_run["trainer"]._train_step(jstate, jax_run["jbatch"],
                                                      jax.random.PRNGKey(9))
    assert np.isfinite(float(metrics["loss"])) and int(stepped.step) == 3


def pytest_lr_and_moments_carry_both_ways(jax_run, tmp_path):
    """JAX -> port -> JAX: the optimizer's tree, the lowered lr among it,
    is the one JAX wrote."""
    jstate = jax_run["state"]
    jax_ckpt.save_model(jstate, "there", path=str(tmp_path))
    state = restore_state(_port_state(jax_run["cfg"], jax_run["batch"]),
                          ckpt.load_state_dict("there", path=str(tmp_path)))
    ckpt.save_model(state, "back", path=str(tmp_path))
    assert (tmp_path / "back" / "back.pk").read_bytes() == \
        (tmp_path / "there" / "there.pk").read_bytes()


# ---- refusals and recovery ---------------------------------------------------

def _saved(tmp_path, name="run", keep_last=None, tree=None):
    tree = tree or {"params": {"w": np.arange(6, dtype=np.float32)}}
    ckpt.save_model(tree, name, path=str(tmp_path), keep_last=keep_last)
    return tmp_path / name / f"{name}.pk"


def pytest_corruption_truncation_and_future_versions_are_refused(tmp_path):
    path = _saved(tmp_path)
    raw = bytearray(path.read_bytes())
    raw[-5] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC mismatch"):
        ckpt.load_state_dict("run", path=str(tmp_path))
    path.write_bytes(path.read_bytes()[:10])
    with pytest.raises(ValueError, match="truncated inside the header"):
        ckpt.load_state_dict("run", path=str(tmp_path))
    good = _saved(tmp_path).read_bytes()
    path.write_bytes(good[:-4])
    with pytest.raises(ValueError, match="CRC mismatch"):
        ckpt.load_state_dict("run", path=str(tmp_path))
    future = ckpt.MAGIC + struct.pack("<II", ckpt.VERSION + 1, 0) + good[16:]
    path.write_bytes(future)
    with pytest.raises(ValueError, match="format version 3"):
        ckpt.load_state_dict("run", path=str(tmp_path))
    # the JAX package refuses the same bytes for the same reason
    with pytest.raises(ValueError, match="format version 3"):
        jax_ckpt._parse_checkpoint_bytes(future, "run")


def pytest_rolling_fallback_restores_the_newest_intact_file(tmp_path):
    for i in range(4):
        _saved(tmp_path, keep_last=3, tree={"params": {"w": np.full(3, i, np.float32)}})
    rolls = ckpt.rolling_checkpoints("run", path=str(tmp_path))
    assert [os.path.basename(p) for p in rolls] == [
        "run.roll-000003.pk", "run.roll-000002.pk", "run.roll-000001.pk"]
    primary = tmp_path / "run" / "run.pk"
    primary.write_bytes(primary.read_bytes()[:-2])
    with open(rolls[0], "r+b") as f:  # the newest copy is bad too
        f.seek(20)
        f.write(b"\xff\xff")
    with pytest.warns(UserWarning, match="run.roll-000002.pk"):
        restored = ckpt.load_state_dict("run", path=str(tmp_path))
    np.testing.assert_array_equal(restored["params"]["w"], np.full(3, 2, np.float32))
    with pytest.raises(ValueError, match="CRC mismatch"):
        ckpt.load_state_dict("run", path=str(tmp_path), fallback=False)
    primary.unlink()
    with pytest.warns(UserWarning):
        assert ckpt.load_state_dict("run", path=str(tmp_path))["params"]["w"][0] == 2
    # the JAX loader walks back over the port's rolling files the same way
    with pytest.warns(UserWarning, match="run.roll-000002.pk"):
        jax_ckpt.load_state_dict("run", path=str(tmp_path))


def pytest_async_writer_snapshots_an_owned_copy(jax_run, tmp_path):
    state = restore_state(_port_state(jax_run["cfg"], jax_run["batch"]),
                          jax_ckpt._state_dict(jax_run["state"]))
    writer = ckpt.AsyncCheckpointWriter(max_pending=1)
    try:
        want = jax.tree_util.tree_map(np.copy, state_dict_of(state))
        ckpt.save_model(state, "async", path=str(tmp_path), writer=writer, keep_last=2)
        with torch.no_grad():  # the run goes on: the snapshot must not see it
            for p in state.model.parameters():
                p.add_(1.0)
        assert writer.drain(timeout=60)
    finally:
        writer.close()
    _assert_trees_equal(ckpt.load_state_dict("async", path=str(tmp_path), fallback=False), want)
    assert len(ckpt.rolling_checkpoints("async", path=str(tmp_path))) == 1
    failing = ckpt.AsyncCheckpointWriter()
    failing.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        failing.drain(timeout=60)
    failing.close()


# ---- the registry -------------------------------------------------------------

def _write_run(jax_run, tmp_path, name, state=None):
    jax_ckpt.save_model(state or jax_run["state"], name, path=str(tmp_path))
    with open(tmp_path / name / "config.json", "w") as f:
        json.dump({"NeuralNetwork": {"Architecture": jax_run["cfg"], "Training": ADAMW}}, f)


def pytest_registry_loads_promotes_and_rolls_back(jax_run, tmp_path):
    _write_run(jax_run, tmp_path, "v1")
    shifted = jax_run["state"].replace(params=jax.tree_util.tree_map(
        lambda p: p * 0.5, jax_run["state"].params))
    _write_run(jax_run, tmp_path, "v2", shifted)
    reg = ModelRegistry()
    e1 = reg.load_checkpoint("v1", path=str(tmp_path), name="pna", device="cpu")
    assert (e1.version, e1.source) == (1, os.path.join(str(tmp_path), "v1"))
    _hold_forward(_port_forward(e1.model, jax_run["batch"]),
                  _jax_forward(jax_run, jax_run["state"]), jax_run["batch"])
    e2 = reg.promote_checkpoint("v2", path=str(tmp_path), name="pna", device="cpu")
    assert reg.active_version("pna") == 2 and e2.source.endswith("v2")
    _hold_forward(_port_forward(reg.get("pna").model, jax_run["batch"]),
                  _jax_forward(jax_run, shifted), jax_run["batch"])
    assert reg.promote("pna", 2) is e2  # the active version again: no new step
    assert reg.rollback("pna") is e1 and reg.active_version("pna") == 1
    with pytest.raises(ValueError, match="roll back"):
        reg.rollback("pna")
    reg.promote("pna", 2)
    assert reg.describe()["pna"] == {"version": 2, "latest": 2, "versions": 2,
                                     "output_type": ["graph", "node"], "output_dim": [1, 2],
                                     "source": os.path.join(str(tmp_path), "v2")}
    # a corrupt candidate: refused, and the registry as it was
    _write_run(jax_run, tmp_path, "bad")
    bad = tmp_path / "bad" / "bad.pk"
    bad.write_bytes(bad.read_bytes()[:-7])
    before = reg.describe()
    with pytest.raises(ValueError, match="CRC mismatch"):
        reg.promote_checkpoint("bad", path=str(tmp_path), name="pna", device="cpu")
    assert reg.describe() == before and reg.active_version("pna") == 2
    # a file without params is not a model checkpoint
    ckpt.save_model({"step": np.asarray(1, np.int32)}, "empty", path=str(tmp_path))
    with pytest.raises(ValueError, match="no 'params'"):
        reg.load_checkpoint("empty", arch_config=jax_run["cfg"], path=str(tmp_path),
                            device="cpu")
    with pytest.raises(KeyError):
        reg.promote("pna", 9)


def pytest_flax_variables_round_trip_every_layout():
    """Every leaf kind of the bridge's table maps back to its own name:
    Dense kernels (transposed), MLP finals, BatchNorm scales and
    statistics, MLPNode banks, raw parameters."""
    cfg = dict(arch(node_type="mlp_per_node"))
    model = create_model_config(cfg, device="cpu", aggregation="segment")
    variables = flax_variables_of(model)
    other = create_model_config(cfg, device="cpu", aggregation="segment", seed=5)
    from hydragnn_tpu_torch.models import load_flax_variables

    load_flax_variables(other, variables)
    for (name, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
