"""The rest of ``run_training``'s training surface against the JAX package:
every optimizer type, ``freeze_conv``, the optimizer states through v2
checkpoints both ways, conv checkpointing, the compact wire format, the
test-data dump and one periodic CFG run.

- Every type of ``hydragnn_tpu/train/optimizer.py``'s table takes 10 steps
  of a tiny multi-head PNA through the port's ``Trainer`` and the JAX
  ``Trainer`` (on its XLA path) from the same weights: losses at rtol
  1e-4 / atol 1e-5, the parameters after at ``test_torch_train.py``'s
  ``PARAM_RTOL`` / ``PARAM_ATOL`` (the biases a BatchNorm cancels carried
  across each step, as there). Under ``freeze_conv`` the encoder's
  parameters stay bit-equal to where they started.
- Each run's optimizer state goes through a checkpoint file both ways: a
  JAX checkpoint restored in the port writes back the JAX package's tree
  exactly; a port checkpoint restored in JAX is saved again by JAX to the
  same bytes.
- Conv checkpointing (PNA, and GAT with its attention dropout drawn from
  the trainer's generator) gives the losses, gradients and updates of the
  same run without it, bit for bit on the CPU.
- The compact wire format (int16 ids, the position placeholder) on and
  off: the same trajectory, bit for bit; SchNet keeps its positions.
- One ``run_training`` + ``run_prediction`` of a periodic CFG dataset
  (the smoke's generator, FCC NiNb) in each package: the per-epoch losses
  at rtol 1e-4 / atol 1e-5 and the ``HYDRAGNN_DUMP_TESTDATA`` files the
  same keys, shapes and values at that tolerance.
"""

import copy
import shutil

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.train import checkpoint as jax_ckpt
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

import chip_smoke
import hydragnn_tpu
import hydragnn_tpu_torch
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.bridge import restore_state, state_dict_of
from hydragnn_tpu_torch.train import Trainer
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.train.transfer import compact_for_transfer, decompact, wire_bytes

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_checkpoint import _assert_trees_equal
from test_torch_gat_mfc_cgcnn import arch as family_arch
from test_torch_pna import arch
from test_torch_train import (
    HEADS,
    PADS,
    PARAM_ATOL,
    PARAM_RTOL,
    _assert_same_variables,
    _carry_null_space,
    _graphs,
    _np,
)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 10
# a rate each rule moves the tiny PNA with in 10 steps (Adadelta's is torch's default)
RATES = {"SGD": 1e-2, "Adadelta": 1.0, "Adagrad": 1e-2, "Adamax": 2e-3, "RMSprop": 1e-3,
         "LAMB": 1e-2, "FusedLAMB": 1e-2, "Adam": 1e-3, "AdamW": 1e-3}
CASES = [(t, False) for t in RATES] + [("AdamW", True), ("Adagrad", True)]


def _config(opt_type):
    return {"Optimizer": {"type": opt_type, "learning_rate": RATES[opt_type]}}


@pytest.mark.parametrize("opt_type,freeze", CASES)
def pytest_optimizer_trajectory_and_checkpoints_match_jax(opt_type, freeze, tmp_path):
    cfg, graphs, training = arch(), _graphs(), _config(opt_type)
    host = jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    jtrainer = JaxTrainer(jax_create_model_config(cfg), training, freeze_conv=freeze)
    jstate = jtrainer.init_state(host)
    jbatch = jtrainer.put_batch(host)
    model = create_model_config(cfg, device="cpu", aggregation="segment")
    load_flax_variables(model, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    trainer = Trainer(model, training, freeze_conv=freeze)
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    state = trainer.init_state(batch)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("encoder_")}
    rng = jax.random.PRNGKey(0)
    losses, jlosses = [], []
    for _ in range(STEPS):
        jstate, jmet = jtrainer._train_step(jstate, jbatch, rng)
        state, met = trainer.train_step(state, batch)
        if not freeze:
            _carry_null_space(state.model, jstate.params)
        losses.append(float(met["loss"]))
        jlosses.append(float(jmet["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    _assert_same_variables(state.model, cfg,
                           _np({"params": jstate.params, "batch_stats": jstate.batch_stats}),
                           PARAM_RTOL, PARAM_ATOL)
    if freeze:
        assert all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen)
        assert losses[-1] < losses[0]

    # JAX -> port: the restored state writes back the JAX package's tree exactly
    jax_ckpt.save_model(jstate, "jax_run", path=str(tmp_path))
    fresh = Trainer(create_model_config(cfg, device="cpu", aggregation="segment"), training,
                    freeze_conv=freeze).init_state(batch)
    restored = restore_state(fresh, ckpt.load_state_dict("jax_run", path=str(tmp_path)))
    _assert_trees_equal(state_dict_of(restored), _jax_tree(jstate))
    # port -> JAX: JAX's save of what it restored is the port's file, byte for byte
    ckpt.save_model(state, "port_run", path=str(tmp_path))
    back = jax_ckpt.restore_into(jstate, jax_ckpt.load_state_dict("port_run", path=str(tmp_path)))
    assert int(back.step) == STEPS
    jax_ckpt.save_model(back, "again", path=str(tmp_path))
    assert ((tmp_path / "again" / "again.pk").read_bytes()
            == (tmp_path / "port_run" / "port_run.pk").read_bytes())


def _jax_tree(jstate):
    from flax import serialization

    return _np(serialization.to_state_dict({
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "opt_state": jstate.opt_state, "step": jstate.step}))


def _run_steps(cfg, config, batch, steps, seed=0, **trainer_kw):
    """``steps`` training steps of a fresh model: the losses, each step's
    gradients and the parameters after."""
    model = create_model_config(cfg, device="cpu", aggregation="segment", seed=seed)
    trainer = Trainer(model, config, **trainer_kw)
    state = trainer.init_state(batch)
    losses, grads = [], []
    for _ in range(steps):
        state, met = trainer.train_step(state, batch)
        losses.append(met["loss"].clone())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    return losses, grads, {n: p.detach().clone() for n, p in model.named_parameters()}


def _bit_equal(a, b):
    la, ga, pa = a
    lb, gb, pb = b
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for sa, sb in zip(ga, gb):
        assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)


@pytest.mark.parametrize("stack", ["PNA", "GAT"])
def pytest_conv_checkpointing_equals_the_plain_run(stack):
    cfg = arch() if stack == "PNA" else family_arch("GAT")
    batch = collate_graphs(_graphs(), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    config = _config("AdamW")
    plain = _run_steps(cfg, config, batch, 3)
    checked = _run_steps({**cfg, "conv_checkpointing": True}, config, batch, 3)
    _bit_equal(checked, plain)
    if stack == "GAT":  # the dropout draws are live: another generator state, another run
        model = create_model_config({**cfg, "conv_checkpointing": True}, device="cpu",
                                    aggregation="segment")
        assert model.dropout > 0 and model.conv_checkpointing
        trainer = Trainer(model, config)
        trainer.generator.manual_seed(1)
        state = trainer.init_state(batch)
        _, met = trainer.train_step(state, batch)
        assert not torch.equal(met["loss"], plain[0][0])


@pytest.mark.parametrize("stack", ["PNA", "SchNet"])
def pytest_compact_transfer_keeps_the_trajectory(monkeypatch, stack):
    from test_torch_train_stacks import _cfg as stack_cfg

    cfg = arch() if stack == "PNA" else stack_cfg("SchNet")
    batch = collate_graphs(_graphs(), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    config = _config("AdamW")
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("HYDRAGNN_COMPACT_TRANSFER", flag)
        runs.append(_run_steps(cfg, config, batch, 3))
    _bit_equal(*runs)
    model = create_model_config(cfg, device="cpu")
    assert Trainer(model, config).compact(batch) is batch
    monkeypatch.delenv("HYDRAGNN_COMPACT_TRANSFER")  # on by default
    compact = Trainer(model, config).compact(batch)
    assert compact.senders.dtype == compact.receivers.dtype == compact.node_graph.dtype \
        == torch.int16
    keeps_pos = stack == "SchNet"
    assert tuple(compact.pos.shape) == (tuple(batch.pos.shape) if keeps_pos else (1, 3))
    assert wire_bytes(compact) < wire_bytes(batch)
    back = decompact(compact)
    assert back.senders.dtype == torch.int32
    torch.testing.assert_close(back.senders, batch.senders)
    assert keeps_pos or bool(torch.isnan(back.pos).all())
    stacked = hydragnn_tpu_torch.graph.stack_batches([batch, batch])
    small = compact_for_transfer(stacked, keep_pos=False)
    assert tuple(small.pos.shape) == (2, 1, 3)
    assert tuple(decompact(small).pos.shape) == tuple(stacked.pos.shape)


# ---- one periodic CFG run, end to end ------------------------------------------

def _cfg_config(raw):
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "NiNb_pbc", "format": "CFG", "compositional_stratified_splitting": False,
            "rotational_invariance": False, "path": {"total": raw},
            "node_features": {"name": ["num_of_protons"], "dim": [1], "column_index": [0]},
            "graph_features": {"name": ["formation_energy"], "dim": [1], "column_index": [0]},
        },
        "NeuralNetwork": {
            "Architecture": {
                "model_type": "PNA", "radius": 3.2, "max_neighbours": 14,
                "periodic_boundary_conditions": True, "hidden_dim": 8, "num_conv_layers": 2,
                "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                           "num_headlayers": 1, "dim_headlayers": [8]}},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["formation_energy"],
                "output_index": [0], "type": ["graph"], "denormalize_output": False,
            },
            "Training": {"num_epoch": 2, "perc_train": 0.7, "loss_function_type": "mse",
                         "batch_size": 8, "continue": 0,
                         "Optimizer": {"type": "SGD", "learning_rate": 0.05}},
        },
        "Visualization": {"create_plots": False},
    }


def pytest_periodic_cfg_run_training_matches_jax(tmp_path, monkeypatch):
    """Both packages continue one JAX starting checkpoint (``startfrom``,
    as ``test_torch_run_training.py`` does) for 2 epochs of SGD on the
    periodic CFG data, then predict, each writing its dump."""
    from hydragnn_tpu.data import loaders as jax_loaders
    from hydragnn_tpu.train import driver as jax_driver
    from hydragnn_tpu.utils import config as jax_config

    from test_torch_run_training import _in_dir, _scalars

    raw = str(tmp_path / "raw")
    chip_smoke.write_cfg_data(raw, 20, cells=2, seed=0)
    config = _cfg_config(raw)
    start = tmp_path / "start"
    _in_dir(monkeypatch, start)
    jcfg = copy.deepcopy(config)
    jl = jax_loaders.dataset_loading_and_splitting(jcfg)
    jcfg = jax_config.update_config(jcfg, *jl)
    _, _, jstate = jax_driver._build_model_and_trainer(jcfg, jl[0], 0)
    jax_ckpt.save_model(jstate, "start", path=str(start / "logs"))
    config["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": "start"})
    dumps = {}
    for side, pkg in (("jax", hydragnn_tpu), ("port", hydragnn_tpu_torch)):
        where = tmp_path / side
        _in_dir(monkeypatch, where)
        shutil.copytree(start / "logs", where / "logs")
        monkeypatch.setenv("HYDRAGNN_DUMP_TESTDATA", "1")
        kw = {} if side == "jax" else {"device": "cpu"}
        state = pkg.run_training(copy.deepcopy(config), **kw)
        if side == "port":
            history, name = state.info["history"], state.info["log_name"]
        assert not (where / "testdata_rank0.npz").exists()  # only the prediction dumps
        pkg.run_prediction(copy.deepcopy(config), **kw)
        dumps[side] = dict(np.load(where / "testdata_rank0.npz"))
    jax_scalars = _scalars(tmp_path / "jax" / "logs" / name / "scalars.jsonl")
    for key, tag in (("train_loss", "train error"), ("val_loss", "validate error"),
                     ("test_loss", "test error")):
        np.testing.assert_allclose([h[key] for h in history], jax_scalars[tag],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert sorted(dumps["port"]) == sorted(dumps["jax"]) == ["pred_0", "true_0"]
    for key in dumps["jax"]:
        assert dumps["port"][key].shape == dumps["jax"][key].shape == (3, 1)
        np.testing.assert_allclose(dumps["port"][key], dumps["jax"][key], rtol=RTOL, atol=ATOL)
