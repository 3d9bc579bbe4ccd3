"""Port parity of training: the loss, the optimizer, ``train_step`` and
``eval_step`` of ``hydragnn_tpu_torch.train`` against the JAX package's,
on the same batch (numpy seeds) and the same weights (``models/bridge.py``).

- ``HydraBase.loss``, with and without the NLL heads' log-variance
  channel, and ``loss_function_type``: values and parameter gradients.
- One Adam or AdamW step from a non-zero optax state carried across
  (``load_optax_adam_state``): on synthetic gradients spanning 1e-9 to 10
  (where a wrong eps placement or a wrong bias correction shows in the
  update itself), and on the model after three JAX steps.
- A seeded trajectory of 20 ``train_step``s of multi-head PNA (hidden 16,
  2 layers, 6 graphs) in ``fused`` mode against ``HYDRAGNN_AGG=fused`` and
  in ``segment`` mode against ``HYDRAGNN_PALLAS=1``, through the JAX
  ``Trainer._train_step`` (Pallas in interpret mode): the per-step loss,
  the final parameters and the BatchNorm statistics.
- ``eval_step``, the batch's targets, the precision the trainer resolves,
  and what it refuses (unported optimizers, ``freeze_conv``, meshes).

The biases of an encoder conv's last two layers (``post_nn``, ``lin``)
feed a BatchNorm in training mode, which subtracts the batch mean: the
loss does not depend on them (shown here by perturbing them), so their
gradient is rounding noise (~1e-9, below Adam's eps) in both frameworks,
and Adam turns that noise into updates of up to ``lr`` that differ
between the two. The trajectory carries the JAX values of these biases
into the port after every step, so that the BatchNorm running means, which
do see them, stay comparable; the one-step test leaves them out of the
update comparison (the synthetic optimizer test holds gradients that small
exactly).

Tolerances: rtol 1e-4 / atol 1e-5 per op and per step's loss; after 20
steps rtol 1e-3 / atol 1e-5 on the parameters and statistics. An
optimizer update is compared as the difference it makes, rtol 1e-4 with
an atol of 2e-7 there (the two AdamW orders of operations, decay before
the update in PyTorch and ``wd * p`` added to it in optax, round ``p``
differently by up to an ulp of the parameter, ~6e-8 at |p| ~ 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import pad_sizes_for
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model_params
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.bridge import load_optax_adam_state
from hydragnn_tpu_torch.models.common import TorchLinear
from hydragnn_tpu_torch.train import (
    Trainer,
    get_learning_rate,
    select_optimizer,
    set_learning_rate,
)

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_pna import JAX_ENV, arch, samples

RTOL, ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5  # after 20 steps
UPDATE_RTOL, UPDATE_ATOL = 1e-4, 2e-7
HEADS = (("graph", "node"), (1, 2))
PADS = pad_sizes_for(10, 40, 6)
ADAMW = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
NULL_SPACE = ("post_nn", "lin")  # encoder conv layers whose biases BatchNorm cancels


def _null_space(name):
    parts = name.split(".")
    return (parts[0].startswith("encoder_conv_") and len(parts) == 3
            and parts[1] in NULL_SPACE and parts[2] == "bias")


def _carry_null_space(model, jparams):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if _null_space(name):
                conv, layer, _ = name.split(".")
                p.copy_(torch.from_numpy(np.array(jparams[conv][layer]["bias"])))


def _graphs(seed=0):
    graphs = samples(seed=seed)
    rng = np.random.default_rng(seed + 7)
    for g in graphs:
        n = g.x.shape[0]
        g.targets = [
            np.array([g.x.mean() * 2.0 - 0.5], np.float32),
            np.concatenate([g.x, g.x ** 2], 1) + 0.1 * rng.standard_normal((n, 2)).astype(np.float32),
        ]
    return graphs


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _port_variables(model):
    """The port's parameters and buffers by name, as numpy."""
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _assert_same_variables(model, cfg, jax_variables, rtol, atol):
    """``model``'s parameters and statistics against the JAX variables
    (carried into a copy of the port's layout by the bridge)."""
    ref = create_model_config(cfg, device="cpu", aggregation=model.aggregation)
    load_flax_variables(ref, jax_variables)
    got, want = _port_variables(model), _port_variables(ref)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


PARTING_FACTOR = 4.0  # the float64 rule's factor (test_torch_dimenet.FACTOR)


def hold_final_state(got, want, exact):
    """The state after a trajectory: ``got`` (the port's) and ``want``
    (JAX's) map each name to a tensor; ``exact()`` gives the JAX package's
    float64 trajectories' states from the same weights and graphs, on the
    port's side of the ReLU kinks and on JAX's (``_torch_jax64``). Every
    element stays within ``PARAM_RTOL``/``PARAM_ATOL`` of JAX's, except
    where both float32 runs are within float32's reach of the float64 one:
    an element past that tolerance is held to the float64 rule, its
    distance to the float64 state on the port's side at most
    ``PARTING_FACTOR`` times JAX's largest distance, over that tensor, to
    the float64 state on its own side. ``exact`` runs only when an element
    parts. Returns ``{name: (parting elements, worst, level)}``."""
    parted, ref = {}, None
    for name, t in got.items():
        g = t.detach().double().numpy()
        w = want[name].detach().double().numpy()
        parting = ~np.isclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        if not parting.any():
            continue
        ref = exact() if ref is None else ref
        port_side, jax_side = (r[name].detach().double().numpy() for r in ref)
        level = float(np.abs(w - jax_side).max())
        worst = float(np.abs(g - port_side)[parting].max())
        parted[name] = (int(parting.sum()), worst, level)
        assert worst <= PARTING_FACTOR * level, (name, parted[name])
    return parted


def _pair(monkeypatch, mode, cfg, graphs, training_config):
    """A JAX trainer and state and a port trainer and state with the same
    weights, and the batch on both sides."""
    env, value = JAX_ENV[mode]
    monkeypatch.setenv(env, value)
    host = jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    jtrainer = JaxTrainer(jax_create_model_config(cfg), training_config)
    jstate = jtrainer.init_state(host)
    jbatch = jtrainer.put_batch(host)

    model = create_model_config(cfg, device="cpu", aggregation=mode)
    load_flax_variables(model, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    trainer = Trainer(model, training_config)
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    return jtrainer, jstate, jbatch, trainer, trainer.init_state(batch), batch


@pytest.mark.parametrize("mode", ["fused", "segment"])
def pytest_train_trajectory_matches_jax(monkeypatch, mode):
    cfg = arch()
    jtrainer, jstate, jbatch, trainer, state, batch = _pair(
        monkeypatch, mode, cfg, _graphs(), ADAMW
    )
    rng = jax.random.PRNGKey(0)
    jlosses, losses = [], []
    for _ in range(20):
        jstate, jmet = jtrainer._train_step(jstate, jbatch, rng)
        jlosses.append(np.array(jmet["loss"]))
        state, met = trainer.train_step(state, batch)
        _carry_null_space(state.model, jstate.params)
        losses.append(float(met["loss"]))
        np.testing.assert_allclose(met["tasks"].numpy(), np.array(jmet["tasks"]), rtol=RTOL, atol=ATOL)
        assert int(met["num_graphs"]) == int(jmet["num_graphs"]) == 6
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert losses[-1] < losses[0] and state.step == 20
    _assert_same_variables(
        state.model, cfg, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}),
        PARAM_RTOL, PARAM_ATOL,
    )


def pytest_one_step_from_a_carried_optax_state_matches_jax(monkeypatch):
    """Three JAX steps give a non-zero state (mu, nu, count 3); it is
    carried across with the weights and statistics, then both take one
    step. The updates (new minus old parameters) must agree."""
    cfg = arch()
    jtrainer, jstate, jbatch, trainer, state, batch = _pair(
        monkeypatch, "segment", cfg, _graphs(seed=2), ADAMW
    )
    rng = jax.random.PRNGKey(0)
    for _ in range(3):
        jstate, _ = jtrainer._train_step(jstate, jbatch, rng)
    before = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
    load_flax_variables(state.model, before)
    load_optax_adam_state(state.optimizer, _np(jstate.opt_state))
    assert all(float(s["step"]) == 3.0 for s in state.optimizer.state.values())
    old = _port_variables(state.model)
    jstate, jmet = jtrainer._train_step(jstate, jbatch, rng)
    state, met = trainer.train_step(state, batch)
    np.testing.assert_allclose(float(met["loss"]), np.array(jmet["loss"]), rtol=RTOL)

    ref = create_model_config(cfg, device="cpu", aggregation="segment")
    load_flax_variables(ref, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    new, want = _port_variables(state.model), _port_variables(ref)
    for name in old:
        if _null_space(name):
            continue
        np.testing.assert_allclose(new[name] - old[name], want[name] - old[name],
                                   rtol=UPDATE_RTOL, atol=UPDATE_ATOL, err_msg=name)


def pytest_the_loss_ignores_the_biases_batchnorm_cancels():
    """Why the trajectory carries those biases: in training mode the loss
    does not change when they move, and their gradient is rounding noise."""
    batch = collate_graphs(_graphs(), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    model = create_model_config(arch(), device="cpu").train()
    loss = model.loss(model(batch), batch)[0]
    loss.backward()
    null = [p for n, p in model.named_parameters() if _null_space(n)]
    live = [p for n, p in model.named_parameters() if not _null_space(n)]
    assert len(null) == 2 * model.num_conv_layers
    assert max(float(p.grad.abs().max()) for p in null) < 1e-6 * max(
        float(p.grad.abs().max()) for p in live)
    with torch.no_grad():
        for p in null:
            p.add_(0.1)
        moved = model.loss(model(batch), batch)[0]
    np.testing.assert_allclose(float(moved), float(loss), rtol=1e-5)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = TorchLinear(3, 4)


@pytest.mark.parametrize("opt_type", ["AdamW", "Adam"])
def pytest_optimizer_step_matches_optax(opt_type):
    """The optax numerics on gradients from 1e-9 (below eps: a square root
    taken with eps inside it would be 1e4 times too large) to 10, from a
    state three updates old (the bias corrections of step 4)."""
    rng = np.random.default_rng(60)
    params = {"lin": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                      "bias": rng.standard_normal(4).astype(np.float32)}}
    scales = {"kernel": 10.0 ** rng.integers(-9, 2, (3, 4)), "bias": 10.0 ** np.arange(-9, -5)}

    def grads():
        return {"lin": {k: (rng.standard_normal(v.shape) * scales[k]).astype(np.float32)
                        for k, v in params["lin"].items()}}

    config = {"Optimizer": {"type": opt_type, "learning_rate": 1e-2}}
    tx = jax_select_optimizer(config)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for _ in range(3):
        updates, opt_state = tx.update(grads(), opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)

    model = _Tiny()
    with torch.no_grad():
        model.lin.weight.copy_(torch.from_numpy(np.array(jparams["lin"]["kernel"]).T))
        model.lin.bias.copy_(torch.from_numpy(np.array(jparams["lin"]["bias"])))
    optimizer = select_optimizer(config, model)
    load_optax_adam_state(optimizer, _np(opt_state))
    assert get_learning_rate(optimizer) == pytest.approx(1e-2)

    g = grads()
    updates, _ = tx.update(g, opt_state, jparams)
    old_w, old_b = model.lin.weight.detach().clone(), model.lin.bias.detach().clone()
    model.lin.weight.grad = torch.from_numpy(g["lin"]["kernel"].T.copy())
    model.lin.bias.grad = torch.from_numpy(g["lin"]["bias"])
    optimizer.step()
    np.testing.assert_allclose((model.lin.weight.detach() - old_w).numpy(),
                               np.array(updates["lin"]["kernel"]).T,
                               rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    np.testing.assert_allclose((model.lin.bias.detach() - old_b).numpy(),
                               np.array(updates["lin"]["bias"]),
                               rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    set_learning_rate(optimizer, 5e-4)
    # the rate is a float32 tensor on every device, as optax keeps it
    assert get_learning_rate(optimizer) == float(np.float32(5e-4))


@pytest.mark.parametrize("loss_type,nll", [("mse", False), ("smooth_l1", False), ("mse", True)])
def pytest_hydra_loss_matches_jax(loss_type, nll):
    cfg = {**arch(), "loss_function_type": loss_type, "ilossweights_nll": int(nll),
           "task_weights": [2.0, 1.0]}
    graphs = _graphs(seed=4)
    jbatch = jax.tree_util.tree_map(
        jnp.asarray, jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    )
    jmodel = jax_create_model_config(cfg)
    variables = _np(init_model_params(jmodel, jbatch))

    def jloss(params):
        outputs = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jbatch, train=False)
        tot, tasks = jmodel.loss(outputs, jbatch)
        return tot, tasks

    (want, want_tasks), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])

    model = create_model_config(cfg, device="cpu")
    load_flax_variables(model, variables)
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    outputs = model(batch)
    assert outputs[0].shape[-1] == 1 + nll and outputs[1].shape[-1] == 2 + nll
    tot, tasks = model.loss(outputs, batch)
    tot.backward()
    np.testing.assert_allclose(float(tot), np.array(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose([float(t) for t in tasks], np.array(want_tasks), rtol=RTOL, atol=ATOL)
    ref = create_model_config(cfg, device="cpu")
    load_flax_variables(ref, {"params": _np(want_grads), "batch_stats": variables["batch_stats"]})
    want_by_name = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        w = want_by_name[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL, atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def pytest_eval_step_matches_jax(monkeypatch):
    jtrainer, jstate, jbatch, trainer, state, batch = _pair(
        monkeypatch, "fused", arch(), _graphs(seed=5), ADAMW
    )
    jstate, _ = jtrainer._train_step(jstate, jbatch, jax.random.PRNGKey(0))
    state, _ = trainer.train_step(state, batch)
    want = jtrainer._eval_step(jstate.params, jstate.batch_stats, jbatch)
    got = trainer.eval_step(state, batch)
    assert not state.model.training
    np.testing.assert_allclose(float(got["loss"]), np.array(want["loss"]), rtol=RTOL)
    np.testing.assert_allclose(got["tasks"].numpy(), np.array(want["tasks"]), rtol=RTOL, atol=ATOL)
    gmask, nmask = batch.graph_mask.numpy(), batch.node_mask.numpy()
    for ihead, mask in enumerate((gmask, nmask)):
        np.testing.assert_allclose(got["outputs"][ihead].numpy()[mask],
                                   np.array(want["outputs"][ihead])[mask], rtol=RTOL, atol=ATOL)


def pytest_batch_targets_match_jax_and_travel_with_the_batch():
    graphs = _graphs(seed=6)
    want = jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1]).targets
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    assert [t.shape for t in batch.targets] == [(PADS[2], 1), (PADS[0], 2)]
    for got, ref in zip(batch.targets, want):
        np.testing.assert_array_equal(got.numpy(), ref)
    moved = batch.to("meta")  # through the one staged buffer
    assert [(t.device.type, t.shape, t.dtype) for t in moved.targets] == [
        ("meta", t.shape, t.dtype) for t in batch.targets
    ]
    assert collate_graphs(graphs, *PADS).targets == ()  # serving batches carry none


def pytest_trainer_refuses_bf16_and_what_is_not_ported(monkeypatch):
    """bf16 is ported: the trainer keeps the precision the JAX package's
    rule resolves (env, then explicit, then the width policy). What is not
    ported still raises."""
    monkeypatch.delenv("HYDRAGNN_MIXED_PRECISION", raising=False)
    small = create_model_config(arch(), device="cpu")
    wide = create_model_config(arch(hidden=128), device="cpu")
    assert Trainer(small, {"mixed_precision": True}).precision == {"mixed": True, "source": "explicit"}
    assert Trainer(wide, {"mixed_precision": "auto"}).precision == {"mixed": True, "source": "policy"}
    assert Trainer(small, {"mixed_precision": "auto"}).precision == {"mixed": False, "source": "policy"}
    assert Trainer(wide, {}).precision == {"mixed": False, "source": "default"}
    monkeypatch.setenv("HYDRAGNN_MIXED_PRECISION", "1")
    assert Trainer(small, {}).precision == {"mixed": True, "source": "env"}
    monkeypatch.setenv("HYDRAGNN_MIXED_PRECISION", "0")
    assert Trainer(wide, {"mixed_precision": "auto"}).precision["source"] == "env"
    monkeypatch.delenv("HYDRAGNN_MIXED_PRECISION")

    batch = collate_graphs(_graphs(), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    # every optimizer type and freeze_conv are ported (tests/test_torch_optimizers.py)
    for config in ({"Optimizer": {"type": "SGD"}}, {"Optimizer": {"type": "LAMB"}}):
        assert type(Trainer(small, config).init_state(batch).optimizer).__name__ == "OptaxOptimizer"
    with pytest.raises(ValueError, match="not supported"):
        Trainer(small, {"Optimizer": {"type": "Nadam"}}).init_state(batch)
    frozen = Trainer(small, {}, freeze_conv=True).init_state(batch).optimizer
    assert [g["frozen"] for g in frozen.param_groups] == [False, True]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(small, {}, mesh=object())
    with pytest.raises(ValueError, match="targets"):
        Trainer(small, {}).init_state(collate_graphs(_graphs(), *PADS))


def pytest_guarded_step_reports_finite(monkeypatch):
    monkeypatch.delenv("HYDRAGNN_DIVERGENCE_GUARD", raising=False)
    batch = collate_graphs(_graphs(), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    model = create_model_config(arch(), device="cpu", aggregation="segment")
    trainer = Trainer(model, {**ADAMW, "divergence_guard": True})
    state, met = trainer.train_step(trainer.init_state(batch), batch)
    assert bool(met["finite"])
    with torch.no_grad():
        next(model.parameters()).fill_(float("nan"))
    _, met = trainer.train_step(state, batch)
    assert not bool(met["finite"])
    state = Trainer(model, ADAMW).init_state(batch)
    assert "finite" not in Trainer(model, ADAMW).train_step(state, batch)[1]
