"""Port parity of training GIN, SAGE, SchNet and EGNN: one step's loss and
gradients, and seeded AdamW trajectories, against the JAX package on the
same batch (numpy seeds) and the same weights (``models/bridge.py``).

Each stack (hidden 16, 2 conv layers, a graph head and a node head, 6
graphs with padded edges; SchNet with and without its equivariant update,
EGNN with ``equivariance``) in each of the JAX package's three modes:
``fused`` (K4-K7 and their backward rules, against ``HYDRAGNN_AGG=fused``
with the Pallas kernels in interpret mode), ``segment`` (a gather and K1,
against ``HYDRAGNN_PALLAS=1``) and ``dense`` (a batch that carries the
neighbour lists, against the JAX dense branch).

- One training step: the loss (BatchNorm in training mode), every
  parameter's gradient and the updated BatchNorm statistics, against
  ``jax.value_and_grad`` of the JAX step's own loss function.
- A 5-step AdamW trajectory (lr 1e-3) through ``Trainer`` against the JAX
  ``Trainer._train_step``: the per-step loss and task losses, the final
  parameters and statistics. As in ``test_torch_train.py``, the biases
  that an encoder BatchNorm cancels (GIN's ``mlp_1``, SAGE's ``lin_l``)
  have a gradient of rounding noise, which AdamW turns into updates of up
  to ``lr`` that differ between the frameworks: their JAX values are
  carried into the port after every step.
- Dense bf16 trajectories (20 steps) of the four stacks, held to ``C``
  (``test_torch_bf16.TRAJECTORY_FACTOR``) times JAX's own bf16 error
  against an exact float64 trajectory of the port (the rule of
  ``test_torch_bf16.py``).

Tolerance: rtol 1e-4 / atol 1e-5 (of the tensor's largest magnitude where
that is above 1) on the loss, the task losses, the gradients and the
statistics of one step, and on every step's loss. GIN's scalar ``eps``
gradient sums over every node row and is held by the same relative bound.
The parameters and statistics after 5 steps are held as
``test_torch_train.py`` holds them after its trajectories, rtol 1e-3 /
atol 1e-5: AdamW's first steps move a parameter by nearly ``lr *
sign(g)`` wherever ``|g|`` is near its eps (1e-8), as some entries of
GIN's ``mlp_1`` weight are (that gradient's largest entry is 6e-5), so
rounding-level differences in such a gradient move the parameter, and
the BatchNorm statistics after it, by up to 2e-5 of its scale (GIN
``dense``: a running mean off by 1.8e-4 of itself after 5 steps). An
element past that tolerance is held to the float64 rule
(``test_torch_train.hold_final_state``): its distance to the JAX
package's float64 trajectory at most 4 times JAX's own float32 distance
over the tensor. Each float64 step is taken on the side of the ReLU kinks
that the float32 run took within float32's reach (``_torch_jax64``, by
the rule of ``chip_smoke.kink_flips``; the reach read from the other
framework's float32 forward): GIN ``dense`` step 3 has one, a node-head
input of -6.0e-7 in float64 that the port's float32 forward puts at
+1.3e-7 and JAX's at the float64 side. The node's gradient then differs
(``encoder_conv_0.mlp_1.weight``'s row 7, whose gradient is 7e-8 against
a largest entry of 5e-5, by 69%), and seven tensors part from JAX's after
5 steps; in ``mlp_1.weight`` the port lies 5.4e-6 from the float64
trajectory on its side of the kink, JAX 1.2e-5 from the one on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.ops import dense_agg as jdense
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.ops import dense_agg as dense
from hydragnn_tpu_torch.ops import launch_counts
from hydragnn_tpu_torch.train import Trainer

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
import _torch_jax64 as jax64
import chip_smoke
from test_torch_bf16 import TRAJECTORY_FACTOR, hold, trajectories
from test_torch_gin_sage import arch
from test_torch_pna import JAX_ENV
from test_torch_train import ADAMW, HEADS, PADS, _graphs, _np, hold_final_state

RTOL, ATOL = 1e-4, 1e-5
STEPS = 5
MODES = ("fused", "segment", "dense")
# name -> (model_type, equivariance)
STACKS = {
    "GIN": ("GIN", False),
    "SAGE": ("SAGE", False),
    "SchNet": ("SchNet", False),
    "SchNet-equivariant": ("SchNet", True),
    "EGNN-equivariant": ("EGNN", True),
}
# the encoder conv layer whose bias the encoder BatchNorm cancels
CANCELLED = {"GIN": "mlp_1", "SAGE": "lin_l"}


def _cfg(stack):
    model_type, equivariance = STACKS[stack]
    return arch(model_type, hidden=16, layers=2, equivariance=equivariance)


def _cancelled(model_type, name):
    parts = name.split(".")
    return (model_type in CANCELLED and len(parts) == 3
            and parts[0].startswith("encoder_conv_")
            and parts[1] == CANCELLED[model_type] and parts[2] == "bias")


def _carry_cancelled(model, model_type, jparams):
    """JAX's values of the cancelled biases into ``model``; returns them."""
    values = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if _cancelled(model_type, name):
                conv, layer, _ = name.split(".")
                values[name] = torch.from_numpy(np.array(jparams[conv][layer]["bias"]))
                p.copy_(values[name])
    return values


def _batches(graphs, mode):
    """The host batch on both sides, with the lists in ``dense`` mode."""
    host = jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    host = jax.tree_util.tree_map(jnp.asarray, host)
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    if mode == "dense":
        host = jdense.attach_neighbor_lists(host)
        batch = dense.attach_neighbor_lists(batch)
    return host, batch


def _set_env(monkeypatch, mode):
    monkeypatch.delenv("HYDRAGNN_AGG", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)
    if mode != "dense":
        env, value = JAX_ENV[mode]
        monkeypatch.setenv(env, value)


def _port_model(cfg, mode, variables):
    model = create_model_config(cfg, device="cpu",
                                aggregation="fused" if mode == "dense" else mode)
    return load_flax_variables(model, variables)


def _port_model64(cfg, mode, variables):
    """``variables`` in a float64 copy of the port's model: no rounding."""
    model = create_model_config(cfg, device="cpu",
                                aggregation="fused" if mode == "dense" else mode)
    return load_flax_variables(model.double(), variables)


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stack", list(STACKS))
def pytest_train_step_gradients_match_jax(monkeypatch, stack, mode):
    cfg = _cfg(stack)
    host, batch = _batches(_graphs(seed=1), mode)
    jtrainer = JaxTrainer(jax_create_model_config(cfg), ADAMW)
    # the variables are the same in every mode; init traces the XLA path,
    # which compiles faster than the Pallas interpreter
    _set_env(monkeypatch, "dense")
    jstate = jtrainer.init_state(host)
    _set_env(monkeypatch, mode)
    jmodel = jtrainer.model
    variables = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})

    def loss_fn(params):
        if jstate.batch_stats:
            outputs, mut = jmodel.apply(
                {"params": params, "batch_stats": jstate.batch_stats}, host, train=True,
                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        else:
            outputs = jmodel.apply({"params": params}, host, train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)})
            mut = {"batch_stats": {}}
        tot, tasks = jmodel.loss(outputs, host)
        return tot, (jnp.stack(tasks), mut["batch_stats"])

    (want_loss, (want_tasks, want_stats)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)

    model = _port_model(cfg, mode, variables).train()
    before = launch_counts()
    loss, tasks = model.loss(model(batch), batch)
    loss.backward()
    assert launch_counts() == before  # the CPU runs the plain versions
    _close(float(loss), want_loss, "loss")
    _close(torch.stack(tasks).detach().numpy(), want_tasks, "tasks")

    ref = create_model_config(cfg, device="cpu")
    load_flax_variables(ref, _np({"params": want_grads, "batch_stats": want_stats}))
    grads = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        _close(p.grad.numpy(), grads[name].detach().numpy(), name)
    stats = dict(ref.named_buffers())
    for name, b in model.named_buffers():
        if name in stats:
            _close(b.numpy(), stats[name].numpy(), name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stack", list(STACKS))
def pytest_train_trajectory_matches_jax(monkeypatch, stack, mode):
    cfg = _cfg(stack)
    model_type = cfg["model_type"]
    host, batch = _batches(_graphs(seed=2), mode)
    jtrainer = JaxTrainer(jax_create_model_config(cfg), ADAMW)
    _set_env(monkeypatch, "dense")
    jstate = jtrainer.init_state(host)
    _set_env(monkeypatch, mode)  # the step is traced at its first call
    jbatch = jtrainer.put_batch(host)
    variables = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
    model = _port_model(cfg, mode, variables)
    trainer = Trainer(model, ADAMW)
    state = trainer.init_state(batch)
    rng = jax.random.PRNGKey(0)
    first = _np(jstate)  # the step donates its state
    losses, jlosses, carried, starts, jsteps = [], [], [], [], []
    for _ in range(STEPS):
        starts.append({k: v.clone() for k, v in model.state_dict().items()})
        jsteps.append(_np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
        jstate, jmet = jtrainer._train_step(jstate, jbatch, rng)
        state, met = trainer.train_step(state, batch)
        carried.append(_carry_cancelled(model, model_type, _np(jstate.params)))
        losses.append(float(met["loss"]))
        jlosses.append(float(jmet["loss"]))
        _close(met["tasks"].numpy(), np.array(jmet["tasks"]), "tasks")
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

    def relu_inputs(probe):
        z = chip_smoke.KinkReLUs()
        z.install(probe.train())(batch)
        return z.inputs

    def carry(k, params):
        params = jax.tree_util.tree_map(np.asarray, params)
        for name, value in carried[k].items():
            conv, layer, _ = name.split(".")
            params[conv][layer]["bias"] = value.numpy()
        return params

    def exact():
        """JAX's float64 trajectories from the same weights and graph, with
        the same cancelled biases carried in after each step, on the port's
        and on JAX's side of the ReLU kinks (``_torch_jax64``), in the
        port's names."""
        cards = []
        for start in starts:
            probe = _port_model(cfg, mode, variables)
            probe.load_state_dict(start)
            cards.append(relu_inputs(probe))
        runs = jax64.trajectories(
            jtrainer, first, host, rng, cards, jsteps,
            lambda v: relu_inputs(_port_model(cfg, mode, v)), carry)
        assert sum(runs[2]["port"]) <= chip_smoke.KINK_FLIPS_MAX, runs[2]
        return tuple(_port_model64(cfg, mode, v).state_dict() for v in runs[:2])

    ref = _port_model(cfg, mode, _np({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats}))
    hold_final_state(model.state_dict(), ref.state_dict(), exact)


@pytest.mark.parametrize("stack", ["GIN", "SAGE", "SchNet-equivariant", "EGNN-equivariant"])
def pytest_dense_bf16_trajectory_matches_jax(stack):
    cfg = _cfg(stack)
    exact, jrun, port = trajectories("dense", seed=0, cfg=cfg)
    rows, bad = hold(exact, jrun, port, TRAJECTORY_FACTOR,
                     cancelled=lambda name: _cancelled(cfg["model_type"], name))
    assert not bad, (rows, bad)
    losses = port["loss"]["loss"]
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
    assert rows["loss"][1] > 0 and rows["update"][1] > 0  # bf16 differs from exact


def pytest_dense_branch_loss_matches_segment():
    """A batch with neighbour lists (the dense branch) gives the same loss
    as the same batch without them (the segment branch). That the dense
    branch launches no kernel but the pool's K1 is held on the card, where
    launches are counted (``chip_smoke.py``'s per-step launch counts)."""
    cfg = _cfg("EGNN-equivariant")
    _, batch = _batches(_graphs(seed=3), "dense")
    losses = []
    for b in (batch, dataclasses.replace(batch, extras={})):
        model = create_model_config(cfg, device="cpu", aggregation="segment", seed=4).train()
        losses.append(float(model.loss(model(b), b)[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=RTOL)
