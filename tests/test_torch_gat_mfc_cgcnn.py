"""Port parity of GAT, MFC and CGCNN against the JAX package, on the same
batch (numpy seeds) and the same weights (``models/bridge.py``).

Each stack (hidden 8, 2 conv layers, a graph head and a node head, 6
graphs with padded edges; CGCNN at ``input_dim`` 4, its width; MFC with
``max_neighbours`` 4, below the graphs' largest in-degree, so the top bank
is taken above it) in its segment branch (a gather and K1; the JAX
package's XLA ``segment_sum``, which is what ``HYDRAGNN_AGG=fused`` runs
for these stacks) and its dense branch (a batch with the neighbour
lists):

- the forward in eval mode (BatchNorm running statistics non-trivial);
  GAT also with a ``conv`` node head (its concat/mean schedule);
- one training step's loss, task losses, gradients and BatchNorm
  statistics against ``jax.value_and_grad`` of the JAX step's loss, then
  a 5-step AdamW trajectory (lr 1e-3) through ``Trainer`` against the JAX
  ``Trainer._train_step``: per-step losses, final parameters and
  statistics. GAT's attention dropout is set to 0 on both sides (a
  ``torch.Generator`` cannot draw JAX's masks). GAT's encoder conv
  ``bias`` is cancelled by the encoder BatchNorm, and so are ``b_l`` and
  ``b_r`` in every column ``(h, c)`` where ``x_l[j] + x_r[i]`` keeps one
  sign on every edge (there they shift all of a head's logits alike, which
  the softmax ignores, and feed the BatchNorm a constant): such entries
  take a gradient of rounding noise, which AdamW turns into updates of up
  to ``lr`` of either sign, and these move the BatchNorm's running mean.
  The port's float64 trajectory (the exact one) names these entries: its
  updates stay below ``CANCELLED_SHARE`` of ``lr`` there. They take JAX's
  value after each step, and each step's update of theirs is held under
  the float64 rule of ``test_torch_bf16.py`` (``|port - exact| <= C *
  |jax - exact| + FLOOR``, relative to the largest exact update, ``C`` =
  ``TRAJECTORY_FACTOR``; GAT needs 0.89 and 1.02). Every other entry of
  these biases keeps the port's own updates and is held against JAX with
  the other parameters; their step-1 gradients are held above;
- a 20-step dense bf16 trajectory under ``test_torch_bf16.py``'s rule
  (``C`` = ``TRAJECTORY_FACTOR`` times JAX's own bf16 error against an
  exact float64 trajectory of the port), and the dtype of every module's
  input and output in a bf16 forward, against JAX's;
- ``segment_softmax`` and ``segment_softmax_unnorm`` (values and
  ``jax.vjp``), MFC's clamp above ``mfc_degree_bound``, CGCNN's refusal of
  a ``conv`` node head, ``fused`` and ``segment`` bitwise equal, and
  attention dropout (train mode draws from the generator; eval does not).

Tolerances as ``test_torch_train_stacks.py``: rtol 1e-4 / atol 1e-5 (of
the tensor's largest magnitude where that is above 1) on forwards, one
step and every step's loss; rtol 1e-3 / atol 1e-5 on the parameters and
statistics after 5 steps, an element past that held to the float64 rule
(``test_torch_train.hold_final_state``: the distance to the JAX
package's float64 trajectory, ``_torch_jax64``, at most 4 times JAX's own
float32 distance over the tensor). GAT ``segment`` has one such element,
in ``encoder_conv_0.b_l``, 1.27e-5 from JAX's after 5 steps: the port
lies 7.8e-6 from the float64 trajectory, JAX 4.9e-6 at most.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import segment as jseg
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.ops import dense_agg as jdense
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
import _torch_jax64 as jax64
import chip_smoke
from hydragnn_tpu_torch.graph import collate_graphs, segment_softmax, segment_softmax_unnorm
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.gat import attention_dropout
from hydragnn_tpu_torch.ops import dense_agg as dense
from hydragnn_tpu_torch.ops import launch_counts
from hydragnn_tpu_torch.train import Trainer

from test_torch_bf16 import TRAJECTORY_FACTOR, _bf16_tree, _jax_bf16_batch
from test_torch_bf16 import _port_dtypes, _record, _recorder, hold
from test_torch_gin_sage import jax_variables
from test_torch_pna import arch as pna_arch
from test_torch_train import ADAMW, HEADS, PADS, _np, hold_final_state
from test_torch_train import _graphs as train_graphs

RTOL, ATOL = 1e-4, 1e-5
FLOOR = 1e-5
CANCELLED_SHARE = 1e-3  # an exact update below this share of lr: a cancelled entry
STEPS = 5
BF16_STEPS = 20
STACKS = ("GAT", "MFC", "CGCNN")
BRANCHES = ("segment", "dense")
CGCNN_INPUT_DIM = 4


def arch(model_type, node_type="mlp", hidden=8):
    cfg = pna_arch(node_type=node_type, hidden=hidden, layers=2)
    cfg.update(model_type=model_type, max_neighbours=4)
    if model_type == "CGCNN":
        cfg["input_dim"] = CGCNN_INPUT_DIM
    return cfg


def graphs(seed, input_dim=1):
    """``test_torch_train``'s graphs (targets for both heads), with
    ``input_dim`` feature columns, centred on 0: with features of one sign
    and zero biases, a GAT logit ``leaky_relu(x_l[j] + x_r[i])`` can keep
    one slope on every edge, where its biases shift every logit of a
    receiver alike and take a gradient of rounding noise only, which
    AdamW's first steps turn into updates of either sign."""
    out = train_graphs(seed)
    rng = np.random.default_rng(seed + 50)
    for g in out:
        if input_dim > 1:
            extra = rng.random((g.x.shape[0], input_dim - 1)).astype(np.float32)
            g.x = np.concatenate([g.x, extra], axis=1)
        g.x = g.x - np.float32(0.5)
    return out


def batches(graph_list, branch, with_targets=True):
    """The host batch on both sides, with the lists in the dense branch."""
    heads = dict(head_types=HEADS[0], head_dims=HEADS[1]) if with_targets else {}
    host = jax.tree_util.tree_map(jnp.asarray, jax_collate(graph_list, *PADS, **heads))
    batch = collate_graphs(graph_list, *PADS, **heads)
    if branch == "dense":
        host = jdense.attach_neighbor_lists(host)
        batch = dense.attach_neighbor_lists(batch)
    return host, batch


def port_model(cfg, variables, aggregation="segment"):
    model = create_model_config(cfg, device="cpu", aggregation=aggregation)
    return load_flax_variables(model, variables).set_dropout(0.0)


def close(got, want, name, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=name)


def cancelled(model_type, name):
    """GAT's encoder conv biases, whose gradient is rounding noise in the
    entries that the encoder BatchNorm (``bias``; ``b_l`` and ``b_r`` where
    a logit column keeps one slope) cancels."""
    parts = name.split(".")
    return (model_type == "GAT" and len(parts) == 2 and parts[0].startswith("encoder_conv_")
            and parts[1] in ("bias", "b_l", "b_r"))


FORWARD_CASES = [(m, b, "mlp") for m in STACKS for b in BRANCHES] + [("GAT", "segment", "conv")]


@pytest.mark.parametrize("model_type,branch,node_type", FORWARD_CASES)
def pytest_forward_matches_jax(model_type, branch, node_type):
    cfg = arch(model_type, node_type)
    host, batch = batches(graphs(0, cfg["input_dim"]), branch, with_targets=False)
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables(jmodel, host)
    ref = [np.asarray(o) for o in jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, host)]
    model = port_model(cfg, variables)
    before = launch_counts()
    with torch.inference_mode():
        got = [o.numpy() for o in model(batch)]
    assert launch_counts() == before  # the CPU runs the plain versions
    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    for kind, g, r in zip(cfg["output_type"], got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g[masks[kind]], r[masks[kind]], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("model_type", STACKS)
def pytest_train_step_and_trajectory_match_jax(model_type, branch):
    """One step's gradients against ``jax.grad``, then 5 AdamW steps."""
    cfg = arch(model_type)
    host, batch = batches(graphs(1, cfg["input_dim"]), branch)
    jtrainer = JaxTrainer(jax_create_model_config(cfg).clone(dropout=0.0), ADAMW)
    jstate = jtrainer.init_state(host)
    jmodel = jtrainer.model
    variables = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})

    def loss_fn(params):
        outputs, mut = jmodel.apply(
            {"params": params, "batch_stats": jstate.batch_stats}, host, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        tot, tasks = jmodel.loss(outputs, host)
        return tot, (jnp.stack(tasks), mut["batch_stats"])

    (want_loss, (want_tasks, want_stats)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    model = port_model(cfg, variables).train()
    loss, tasks = model.loss(model(batch), batch)
    loss.backward()
    close(float(loss), want_loss, "loss")
    close(torch.stack(tasks).detach().numpy(), want_tasks, "tasks")
    ref = load_flax_variables(create_model_config(cfg, device="cpu"),
                              _np({"params": want_grads, "batch_stats": want_stats}))
    grads, stats = dict(ref.named_parameters()), dict(ref.named_buffers())
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        close(p.grad.numpy(), grads[name].detach().numpy(), name)
    for name, b in model.named_buffers():
        close(b.numpy(), stats[name].numpy(), name)

    # the trajectory, from the same weights, beside the port's float64 one
    # (the exact trajectory), which names the cancelled entries: those
    # whose exact updates stay below CANCELLED_SHARE of lr
    lr = ADAMW["Optimizer"]["learning_rate"]
    exact = port_model(cfg, variables)
    start = {n: p.detach().double().clone() for n, p in exact.named_parameters()}
    exact_steps = []
    with chip_smoke.float64_port():
        exact = exact.double()
        b64 = chip_smoke.as_float64(batch)
        trainer = Trainer(exact, ADAMW)
        state = trainer.init_state(b64)
        for _ in range(STEPS):
            before = {n: p.detach().clone() for n, p in exact.named_parameters()}
            state, _ = trainer.train_step(state, b64)
            exact_steps.append({n: p.detach() - before[n] for n, p in exact.named_parameters()})
    frozen = {n: (p.detach() - start[n]).abs() < CANCELLED_SHARE * lr
              for n, p in exact.named_parameters() if cancelled(model_type, n)}
    model = port_model(cfg, variables)
    trainer = Trainer(model, ADAMW)
    state = trainer.init_state(batch)
    jbatch = jtrainer.put_batch(host)
    rng = jax.random.PRNGKey(0)
    first = _np(jstate)  # the step donates its state
    losses, jlosses, starts, jsteps, carried = [], [], [], [], []
    deltas = {"port": [], "jax": [], "exact": []}
    for step in range(STEPS):
        before = {n: p.detach().double().clone() for n, p in model.named_parameters()}
        starts.append({k: v.clone() for k, v in model.state_dict().items()})
        jsteps.append(_np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
        jstate, jmet = jtrainer._train_step(jstate, jbatch, rng)
        state, met = trainer.train_step(state, batch)
        jparams = _np(jstate.params)
        carried.append({n: (frozen[n].numpy(), jparams[n.split(".")[0]][n.split(".")[1]])
                        for n in frozen})
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name not in frozen:
                    continue
                # the cancelled entries take JAX's value after each step (their
                # rounding-noise updates move the BatchNorm's running mean),
                # the others keep the port's own; each step's update of the
                # cancelled entries is held below
                conv, leaf = name.split(".")
                jv = torch.from_numpy(np.array(jparams[conv][leaf]))
                m = frozen[name]
                deltas["port"].append((p.double() - before[name])[m])
                deltas["jax"].append((jv.double() - before[name])[m])
                deltas["exact"].append(exact_steps[step][name][m])
                p.copy_(torch.where(m, jv, p))
        losses.append(float(met["loss"]))
        jlosses.append(float(jmet["loss"]))
        close(met["tasks"].numpy(), np.array(jmet["tasks"]), "tasks")
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    want = port_model(cfg, _np({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})).state_dict()

    def relu_inputs(probe):
        z = chip_smoke.KinkReLUs()
        z.install(probe.train())(batch)
        return z.inputs

    def carry(k, params):
        params = jax.tree_util.tree_map(np.asarray, params)
        for name, (m, jv) in carried[k].items():
            conv, leaf = name.split(".")
            params[conv][leaf] = np.where(m, jv, params[conv][leaf])
        return params

    def exact64():
        """JAX's float64 trajectories from the same weights and graph, with
        the same cancelled entries carried in after each step, on the
        port's and on JAX's side of the ReLU kinks (``_torch_jax64``), in
        the port's names."""
        cards = []
        for start in starts:
            probe = port_model(cfg, variables)
            probe.load_state_dict(start)
            cards.append(relu_inputs(probe))
        runs = jax64.trajectories(jtrainer, first, host, rng, cards, jsteps,
                                  lambda v: relu_inputs(port_model(cfg, v)), carry)
        return tuple(load_flax_variables(create_model_config(cfg, device="cpu").double(),
                                          v).state_dict() for v in runs[:2])

    hold_final_state(model.state_dict(), want, exact64)
    if frozen:  # the cancelled entries' updates under the float64 rule, per step
        assert any(bool(m.any()) for m in frozen.values())
        assert not all(bool(m.all()) for n, m in frozen.items() if n.endswith(("b_l", "b_r")))
        d = {run: torch.cat(v) for run, v in deltas.items()}
        scale = max(float(u.abs().max()) for step in exact_steps for u in step.values())
        level = float((d["jax"] - d["exact"]).abs().max())
        worst = float((d["port"] - d["exact"]).abs().max())
        assert worst <= TRAJECTORY_FACTOR * level + FLOOR * scale, (worst, level, scale)


def _bf16_trajectories(cfg, seed):
    """The exact (float64), JAX bf16 and port bf16 dense trajectories from
    one set of weights, dropout 0 (``test_torch_bf16.trajectories``)."""
    host, batch = batches(graphs(seed, cfg["input_dim"]), "dense")
    bf16 = {**ADAMW, "mixed_precision": True}
    jtrainer = JaxTrainer(jax_create_model_config(cfg).clone(dropout=0.0), bf16)
    jstate = jtrainer.init_state(host)
    jbatch = jtrainer.put_batch(host)
    variables = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
    start = {n: p.detach().double() for n, p in port_model(cfg, variables).named_parameters()}
    jlosses = []
    for _ in range(BF16_STEPS):
        jstate, jmet = jtrainer._train_step(jstate, jbatch, jax.random.PRNGKey(0))
        jlosses.append(float(jmet["loss"]))
    jrun = _record(jlosses, port_model(cfg, _np({"params": jstate.params,
                                                 "batch_stats": jstate.batch_stats})), start)

    def run(mixed, f64=False):
        model, b = port_model(cfg, variables), batch
        if f64:
            model, b = model.double(), chip_smoke.as_float64(batch)
        trainer = Trainer(model, {**ADAMW, "mixed_precision": mixed})
        state = trainer.init_state(b)
        losses = []
        for _ in range(BF16_STEPS):
            state, met = trainer.train_step(state, b)
            losses.append(float(met["loss"]))
        return _record(losses, model, start)

    with chip_smoke.float64_port():
        exact = run(False, f64=True)
    return exact, jrun, run(True)


@pytest.mark.parametrize("model_type", STACKS)
def pytest_dense_bf16_trajectory_matches_jax(model_type):
    cfg = arch(model_type)
    exact, jrun, port = _bf16_trajectories(cfg, seed=0)
    rows, bad = hold(exact, jrun, port, TRAJECTORY_FACTOR,
                     cancelled=lambda name: cancelled(model_type, name))
    assert not bad, (rows, bad)
    losses = port["loss"]["loss"]
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
    assert rows["loss"][1] > 0 and rows["update"][1] > 0  # bf16 differs from exact


def jax_dtypes(jmodel, variables, jbatch):
    """``test_torch_bf16._jax_dtypes``'s record from an abstract forward
    (``jax.eval_shape``: traced, not compiled or run): ``(output dtypes,
    {module path: (input dtype, output dtype)})``."""
    seen = {}
    with nn.intercept_methods(_recorder(seen)):
        outs = jax.eval_shape(lambda v, b: jmodel.apply(v, b, train=False), variables, jbatch)
    return [str(o.dtype) for o in outs], seen


@pytest.mark.parametrize("model_type,branch", [("GAT", "dense"), ("GAT", "segment"),
                                               ("MFC", "segment"), ("CGCNN", "dense")])
def pytest_bf16_forward_keeps_jax_dtypes(model_type, branch):
    """Every module's input and output dtype in a bf16 forward equals the
    JAX package's (GAT's dense sum over K accumulates in float32 and comes
    back at bf16, as its ``einsum`` does)."""
    cfg = arch(model_type)
    host, batch = batches(graphs(2, cfg["input_dim"]), branch, with_targets=False)
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables(jmodel, host)
    jvars = {"params": _bf16_tree(variables["params"]),
             "batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    jdt, jseen = jax_dtypes(jmodel, jvars, _jax_bf16_batch(host))
    _, pdt, pseen = _port_dtypes(port_model(cfg, variables), batch, jseen)
    assert pdt == jdt == ["bfloat16", "bfloat16"]
    convs = [k for k in jseen if k.startswith("encoder_conv_") and "." not in k]
    assert convs and set(convs) <= set(pseen)
    assert pseen == {k: v for k, v in jseen.items() if k in pseen}


@pytest.mark.parametrize("masked", [False, True])
def pytest_segment_softmax_matches_jax(masked):
    rng = np.random.default_rng(3)
    e, s, h = 40, 7, 3
    logits = rng.standard_normal((e, h)).astype(np.float32) * 3.0
    logits[5] = logits[4]  # a tie at one receiver's max
    ids = np.sort(rng.integers(0, s - 1, e)).astype(np.int32)  # segment s-1 empty
    ids[4] = ids[5]
    mask = rng.random(e) > 0.3 if masked else None
    g = rng.standard_normal((e, h)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    for jfn, fn in ((jseg.segment_softmax, segment_softmax),
                    (jseg.segment_softmax_unnorm, segment_softmax_unnorm)):
        want, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(ids), s, mask=jmask),
                            jnp.asarray(logits))
        (want_grad,) = vjp(jnp.asarray(g))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = fn(x, torch.from_numpy(ids), s, mask=tmask)
        got.backward(torch.from_numpy(g))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def pytest_mfc_clamps_above_the_degree_bound():
    """With ``mfc_degree_bound`` 2, three banks are kept and every node of a
    higher degree takes the top one, as in the JAX package."""
    cfg = {**arch("MFC"), "mfc_degree_bound": 2}
    graph_list = graphs(4)
    host, batch = batches(graph_list, "segment", with_targets=False)
    deg = np.bincount(batch.receivers.numpy()[batch.edge_mask.numpy()], minlength=batch.num_nodes)
    assert deg.max() > 2  # the clamp is exercised
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables(jmodel, host)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, host)
    model = port_model(cfg, variables)
    with torch.inference_mode():
        got = model(batch)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    # the banks above the bound take no part: changing them changes nothing
    with torch.no_grad():
        model.encoder_conv_0.w_l[3:].add_(1.0)
        again = model(batch)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def pytest_cgcnn_refuses_a_conv_node_head_and_keeps_its_width():
    with pytest.raises(ValueError, match="CGCNN"):
        create_model_config(arch("CGCNN", node_type="conv"), device="cpu")
    model = create_model_config(arch("CGCNN"), device="cpu")
    assert model.hidden_dim == CGCNN_INPUT_DIM
    assert model.encoder_bn_0.weight.shape == (CGCNN_INPUT_DIM,)


@pytest.mark.parametrize("model_type", STACKS)
def pytest_fused_is_the_segment_path(model_type):
    """``aggregation="fused"`` runs these stacks through the same code as
    ``"segment"`` (the JAX package has no fused edge op for them): the
    outputs are bitwise equal."""
    cfg = arch(model_type)
    _, batch = batches(graphs(5, cfg["input_dim"]), "segment", with_targets=False)
    outs = []
    for aggregation in ("fused", "segment"):
        model = create_model_config(cfg, device="cpu", aggregation=aggregation, seed=3)
        with torch.inference_mode():
            outs.append(model(batch))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def pytest_attention_dropout_draws_from_the_generator_in_train_mode_only():
    cfg = arch("GAT")
    _, batch = batches(graphs(6), "segment", with_targets=False)
    model = create_model_config(cfg, device="cpu", seed=1)
    assert model.encoder_conv_0.dropout == 0.25
    with torch.inference_mode():
        a, b = model(batch), model(batch)  # eval: deterministic, no generator
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(batch)
    outs = [model(batch, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][1], outs[2][1])
    x = torch.rand(20000, 6) + 0.5
    y = attention_dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.to(torch.float64).mean())
    assert abs(share - 0.75) <= 3 * np.sqrt(0.75 * 0.25 / x.numel())
    assert torch.equal(y[kept], x[kept] / 0.75)
    # a dense-branch batch and a trainer step draw too
    model = create_model_config(cfg, device="cpu", seed=1)
    _, tbatch = batches(graphs(6), "dense")
    trainer = Trainer(model, ADAMW)
    state, met = trainer.train_step(trainer.init_state(tbatch), tbatch)
    assert bool(torch.isfinite(met["loss"]))
    assert dataclasses.is_dataclass(tbatch) and "nbr_idx" in tbatch.extras
