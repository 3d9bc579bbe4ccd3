"""Port parity in bf16 mixed precision: the port's bf16 forward and its
mixed-precision training step against the JAX package's.

bf16 is not bit parity. XLA on the CPU may keep float32 intermediates
across a fused chain of elementwise ops, where PyTorch rounds to bf16 after
every op, so the two frameworks' bf16 results differ by several bf16
roundings. Each is therefore held against an exact result, and the port
may lie ``C`` times as far from it as JAX's own bf16 result, per tensor
kind, plus a floor:

    max |port - exact| <= (C * level[kind] + FLOOR) * scale[kind]

for every tensor of the kind, where ``scale[kind]`` is the largest exact
magnitude of the kind and ``level[kind]`` the largest ``max |jax -
exact| / scale[kind]`` over its tensors. ``FLOOR`` is 1e-4.

- **Forwards** (eval, BatchNorm running statistics non-trivial): PNA in
  its three branches (``dense``, ``fused``, ``segment``), GIN, SAGE,
  SchNet and EGNN; kinds: the graph head and the node head; exact: the
  float32 forward of the same weights. The dtype of every module's input
  and output (each conv, its post-layers, each BatchNorm and head layer)
  equals JAX's: ``fused`` casts PNA's statistics back to bf16, ``segment``
  keeps K2's float32 statistics (the conv's tail then computes in float32),
  ``dense`` returns them at bf16.
- **Trajectories**: 20 AdamW steps (lr 1e-3) of multi-head PNA (hidden 16,
  2 layers, 6 graphs) through ``Trainer`` with ``mixed_precision: True``
  against the JAX ``Trainer._train_step``, in ``dense``, ``fused``
  (``HYDRAGNN_AGG=fused``) and ``segment`` (against JAX's XLA segment
  branch: with ``HYDRAGNN_PALLAS=1`` the JAX package cannot train in bf16,
  because the custom VJP of its Pallas ``segment_moments`` returns a
  float32 cotangent for bf16 data, which ``jax.custom_vjp`` rejects; the
  XLA branch computes the same statistics, in float32 too); kinds: the
  per-step losses, the parameter updates (final minus initial), the
  updates of the encoder convs' last biases (which BatchNorm cancels, so
  their gradient is rounding noise in any precision; scale: the largest
  other update) and the BatchNorm statistics; exact: a float64 trajectory
  of the port from the same weights (``chip_smoke.float64_port``).

``C`` (``FORWARD_FACTOR``, ``TRAJECTORY_FACTOR``): ``PYTHONPATH=.:tests
JAX_PLATFORMS=cpu python tests/test_torch_bf16.py`` reads the factor each
case needs, ``(worst / scale - FLOOR) / level``, over seeds 0-4 (every
forward case and every trajectory mode); each constant is 1.25 times the
largest need, rounded up to a whole number. That run read forwards 1.31
(PNA ``fused`` with edge features, seed 3, the node head; most cases need
0.7-1.0: the port lies as far from exact as JAX does) and trajectories
2.02 (``dense``, seed 3, the BatchNorm statistics), hence 2 and 3.

Also: the linear layers promote as JAX's (``x @ W`` in the promoted dtype,
then ``+ b``, two roundings in bf16), a mixed step keeps the BatchNorm
statistics in float32 and the gradients on the float32 parameters, and
every kernel wrapper (K1-K7) receives float32 in a bf16 forward and step.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models.common import SplitLinear as JaxSplitLinear
from hydragnn_tpu.models.common import TorchLinear as JaxTorchLinear
from hydragnn_tpu.ops import dense_agg as jdense
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

import chip_smoke
from chip_smoke import FUSED_KERNEL
from hydragnn_tpu_torch import ops
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.common import SplitLinear, TorchLinear
from hydragnn_tpu_torch.ops import dense_agg as dense
from hydragnn_tpu_torch.ops import fused_mp, segment_kernels
from hydragnn_tpu_torch.train import Trainer
from hydragnn_tpu_torch.train.steps import forward_bf16

from test_torch_gin_sage import jax_variables
from test_torch_gin_sage import arch as family_arch
from test_torch_pna import JAX_ENV, arch, samples
from test_torch_train import ADAMW, HEADS, PADS, _graphs, _np, _null_space

FORWARD_FACTOR = 2.0
TRAJECTORY_FACTOR = 3.0
FLOOR = 1e-4
STEPS = 20
BF16 = {"mixed_precision": True}

FORWARD_CASES = [
    # model_type, branch (PNA: dense, fused or segment), equivariance, edge_dim
    ("PNA", "dense", False, None),
    ("PNA", "fused", False, 1),
    ("PNA", "segment", False, None),
    ("GIN", "fused", False, None),
    ("SAGE", "segment", False, None),
    ("SchNet", "fused", True, None),
    ("SchNet", "segment", False, None),
    ("EGNN", "fused", True, 1),
    ("EGNN", "segment", True, None),
]
MODES = ("dense", "fused", "segment")


def _bf16_tree(tree):
    """JAX arrays, float32 leaves cast to bf16 (as ``train/steps.py``'s
    ``_cast_bf16``; numpy leaves would not do: ``1.0 + eps`` of a numpy
    bf16 scalar is a float64 one, which promotes GIN's sum to float32)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == jnp.float32
        else jnp.asarray(a), tree)


def _jax_bf16_batch(jbatch):
    return jbatch.replace(
        x=jbatch.x.astype(jnp.bfloat16),
        edge_attr=None if jbatch.edge_attr is None else jbatch.edge_attr.astype(jnp.bfloat16),
    )


def _jax_dtypes(jmodel, variables, jbatch):
    """``(outputs, {module path: (input dtype, output dtype)})`` of one
    JAX forward."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and args and hasattr(args[0], "dtype"):
            first = out[0] if isinstance(out, tuple) else out
            seen[".".join(context.module.path)] = (str(args[0].dtype), str(first.dtype))
        return out

    with nn.intercept_methods(record):
        outs = jmodel.apply(variables, jbatch, train=False)
    return [np.asarray(o.astype(jnp.float32)) for o in outs], [str(o.dtype) for o in outs], seen


def _port_dtypes(model, batch, paths):
    """The same record of the port's bf16 forward, for ``paths``."""
    seen, hooks = {}, []
    modules = dict(model.named_modules())
    for path in paths:
        if path in modules:
            def hook(mod, args, out, path=path):
                first = out[0] if isinstance(out, tuple) else out
                seen[path] = (str(args[0].dtype).replace("torch.", ""),
                              str(first.dtype).replace("torch.", ""))
            hooks.append(modules[path].register_forward_hook(hook))
    try:
        with torch.no_grad():
            outs = forward_bf16(model, batch)
    finally:
        for h in hooks:
            h.remove()
    return [o.float().numpy() for o in outs], [str(o.dtype).replace("torch.", "") for o in outs], seen


def _forward_cfg(model_type, equivariance, edge_dim):
    if model_type == "PNA":
        return arch(edge_dim=edge_dim)
    return family_arch(model_type, equivariance=equivariance, edge_dim=edge_dim)


def forward_case(model_type, branch, equivariance, edge_dim, seed):
    """The bf16 forwards of both frameworks and the f32 one of the port,
    from the same weights. Returns ``(needs per head kind, JAX dtypes,
    port dtypes, per-module dtypes of both)``."""
    cfg = _forward_cfg(model_type, equivariance, edge_dim)
    graphs = samples(seed=seed, with_edge_attr=edge_dim is not None)
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_collate(graphs, *PADS))
    batch = collate_graphs(graphs, *PADS)
    if branch == "dense":
        jbatch = jdense.attach_neighbor_lists(jbatch)
        batch = dense.attach_neighbor_lists(batch)
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables(jmodel, jbatch, seed)
    saved = {k: os.environ.pop(k, None) for k in ("HYDRAGNN_AGG", "HYDRAGNN_PALLAS")}
    try:
        if branch != "dense":
            env, value = JAX_ENV[branch]
            os.environ[env] = value
        jvars = {"params": _bf16_tree(variables["params"]),
                 **({"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
                    if "batch_stats" in variables else {})}
        jout, jdt, jseen = _jax_dtypes(jmodel, jvars, _jax_bf16_batch(jbatch))
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    model = create_model_config(cfg, device="cpu", aggregation="fused" if branch == "dense" else branch)
    load_flax_variables(model, variables)
    pout, pdt, pseen = _port_dtypes(model, batch, jseen)
    with torch.inference_mode():
        exact = [o.numpy().astype(np.float64) for o in model(batch)]
    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    needs = {}
    for kind, p, j, e in zip(cfg["output_type"], pout, jout, exact):
        m = masks[kind]
        scale = np.abs(e[m]).max()
        level = np.abs(j[m] - e[m]).max() / scale
        err = np.abs(p[m] - e[m]).max() / scale
        needs[kind] = ((err - FLOOR) / level if level > 0 else 0.0, err, level)
    return needs, jdt, pdt, jseen, pseen


@pytest.mark.parametrize("model_type,branch,equivariance,edge_dim", FORWARD_CASES)
def pytest_bf16_forward_matches_jax(model_type, branch, equivariance, edge_dim):
    needs, jdt, pdt, jseen, pseen = forward_case(model_type, branch, equivariance, edge_dim, seed=0)
    assert pdt == jdt
    assert pseen == {k: v for k, v in jseen.items() if k in pseen}
    convs = [k for k in jseen if k.startswith("encoder_conv_") and "." not in k]
    assert convs and set(convs) <= set(pseen)
    if model_type == "PNA":
        # the statistics' dtype, seen in the post-layer's input: bf16 but
        # in segment mode, whose float32 statistics promote the tail
        want = "float32" if branch == "segment" else "bfloat16"
        assert pseen["encoder_conv_0.post_nn"][0] == want
    for kind, (_, err, level) in needs.items():
        assert err <= FORWARD_FACTOR * level + FLOOR, (kind, err, level)


def _trajectory_batches(graphs, mode):
    host = jax_collate(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    if mode == "dense":
        host = jdense.attach_neighbor_lists(jax.tree_util.tree_map(jnp.asarray, host))
        batch = dense.attach_neighbor_lists(batch)
    return host, batch


def _port_run(cfg, variables, batch, mode, mixed, f64=False):
    model = create_model_config(cfg, device="cpu", aggregation="fused" if mode == "dense" else mode)
    load_flax_variables(model, variables)
    if f64:
        model, batch = model.double(), chip_smoke.as_float64(batch)
    trainer = Trainer(model, {**ADAMW, "mixed_precision": mixed})
    assert trainer.precision["mixed"] == mixed
    state = trainer.init_state(batch)
    start = {n: p.detach().double().clone() for n, p in model.named_parameters()}
    losses = []
    for _ in range(STEPS):
        state, met = trainer.train_step(state, batch)
        losses.append(float(met["loss"]))
    return _record(losses, model, start)


def _record(losses, model, start):
    return {
        "loss": {"loss": torch.tensor(losses, dtype=torch.float64)},
        "update": {n: p.detach().double() - start[n] for n, p in model.named_parameters()},
        "stat": {n: b.detach().double() for n, b in model.named_buffers()},
    }


def _kinds(run, cancelled=_null_space):
    """``{kind: {name: tensor}}``, the cancelled biases (``cancelled(name)``)
    a kind of their own."""
    out = {"loss": run["loss"], "update": {}, "cancelled": {}, "stat": run["stat"]}
    for n, t in run["update"].items():
        out["cancelled" if cancelled(n) else "update"][n] = t
    return out


def trajectories(mode, seed, cfg=None):
    """The exact (float64), JAX bf16 and port bf16 trajectories of one
    mode from one set of weights (``cfg``: multi-head PNA unless given)."""
    graphs = _graphs(seed)
    cfg = arch() if cfg is None else cfg
    host, batch = _trajectory_batches(graphs, mode)
    saved = {k: os.environ.pop(k, None) for k in ("HYDRAGNN_AGG", "HYDRAGNN_PALLAS")}
    try:
        if mode == "fused":
            os.environ["HYDRAGNN_AGG"] = "fused"
        jtrainer = JaxTrainer(jax_create_model_config(cfg), {**ADAMW, **BF16})
        jstate = jtrainer.init_state(host)
        jbatch = jtrainer.put_batch(host)
        variables = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
        rng = jax.random.PRNGKey(0)
        jlosses = []
        for _ in range(STEPS):
            jstate, jmet = jtrainer._train_step(jstate, jbatch, rng)
            jlosses.append(float(jmet["loss"]))
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    start_model = create_model_config(cfg, device="cpu")
    load_flax_variables(start_model, variables)
    start = {n: p.detach().double() for n, p in start_model.named_parameters()}
    end_model = create_model_config(cfg, device="cpu")
    load_flax_variables(end_model, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    jrun = _record(jlosses, end_model, start)
    with chip_smoke.float64_port():
        exact = _port_run(cfg, variables, batch, mode, mixed=False, f64=True)
    port = _port_run(cfg, variables, batch, mode, mixed=True)
    return exact, jrun, port


def hold(exact, jrun, port, factor, cancelled=_null_space):
    """Per kind: ``(scale, level, port's worst / scale)`` and the
    tensors outside ``(factor * level + FLOOR) * scale``; the need is
    ``(worst - FLOOR) / level``. ``cancelled``: which parameters' updates
    are the BatchNorm-cancelled kind."""
    ex, jx, pt = (_kinds(r, cancelled) for r in (exact, jrun, port))
    ex = {k: v for k, v in ex.items() if v}  # a stack may have no statistics
    top = {k: max(float(t.abs().max()) for t in v.values()) for k, v in ex.items()}
    top["cancelled"] = top["update"]  # exact updates ~0: rounding noise
    rows, bad = {}, []
    for kind, tensors in ex.items():
        s = top[kind]
        level = max(float((jx[kind][n] - t).abs().max()) for n, t in tensors.items()) / s
        worst = 0.0
        for n, t in tensors.items():
            err = float((pt[kind][n] - t).abs().max()) / s
            worst = max(worst, err)
            if err > factor * level + FLOOR:
                bad.append((kind, n, err, level))
        rows[kind] = (s, level, worst, (worst - FLOOR) / level if level > 0 else 0.0)
    return rows, bad


@pytest.mark.parametrize("mode", MODES)
def pytest_bf16_trajectory_matches_jax(mode):
    exact, jrun, port = trajectories(mode, seed=0)
    rows, bad = hold(exact, jrun, port, TRAJECTORY_FACTOR)
    assert not bad, (rows, bad)
    losses = port["loss"]["loss"]
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
    assert rows["loss"][1] > 0 and rows["update"][1] > 0  # bf16 differs from exact


def pytest_linear_layers_promote_and_round_as_jax():
    """``x @ W`` in the promoted dtype, then ``+ b``: on a 1/8 grid every
    product is exact, so the port and flax agree to the bit in each dtype
    pairing; off the grid the two roundings differ from ``F.linear``'s
    one."""
    rng = np.random.default_rng(3)
    x = (rng.integers(-8, 9, (5, 6)) / 8.0).astype(np.float32)
    w = (rng.integers(-8, 9, (6, 4)) / 8.0).astype(np.float32)
    b = (rng.integers(-8, 9, 4) / 8.0).astype(np.float32)
    for xd, wd in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16), (torch.float32, torch.float32)):
        jxd, jwd = (jnp.bfloat16 if d == torch.bfloat16 else jnp.float32 for d in (xd, wd))
        params = {"params": {"kernel": jnp.asarray(w, jwd), "bias": jnp.asarray(b, jwd)}}
        want = JaxTorchLinear(4).apply(params, jnp.asarray(x, jxd))
        lin = TorchLinear(6, 4)
        split = SplitLinear(6, 4)
        for layer in (lin, split):
            layer.weight = torch.nn.Parameter(torch.from_numpy(w.T.copy()).to(wd))
            layer.bias = torch.nn.Parameter(torch.from_numpy(b).to(wd))
        got = lin(torch.from_numpy(x).to(xd))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
        jsplit = JaxSplitLinear(4, 6)
        jpiece = jsplit.apply(params, jnp.asarray(x[:, 2:5], jxd), 2, method=JaxSplitLinear.piece)
        piece = split.piece(torch.from_numpy(x[:, 2:5]).to(xd), 2)
        assert str(piece.dtype).replace("torch.", "") == str(jpiece.dtype)
        np.testing.assert_array_equal(piece.detach().float().numpy(), np.asarray(jpiece, np.float32))
    # off the grid, bf16: the bias added after the product's rounding
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)).bfloat16()
    lin = TorchLinear(32, 16)
    lin.reset_parameters(torch.Generator().manual_seed(0))
    lin = lin.bfloat16()
    twice = (x @ lin.weight.t()) + lin.bias
    with torch.no_grad():
        torch.testing.assert_close(lin(x), twice, rtol=0, atol=0)


def pytest_mixed_step_keeps_float32_masters_and_statistics():
    graphs = _graphs(1)
    batch = collate_graphs(graphs, *PADS, head_types=HEADS[0], head_dims=HEADS[1])
    model = create_model_config(arch(), device="cpu", aggregation="segment")
    stats = {n: b for n, b in model.named_buffers()}
    before = {n: b.clone() for n, b in stats.items()}
    trainer = Trainer(model, {**ADAMW, **BF16})
    state, met = trainer.train_step(trainer.init_state(batch), batch)
    assert met["loss"].dtype == torch.float32
    for n, b in model.named_buffers():
        assert b is stats[n] and b.dtype == torch.float32, n  # updated in place
    assert any(not torch.equal(b, before[n]) for n, b in stats.items())
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, n
    ev = trainer.eval_step(state, batch)
    assert [o.dtype for o in ev["outputs"]] == [torch.float32, torch.float32]


@pytest.mark.parametrize("model_type,mode", [
    ("PNA", "fused"), ("PNA", "segment"), ("GIN", "fused"), ("SAGE", "fused"),
    ("SchNet", "fused"), ("EGNN", "fused"), ("EGNN", "segment"),
])
def pytest_bf16_reaches_every_kernel_as_float32(monkeypatch, model_type, mode):
    """Each kernel (K1-K7; on the CPU its plain version, which the wrapper
    calls) is handed float32 in a bf16 forward (for PNA a bf16 step): the
    upcast comes before the wrapper, as JAX's ``_fused_impl`` and
    ``_moments_impl`` upcast."""
    seen = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            leaves = list(args) + list(kwargs.values())
            leaves += [p for a in args if isinstance(a, (list, tuple)) for p in a]
            seen.setdefault(name, set()).update(
                a.dtype for a in leaves if isinstance(a, torch.Tensor) and a.is_floating_point())
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ops.KERNELS:
        spy(fused_mp if hasattr(fused_mp, name + "_plain") and name.startswith("fused")
            else segment_kernels, name + "_plain")
    egnn = model_type == "EGNN"
    cfg = _forward_cfg(model_type, model_type in ("SchNet", "EGNN"), 1 if egnn else None)
    model = create_model_config(cfg, device="cpu", aggregation=mode)
    if model_type == "PNA":
        batch = collate_graphs(_graphs(2), *PADS, head_types=HEADS[0], head_dims=HEADS[1])
        trainer = Trainer(model, {**ADAMW, **BF16})
        trainer.train_step(trainer.init_state(batch), batch)
    else:
        with torch.no_grad():
            forward_bf16(model, collate_graphs(samples(seed=2, with_edge_attr=egnn), *PADS))
    kernel = "segment_moments" if mode == "segment" else FUSED_KERNEL[model_type]
    if not (model_type == "EGNN" and mode == "segment"):
        assert kernel + "_plain" in seen
    assert "segment_sum_plain" in seen  # the pool
    assert all(d == {torch.float32} for d in seen.values()), seen


if __name__ == "__main__":
    # the derivation of FORWARD_FACTOR and TRAJECTORY_FACTOR: the factor
    # each case needs over seeds 0-4
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    seeds = range(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
    worst = {"forward": (0.0, None), "trajectory": (0.0, None)}
    for seed in seeds:
        for case in FORWARD_CASES:
            needs = forward_case(*case, seed=seed)[0]
            for kind, (need, err, level) in needs.items():
                print(f"forward seed {seed} {case} {kind}: need {need:.3f} "
                      f"(err {err:.3g}, jax level {level:.3g})", flush=True)
                worst["forward"] = max(worst["forward"], (need, (seed, case, kind)))
        for mode in MODES:
            rows, _ = hold(*trajectories(mode, seed), TRAJECTORY_FACTOR)
            for kind, (s, level, err, need) in rows.items():
                print(f"trajectory seed {seed} {mode} {kind}: need {need:.3f} "
                      f"(err {err:.3g}, jax level {level:.3g}, scale {s:.3g})", flush=True)
                worst["trajectory"] = max(worst["trajectory"], (need, (seed, mode, kind)))
    for what, (need, where) in worst.items():
        print(f"{what}: largest need {need:.3f} at {where}; factor "
              f"{int(np.ceil(1.25 * need))}", flush=True)
