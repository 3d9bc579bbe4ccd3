"""Port parity of DimeNet against the JAX package: its host tables (exact),
its one-owner aggregations (``jax.vjp``), and its basis, forward, gradients
and trajectory under a float64 rule.

- ``compute_triplets``, ``pack_triplets``, the slot tables of the dense
  lists, and the triplet layouts and plans (``t_pad``, capacities, the
  packed ``extras``) equal the JAX package's arrays exactly.
- ``group_sum``, ``gather_rows_to_slots`` and ``slots_to_rows``: values and
  ``jax.vjp``, rtol 1e-4 / atol 1e-5 (they move values; sums in float32).
- Padded triplets (mask False, pointing at edge 0 and the padding node)
  add exactly nothing and take no gradient; ``fused`` and ``segment`` are
  one path, bitwise.

**The float64 rule.** The spherical Bessel functions come from an upward
recurrence (``hydragnn_tpu/models/dimenet.py:59-67``), which loses
``j_l(z d)`` in float32 where ``d = dist / cutoff`` is small: against a
float64 evaluation the worst ``j_l`` is off by 8e-5 at ``d = 0.1`` and by
3e-2 at ``d = 0.05``, and the envelope multiplies by ``~1/d``. XLA's and
PyTorch's ``sin``/``cos`` differ by an ulp here and there, so the two
float32 results part far beyond rtol 1e-4 on such edges, each as far from
the exact value as the other. The graphs here have such edges (asserted:
some ``d < 0.1``). So the exact answer is the JAX package's own float64
evaluation (:func:`jax_float64`: the same variables and inputs in float64,
``jax.enable_x64``), and per kind of tensor the port is held to it twice:

    max |port_f32 - jax_f64| <= (C * level[kind] + FLOOR) * scale[kind]
    max |port_f64 - jax_f64| <= (F64_TOL + C * level[kind] * 2**-29) * scale[kind]

(``F64_UPDATE_TOL`` in place of ``F64_TOL`` for a trajectory's updates).

``scale[kind]`` the largest float64 magnitude of the kind, ``level[kind]``
the largest ``max |jax_f32 - jax_f64| / scale[kind]`` over its tensors (JAX's
own float32 error), ``FLOOR`` 1e-5 (the forwards' atol). The second line
holds the port's float64 evaluation (``chip_smoke.float64_port``) to
JAX's: two float64 evaluations of one function agree to ~1e-15, except
that JAX's dense branch rounds its batched matmul to float32
(``preferred_element_type``) and its AdamW keeps the learning rate in
float32 (~1e-8 of the scale), so ``F64_TOL`` is 1e-6: far below any
fault of a weight, a block or a table. AdamW divides each gradient by its
own size, so where a gradient lies near ``eps`` the dense product's
rounding moves the trajectory's updates further: by at most 8.5e-6 of
their scale over seeds 0-4 (the triplet branch: 1.2e-8), so the updates
take ``F64_UPDATE_TOL`` 1e-4. Where the recurrence loses even float64
(the basis at ``d`` near 1e-3), the float64 runs part as the float32 ones
do, scaled by the ratio of the unit roundoffs (``2**-29``). Kinds: the
basis (``rbf``, the radial part, the spherical basis), each head's output
(both branches: the triplet axis and the dense slot grids), one step's
loss and gradients, and a 5-step AdamW trajectory's losses, updates and
final parameters.

``C`` (``FACTOR``): ``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python
tests/test_torch_dimenet.py`` reads the factor each case needs, ``(worst
/ scale - FLOOR) / level``, and the port's float64 distance, over seeds
0-4; ``FACTOR`` is 1.25 times the largest need, rounded up to a whole
number.
"""

import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.data import loaders as jax_loaders
from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph.batch import pack_triplets as jax_pack_triplets
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import common as jcommon
from hydragnn_tpu.models import dimenet as jdime
from hydragnn_tpu.ops import dense_agg as jdense
from hydragnn_tpu.serve.buckets import plan_from_samples as jax_plan_from_samples
from hydragnn_tpu.train.trainer import Trainer as JaxTrainer

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
import chip_smoke
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.data.layout import collate_for_layout
from hydragnn_tpu_torch.graph import collate_graphs, compute_triplets, pack_triplets
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models import dimenet
from hydragnn_tpu_torch.ops import dense_agg as dense
from hydragnn_tpu_torch.serve import plan_from_samples
from hydragnn_tpu_torch.train import Trainer

from test_torch_pna import arch as pna_arch
from test_torch_train import ADAMW, HEADS, PADS, _np
from test_torch_train import _graphs as graphs

RTOL, ATOL = 1e-4, 1e-5
FLOOR = 1e-5
FACTOR = 4.0
F64_TOL = 1e-6
F64_UPDATE_TOL = 1e-4  # the trajectory's updates (the module's doc)
UNIT_RATIO = 2.0 ** -29  # float64's unit roundoff over float32's
STEPS = 5
BRANCHES = ("triplets", "dense")
DIME = dict(basis_emb_size=4, envelope_exponent=5, int_emb_size=8, out_emb_size=8,
            num_after_skip=1, num_before_skip=1, num_radial=6, num_spherical=7, radius=2.0)


def arch(hidden=8):
    cfg = pna_arch(hidden=hidden, layers=2)
    cfg.update(model_type="DimeNet", **DIME)
    return cfg


def _jax_triplets(g):
    return jdime.compute_triplets(g.edge_index, g.x.shape[0]) + (g.x.shape[0], g.edge_index.shape[1])


def batches(graph_list, branch, with_targets=True):
    """The host batch on both sides with the triplet tables (and, in the
    dense branch, the lists with their slot tables)."""
    heads = dict(head_types=HEADS[0], head_dims=HEADS[1]) if with_targets else {}
    n_pad = PADS[0]
    host = jax_collate(graph_list, *PADS, **heads)
    host = host.replace(extras=jax_pack_triplets([_jax_triplets(g) for g in graph_list], n_pad))
    host = jax.tree_util.tree_map(jnp.asarray, host)
    batch = collate_graphs(graph_list, *PADS, **heads)
    trips = [compute_triplets(g.edge_index, g.x.shape[0]) + (g.x.shape[0], g.edge_index.shape[1])
             for g in graph_list]
    batch = batch.with_extras({k: torch.from_numpy(v)
                               for k, v in pack_triplets(trips, n_pad).items()})
    if branch == "dense":
        host = jdense.attach_neighbor_lists(host)
        batch = dense.attach_neighbor_lists(batch)
    return host, batch


def port_model(cfg, variables, aggregation="segment"):
    model = create_model_config(cfg, device="cpu", aggregation=aggregation)
    return load_flax_variables(model, variables)


def hold(exact, jx, port, port64, factor=FACTOR):
    """``{kind: (scale, level, worst, need, f64)}`` and the tensors outside
    the float64 rule (the port's float32 run against ``factor`` times the
    JAX package's float32 error, its float64 run against ``F64_TOL``, or
    ``F64_UPDATE_TOL`` for updates);
    each argument is ``{kind: {name: tensor}}``, ``exact`` the JAX
    package's float64 run."""
    as64 = lambda t: torch.as_tensor(np.asarray(t, np.float64))  # noqa: E731
    rows, bad = {}, []
    for kind, tensors in exact.items():
        t64 = {n: as64(t) for n, t in tensors.items()}
        scale = max(float(t.abs().max()) for t in t64.values())
        level = max(float((as64(jx[kind][n]) - t).abs().max()) for n, t in t64.items()) / scale
        worst = worst64 = 0.0
        for n, t in t64.items():
            err = float((as64(port[kind][n]) - t).abs().max()) / scale
            err64 = float((as64(port64[kind][n]) - t).abs().max()) / scale
            worst, worst64 = max(worst, err), max(worst64, err64)
            if err > factor * level + FLOOR:
                bad.append(("f32", kind, n, err, level))
            if err64 > (F64_UPDATE_TOL if kind == "update" else F64_TOL) + (
                    factor * level * UNIT_RATIO):
                bad.append(("f64", kind, n, err64, level))
        rows[kind] = (scale, level, worst, (worst - FLOOR) / level if level > 0 else 0.0,
                      worst64)
    return rows, bad


class _Jnp64:
    """``jax.numpy``, with ``float32`` meaning ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """The JAX package in float64: ``jax.enable_x64``, and the float32
    casts of its shared layers (the loss reductions and BatchNorm's
    statistics, ``hydragnn_tpu/models/common.py``) read as float64, as
    ``chip_smoke.float64_port`` reads the port's. DimeNet's own module
    keeps its float32 Bessel zeros (the port keeps the same values) and
    its dense product's float32 result (``preferred_element_type``)."""
    old = jcommon.jnp
    jcommon.jnp = _Jnp64()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jcommon.jnp = old


def _f64(tree):
    """``tree`` with its floating leaves as float64 JAX arrays (inside
    ``jax.enable_x64``)."""
    def conv(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if np.issubdtype(a.dtype, np.floating) else a.dtype)
    return jax.tree_util.tree_map(conv, tree)


def _double(model, batch):
    return model.double(), chip_smoke.as_float64(batch)


def _min_d(batch):
    real = batch.edge_mask.numpy()
    pos = batch.pos.numpy().astype(np.float64)
    s, r = batch.senders.numpy()[real], batch.receivers.numpy()[real]
    return float(np.linalg.norm(pos[s] - pos[r], axis=1).min()) / DIME["radius"]


# ---- host tables -------------------------------------------------------------


def pytest_triplet_tables_equal_jax():
    graph_list = graphs(0)
    for g in graph_list:
        got = compute_triplets(g.edge_index, g.x.shape[0])
        want = jdime.compute_triplets(g.edge_index, g.x.shape[0])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for g in (np.zeros((2, 0), np.int64),):
        assert all(t.shape == (0,) for t in compute_triplets(g, 3))
    trips = [compute_triplets(g.edge_index, g.x.shape[0]) + (g.x.shape[0], g.edge_index.shape[1])
             for g in graph_list]
    jtrips = [_jax_triplets(g) for g in graph_list]
    for t_pad in (None, 4000):
        got, want = pack_triplets(trips, 61, t_pad), jax_pack_triplets(jtrips, 61, t_pad)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="t_pad"):
        pack_triplets(trips, 61, 8)
    # the slot tables of a triplet batch's lists
    host, batch = batches(graph_list, "dense", with_targets=False)
    for key in ("out_edge", "edge_slot", "out_slot", "nbr_idx", "rev_idx", "trip_ji"):
        np.testing.assert_array_equal(batch.extras[key].numpy(), np.asarray(host.extras[key]),
                                      err_msg=key)


def _plan_graphs(cls, seed):
    out = []
    for g in graphs(seed) + graphs(seed + 1):
        s = cls(x=g.x, pos=g.pos, edge_index=g.edge_index)
        s.targets = []
        out.append(s)
    return out


@pytest.mark.parametrize("need_neighbors", [False, True])
def pytest_triplet_layouts_and_plans_equal_jax(need_neighbors):
    graph_list = _plan_graphs(GraphData, 3)
    plan = plan_from_samples(graph_list, max_batch_graphs=4, need_triplets=True,
                             need_neighbors=need_neighbors)
    jplan = jax_plan_from_samples(_plan_graphs(JaxGraphData, 3), max_batch_graphs=4,
                                  need_triplets=True, need_neighbors=need_neighbors)
    assert plan.num_buckets == jplan.num_buckets
    for lay, jlay, cap, jcap in zip(plan.layouts, jplan.layouts, plan.capacities,
                                    jplan.capacities):
        assert (lay.n_pad, lay.e_pad, lay.t_pad, lay.packs_triplets, lay.k_in, lay.k_out) == (
            jlay.n_pad, jlay.e_pad, jlay.t_pad, jlay.packs_triplets, jlay.k_in, jlay.k_out)
        assert (cap.max_nodes, cap.max_edges, cap.max_triplets) == (
            jcap.max_nodes, jcap.max_edges, jcap.max_triplets)
    for g, jg in zip(graph_list, _plan_graphs(JaxGraphData, 3)):
        assert plan.admit(g) == jplan.admit(jg)
    b = plan.num_buckets - 1
    take = [g for g in graph_list if plan.admit(g)[0] == b][:3]
    jtake = [jg for g, jg in zip(graph_list, _plan_graphs(JaxGraphData, 3)) if g in take]
    got = collate_for_layout(take, plan.layouts[b])
    want = jax_loaders.collate_for_layout(jtake, jplan.layouts[b], with_targets=False)
    assert set(got.extras) == set(want.extras)
    for key in want.extras:
        np.testing.assert_array_equal(got.extras[key].numpy(), np.asarray(want.extras[key]),
                                      err_msg=key)
    n, e, t = plan.request_sizes(take[0])
    assert plan.fits_batch(b, 0, 0, 0, (n, e, t))
    if plan.layouts[b].packs_triplets:
        assert not plan.fits_batch(b, 0, 0, 0, (n, e, t), acc_trips=plan.layouts[b].t_pad)


# ---- one-owner aggregations --------------------------------------------------


def pytest_one_owner_aggregations_match_jax_vjp():
    graph_list = graphs(1)
    _, batch = batches(graph_list, "dense", with_targets=False)
    ex = {k: v for k, v in batch.extras.items()}
    rng = np.random.default_rng(0)
    e, n = batch.num_edges, batch.num_nodes
    emask = batch.edge_mask
    j = {k: jnp.asarray(v.numpy()) for k, v in ex.items()}
    jemask = jnp.asarray(emask.numpy())
    jrecv = jnp.asarray(batch.receivers.numpy())
    vals = rng.standard_normal((e, 5)).astype(np.float32)
    ki, ko = ex["nbr_edge"].shape[1], ex["out_edge"].shape[1]
    slots = rng.standard_normal((n, ko, 5)).astype(np.float32)
    cases = [
        (lambda v: jdense.group_sum(v, j["nbr_edge"], j["nbr_mask"], jrecv, jemask),
         lambda v: dense.group_sum(v, ex["nbr_edge"], ex["nbr_mask"], batch.receivers, emask),
         vals, (n, 5)),
        (lambda v: jdense.gather_rows_to_slots(v, j["nbr_edge"], j["nbr_mask"], j["edge_slot"],
                                               jemask),
         lambda v: dense.gather_rows_to_slots(v, ex["nbr_edge"], ex["nbr_mask"], ex["edge_slot"],
                                              emask),
         vals, (n, ki, 5)),
        (lambda s: jdense.slots_to_rows(s, j["out_slot"], jemask, j["out_edge"], j["rev_mask"]),
         lambda s: dense.slots_to_rows(s, ex["out_slot"], emask, ex["out_edge"], ex["rev_mask"]),
         slots, (e, 5)),
    ]
    for jfn, fn, x, out_shape in cases:
        g = rng.standard_normal(out_shape).astype(np.float32)
        want, vjp = jax.vjp(jfn, jnp.asarray(x))
        (want_grad,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = fn(xt)
        got.backward(torch.from_numpy(g))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


# ---- the float64 rule --------------------------------------------------------


def basis_case(seed):
    """The basis of both frameworks in float32 and float64 on edge lengths
    from 1e-3 to the cutoff and random angles, as ``(jax f64, jax f32,
    port f32, port f64)``: kinds by ``d = dist / cutoff`` below 0.1 (where
    float32 loses ``j_l``) or not (the sbf rows by their ``k->j`` edge's
    ``d``)."""
    rng = np.random.default_rng(seed)
    cutoff = DIME["radius"]
    d = np.concatenate([np.geomspace(1e-3, 0.1, 30, endpoint=False), rng.uniform(0.1, 1.0, 50)])
    dist = (d * cutoff).astype(np.float32)
    angle = rng.uniform(0.0, np.pi, 160).astype(np.float32)
    idx = rng.integers(0, dist.shape[0], 160).astype(np.int32)
    small, small_t = d < 0.1, d[idx] < 0.1
    s, r, p = DIME["num_spherical"], DIME["num_radial"], DIME["envelope_exponent"]

    def kinds(radial, sbf, env):
        radial, sbf, env = (np.asarray(a, np.float64) for a in (radial, sbf, env))
        return {
            "radial d<0.1": {"radial": radial[small]},
            "radial d>=0.1": {"radial": radial[~small]},
            "sbf d<0.1": {"sbf": sbf[small_t]},
            "sbf d>=0.1": {"sbf": sbf[~small_t]},
            "envelope": {"envelope": env},
        }

    @jax.jit
    def basis(jd, ja, ji):
        return (jdime._radial_sbf(jd, s, r, cutoff, p),
                jdime.spherical_basis(s, r, cutoff, p, jd, ja, ji),
                jdime.Envelope(p)(jd / cutoff))

    def jax_run(dt):
        return kinds(*basis(jnp.asarray(dist, dt), jnp.asarray(angle, dt), jnp.asarray(idx)))

    def port(dt):
        pd, pa = torch.from_numpy(dist).to(dt), torch.from_numpy(angle).to(dt)
        return kinds(dimenet.radial_sbf(pd, s, r, cutoff, p).numpy(),
                     dimenet.spherical_basis(s, r, cutoff, p, pd, pa, torch.from_numpy(idx)).numpy(),
                     dimenet.envelope(pd / cutoff, p).numpy())

    with jax_float64():
        exact = jax_run(jnp.float64)
    return exact, jax_run(jnp.float32), port(torch.float32), port(torch.float64)


def forward_case(seed, branch):
    """Each head's output on real nodes and graphs, as ``(jax f64, jax
    f32, port f32, port f64)``, and the batch's least ``d``."""
    cfg = arch()
    graph_list = graphs(seed)
    host, batch = batches(graph_list, branch, with_targets=False)
    jmodel = jax_create_model_config(cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)({"params": jax.random.PRNGKey(seed)}, host))
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    jout = apply(variables, host)
    with jax_float64():
        jout64 = apply(_f64(variables), _f64(host))
    model = port_model(cfg, variables)
    with torch.inference_mode():
        out32 = model(batch)
    with chip_smoke.float64_port(), torch.inference_mode():
        m64, b64 = _double(port_model(cfg, variables), batch)
        out64 = m64(b64)
    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    kinds = [f"{kind}_head" for kind in cfg["output_type"]]
    pick = lambda outs: {k: {k: np.asarray(o)[masks[k.split("_")[0]]]}  # noqa: E731
                         for k, o in zip(kinds, outs)}
    return (pick(jout64), pick(jout), pick(out32), pick(out64)), _min_d(batch)


def _grads(model, batch):
    model.train()
    loss, _ = model.loss(model(batch), batch)
    loss.backward()
    return loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _jax_run(jtrainer, jstate, host, start, cfg):
    """One step's loss and gradients (``jax.value_and_grad`` of the JAX
    step's loss) and a 5-step trajectory of the JAX ``Trainer``'s own
    step from ``jstate``, in the port's names and as numpy."""
    jmodel = jtrainer.model

    def loss_fn(params):
        outputs = jmodel.apply({"params": params}, host, train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jmodel.loss(outputs, host)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    def names(params):  # in a float64 copy of the port's model: no rounding on the way
        model = create_model_config(cfg, device="cpu").double()
        return dict(load_flax_variables(model, _np({"params": params})).named_parameters())

    losses = []
    for _ in range(STEPS):
        jstate, met = jtrainer._train_step(jstate, host, jax.random.PRNGKey(0))
        losses.append(float(met["loss"]))
    return {
        "step_loss": {"loss": np.array([float(loss)])},
        "grad": {n: p.detach().numpy() for n, p in names(grads).items()},
        "loss": {"loss": np.array(losses)},
        "update": {n: (p.detach().double() - start[n]).numpy()
                   for n, p in names(jstate.params).items()},
    }


def step_case(seed, branch):
    """One step's loss and gradients, and a 5-step AdamW trajectory's
    losses, updates and final parameters, as ``(jax f64, jax f32, port
    f32, port f64)``; JAX's float64 run starts from the same parameters
    and a fresh optimizer state."""
    cfg = arch()
    host, batch = batches(graphs(seed), branch)
    jtrainer = JaxTrainer(jax_create_model_config(cfg), ADAMW)
    jstate = jtrainer.init_state(host)
    variables = _np({"params": jstate.params})
    start = {n: p.detach().double() for n, p in port_model(cfg, variables).named_parameters()}
    first = _np(jstate)  # the step donates its state
    runs = {"jax": _jax_run(jtrainer, jstate, jtrainer.put_batch(host), start, cfg)}
    with jax_float64():
        state64 = _f64(first)
        state64 = state64.replace(opt_state=jtrainer.tx.init(state64.params))
        runs["jax64"] = _jax_run(jtrainer, state64, _f64(host), start, cfg)
    for name, f64 in (("port", False), ("port64", True)):
        with (chip_smoke.float64_port() if f64 else torch.enable_grad()):
            model, b = port_model(cfg, variables), batch
            if f64:
                model, b = _double(model, batch)
            loss, grads = _grads(model, b)
            model = port_model(cfg, variables)
            if f64:
                model, b = _double(model, batch)
            trainer = Trainer(model, ADAMW)
            state = trainer.init_state(b)
            losses = []
            for _ in range(STEPS):
                state, met = trainer.train_step(state, b)
                losses.append(float(met["loss"]))
            runs[name] = {
                "step_loss": {"loss": np.array([float(loss)])},
                "grad": {n: g.numpy() for n, g in grads.items()},
                "loss": {"loss": np.array(losses)},
                "update": {n: (p.detach().double() - start[n]).numpy()
                           for n, p in model.named_parameters()},
            }
    return runs["jax64"], runs["jax"], runs["port"], runs["port64"]


def pytest_basis_holds_the_float64_rule():
    rows, bad = hold(*basis_case(seed=0))
    assert not bad, (rows, bad)
    # the recurrence's loss shows below d = 0.1, and only there
    assert rows["radial d<0.1"][1] > 1.0 and rows["radial d>=0.1"][1] < 1e-3


@pytest.mark.parametrize("branch", BRANCHES)
def pytest_forward_holds_the_float64_rule(branch):
    case, min_d = forward_case(seed=0, branch=branch)
    assert min_d < 0.1  # edges where the float32 recurrence loses j_l
    rows, bad = hold(*case)
    assert not bad, (rows, bad)
    for kind, tensors in case[2].items():
        assert np.isfinite(tensors[kind]).all()


@pytest.mark.parametrize("branch", BRANCHES)
def pytest_step_and_trajectory_hold_the_float64_rule(branch):
    case = step_case(seed=0, branch=branch)
    rows, bad = hold(*case)
    assert not bad, (rows, bad)
    losses = case[2]["loss"]["loss"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def pytest_padded_triplets_add_nothing_and_take_no_gradient():
    """The same graphs with 3x the triplet slots: the padded slots (mask
    False, edge 0, the padding node) change no output, take exactly zero
    gradient (held on the hoisted basis rows), and leave the parameters'
    gradients as they were (up to the order a longer matmul sums in)."""
    cfg = arch()
    graph_list = graphs(2)
    _, batch = batches(graph_list, "triplets")
    trips = [compute_triplets(g.edge_index, g.x.shape[0]) + (g.x.shape[0], g.edge_index.shape[1])
             for g in graph_list]
    total = sum(t[0].shape[0] for t in trips)
    wide = batch.with_extras({k: torch.from_numpy(v) for k, v in
                              pack_triplets(trips, PADS[0], 3 * total).items()})
    assert not bool(wide.extras["trip_mask"][total:].any())
    results = []
    for b in (batch, wide):
        model = create_model_config(cfg, device="cpu", seed=4).train()
        b = model.prepare_batch(b)  # the basis rows as a leaf of their own
        sbf = b.extras["dn_sbf"].clone().requires_grad_(True)
        b = b.with_extras({"dn_sbf": sbf})
        outs = model(b)
        loss, _ = model.loss(outs, b)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        results.append(([o.detach() for o in outs], float(loss), grads, sbf.grad))
    (o1, l1, g1, s1), (o2, l2, g2, s2) = results
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    assert l1 == l2
    assert torch.equal(s2[:total], s1[:total]) and not bool(s2[total:].any())
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), rtol=1e-5,
                                   atol=1e-7 * float(g1[n].abs().max()), err_msg=n)


def pytest_fused_is_the_segment_path_and_a_batch_without_tables_raises():
    cfg = arch()
    _, batch = batches(graphs(5), "triplets", with_targets=False)
    outs = []
    for aggregation in ("fused", "segment"):
        model = create_model_config(cfg, device="cpu", aggregation=aggregation, seed=3)
        with torch.inference_mode():
            outs.append(model(batch))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="triplet"):
        with torch.inference_mode():
            create_model_config(cfg, device="cpu")(dataclasses.replace(batch, extras={}))
    for key in ("basis_emb_size", "radius"):
        with pytest.raises(ValueError, match=key):
            create_model_config({**cfg, key: None}, device="cpu")


def _needs(seeds):
    """The factor each case needs, and the port's float64 distance, over
    ``seeds`` (see the module's doc)."""
    worst = {}
    for seed in seeds:
        cases = {"basis": basis_case(seed)}
        for branch in BRANCHES:
            cases[f"forward {branch}"] = forward_case(seed, branch)[0]
            cases[f"step {branch}"] = step_case(seed, branch)
        for name, case in cases.items():
            rows, _ = hold(*case)
            for kind, (_, level, err, need, err64) in rows.items():
                print(f"seed {seed} {name} {kind}: level {level:.3g} port {err:.3g} "
                      f"need {need:.3g} port f64 {err64:.3g}", flush=True)
                worst[(name, kind)] = max(worst.get((name, kind), 0.0), need)
    return worst


if __name__ == "__main__":
    needs = _needs(range(5))
    top = max(needs.values())
    print(f"largest need {top:.3g} at {max(needs, key=needs.get)}; "
          f"FACTOR = ceil(1.25 * {top:.3g}) = {np.ceil(1.25 * top)}")
    sys.exit(0)


def pytest_bf16_forward_keeps_jax_dtypes(branch="dense"):
    """Every module's input and output dtype in a bf16 forward equals the
    JAX package's: the geometry stays float32 (``pos`` is float32) and is
    cast to bf16 only where JAX casts it (``rad.astype(dt)`` in the dense
    branch); the concatenated edge features promote to float32 as
    ``jnp.concatenate`` does."""
    from test_torch_bf16 import _bf16_tree, _jax_bf16_batch, _port_dtypes
    from test_torch_gat_mfc_cgcnn import jax_dtypes

    cfg = arch()
    host, batch = batches(graphs(6), branch, with_targets=False)
    jmodel = jax_create_model_config(cfg)
    init = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, host)
    variables = jax.tree_util.tree_map(np.asarray, init)
    jdt, jseen = jax_dtypes(jmodel, {"params": _bf16_tree(variables["params"])},
                            _jax_bf16_batch(host))
    _, pdt, pseen = _port_dtypes(port_model(cfg, variables), batch, jseen)
    assert pdt == jdt
    assert {"encoder_conv_0", "encoder_conv_0.int_sbf1", "encoder_conv_0.rbf"} <= set(pseen)
    assert pseen == {k: v for k, v in jseen.items() if k in pseen}


def pytest_bench_rows_and_triplet_batches_equal_jax():
    """``bench_model``'s new rows are the JAX package's (``bench.py``), and
    its graphs, architectures and batches (DimeNet's triplets, CGCNN's
    ``input_dim``) equal JAX's; a tiny dense bf16 DimeNet row runs on the
    CPU."""
    import bench
    from benchmarks import model_bench as jax_bench

    from hydragnn_tpu_torch.benchmarks import model_bench

    extra = bench._extra_configs()
    assert all(row in extra for row in model_bench.MXU_ROWS)
    assert {r["model_type"] for r in model_bench.MXU_ROWS} == {
        "GIN", "SAGE", "SchNet", "EGNN", "GAT", "MFC", "CGCNN", "DimeNet"}
    for model_type, kw in (("DimeNet", {}), ("CGCNN", {"input_dim": 4})):
        got = model_bench.make_graphs(3, 12, 4, seed=2, **kw)
        want = jax_bench.make_graphs(3, 12, 4, seed=2, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.x, w.x)
            np.testing.assert_array_equal(g.edge_index, w.edge_index)
        mine = model_bench._arch(model_type, 32, 2, 12, **kw)
        theirs = jax_bench._arch(model_type, 32, 2, 12, **kw)
        assert mine == {k: theirs[k] for k in mine}, model_type
        trips = model_type == "DimeNet"
        batch = model_bench._collate(got, 3, 12, 4, with_triplets=trips)
        jbatch = jax_bench._collate(want, 3, 12, 4, with_triplets=trips)
        assert set(batch.extras) == set(jbatch.extras or {})
        for key in batch.extras:
            np.testing.assert_array_equal(batch.extras[key].numpy(), np.asarray(jbatch.extras[key]))
        ident = dict(model_type=model_type, hidden=32, dense=True, bf16=True, **kw)
        assert model_bench.config_identity(**ident) == jax_bench.config_identity(**ident)
    row = model_bench.bench_model(model_type="DimeNet", hidden=16, num_graphs=2, nodes=8,
                                  degree=4, layers=2, dense=True, bf16=True, iters=1, device="cpu")
    assert np.isfinite(row["final_loss"]) and np.isfinite(row["eval_loss"])
