"""Port parity: the dense neighbour-list branch (``ops/dense_agg.py``, PNA's
dense branch, the layouts and plans that carry the lists) against the JAX
package's.

- The host-side builders give the JAX builders' arrays exactly, the
  overflow error included.
- ``gather_neighbors``, ``dense_moments`` and ``dense_minmax`` against JAX,
  forward and ``jax.vjp``, in f32 (rtol 1e-5, atol 1e-6): random data with
  empty receivers; exact ties, whose gradient both split evenly; and bf16
  inputs on a 1/8 grid, where every sum is exact and so are the results.
- ``dense_sum`` and ``aggregate_to_senders`` (the sum at the senders
  through the reverse lists, whose backward gathers through the forward
  lists) against JAX's, forward and ``jax.vjp``, in f32 and exactly on a
  bf16 grid.
- The dense forward and parameter gradients of PNA, GIN, SAGE, SchNet and
  EGNN against the JAX dense branch in f32 (forward rtol 1e-4 / atol
  1e-5; gradients at ``test_torch_train.py``'s rtol 1e-4 / atol 1e-5 of
  the tensor's max), with and without edge features (SchNet's edge
  lengths, EGNN's encoded ``edge_attr``) and the coordinate updates, and
  against the port's own ``fused`` branch at rtol 2e-4 / atol 2e-5
  (``tests/test_dense_agg.py``'s bound between the JAX branches).
- ``collate_for_layout``, ``plan_from_samples(need_neighbors=True)``,
  ``needs_dense_neighbors`` and the static policy against JAX's; the lists
  travel in ``GraphBatch.to``'s one staged buffer; a stack without a
  dense branch refuses a batch that carries the lists.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.data import loaders as jax_loaders
from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import pad_sizes_for
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.ops import autotune as jax_autotune
from hydragnn_tpu.ops import dense_agg as jdense
from hydragnn_tpu.serve import plan_from_samples as jax_plan_from_samples

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.data.layout import BatchLayout, collate_for_layout, needs_dense_neighbors
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.ops import autotune
from hydragnn_tpu_torch.ops import dense_agg as dense
from hydragnn_tpu_torch.serve import plan_from_samples

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_gin_sage import arch as family_arch
from test_torch_gin_sage import jax_variables as family_variables
from test_torch_pna import arch, jax_variables, samples
from test_torch_serve import PLAN_SIZES, _graphs

RTOL, ATOL = 1e-4, 1e-5  # the model's forward and gradients
OP_RTOL, OP_ATOL = 1e-5, 1e-6  # one op
BRANCH_RTOL, BRANCH_ATOL = 2e-4, 2e-5  # dense against fused
PADS = pad_sizes_for(10, 40, 6)
KEYS = ("nbr_idx", "nbr_edge", "nbr_mask", "rev_idx", "rev_mask")


def _edges(seed, n=30, e=120, padded=True):
    """A random edge list with padding edges (pointing at the last node,
    the collate contract) and receivers that get no edge."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n, e)
    receivers = rng.integers(0, n - 5, e)
    mask = rng.random(e) < 0.8 if padded else np.ones(e, bool)
    senders[~mask] = n - 1
    receivers[~mask] = n - 1
    return senders, receivers, mask, n


@pytest.mark.parametrize("seed", [0, 1])
def pytest_neighbor_lists_equal_jax(seed):
    senders, receivers, mask, n = _edges(seed)
    assert dense.max_degree(senders, receivers, mask) == jdense.max_degree(senders, receivers, mask)
    assert dense.max_degree(senders, receivers) == jdense.max_degree(senders, receivers)
    assert dense.max_degree(senders[:0], receivers[:0]) == (1, 1)
    k_in, k_out = dense.max_degree(senders, receivers, mask)
    got = dense.build_neighbor_lists(senders, receivers, mask, n, k_in, k_out)
    want = jdense.build_neighbor_lists(senders, receivers, mask, n, k_in, k_out)
    assert set(got) == set(want) == set(KEYS)
    for key in KEYS:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # wider than needed: the same lists, more padded slots
    got = dense.build_neighbor_lists(senders, receivers, mask, n, k_in + 2, k_out + 1)
    want = jdense.build_neighbor_lists(senders, receivers, mask, n, k_in + 2, k_out + 1)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def pytest_group_lists_equal_jax_and_overflow_raises():
    owners = np.array([3, 1, 3, 0, 3, 1])
    valid = np.array([True, True, False, True, True, True])
    for mask in (None, valid):
        for k in (3, 4):
            got, want = dense.build_group_lists(owners, mask, 5, k), jdense.build_group_lists(owners, mask, 5, k)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for mod in (dense, jdense):
        with pytest.raises(ValueError, match="k_in=2"):
            mod.build_group_lists(owners, None, 5, 2, label="k_in")
    senders, receivers, mask, n = _edges(2)
    k_in, k_out = dense.max_degree(senders, receivers, mask)
    with pytest.raises(ValueError, match=f"k_out={k_out - 1}"):
        dense.build_neighbor_lists(senders, receivers, mask, n, k_in, k_out - 1)
    # the slot tables (DimeNet's dense branch) are ported: the JAX arrays
    got = dense.build_neighbor_lists(senders, receivers, mask, n, k_in, k_out, with_slot_tables=True)
    want = jdense.build_neighbor_lists(senders, receivers, mask, n, k_in, k_out, with_slot_tables=True)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _lists(seed, padded=True):
    senders, receivers, mask, n = _edges(seed, padded=padded)
    k_in, k_out = dense.max_degree(senders, receivers, mask)
    return dense.build_neighbor_lists(senders, receivers, mask, n, k_in, k_out), n


def _ops_case(lists, h):
    """``(port outputs, port input grads)`` and the same from JAX for
    gather -> mask -> moments and min/max, pulled back from one set of
    seeded cotangents."""
    t = {k: torch.from_numpy(v) for k, v in lists.items()}
    j = {k: jnp.asarray(v) for k, v in lists.items()}

    def port(x):
        z = dense.gather_neighbors(x, t["nbr_idx"], t["rev_idx"], t["rev_mask"])
        z = torch.where(t["nbr_mask"][..., None], z, 0.0)
        mean, std, deg, has = dense.dense_moments(z, t["nbr_mask"])
        mn, mx = dense.dense_minmax(z, t["nbr_mask"], has)
        return z, mean, std, deg, mn, mx

    def jfn(x):
        z = jdense.gather_neighbors(x, j["nbr_idx"], j["rev_idx"], j["rev_mask"])
        z = jnp.where(j["nbr_mask"][..., None], z, 0.0)
        mean, std, deg, has = jdense.dense_moments(z, j["nbr_mask"])
        mn, mx = jdense.dense_minmax(z, j["nbr_mask"], has)
        return z, mean, std, deg, mn, mx

    x = torch.from_numpy(h).requires_grad_(True)
    outs = port(x)
    jouts, vjp = jax.vjp(jfn, jnp.asarray(h))
    rng = np.random.default_rng(9)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    cots[3] = np.zeros_like(cots[3])  # deg: piecewise constant
    torch.autograd.backward(
        [o for i, o in enumerate(outs) if i != 3],
        [torch.from_numpy(c).to(o.dtype) for i, (c, o) in enumerate(zip(cots, outs)) if i != 3],
    )
    (jgrad,) = vjp(tuple(jnp.asarray(c).astype(o.dtype) for c, o in zip(cots, jouts)))
    return outs, x.grad, jouts, jgrad


def pytest_dense_ops_match_jax_forward_and_vjp():
    lists, n = _lists(3)
    h = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)
    outs, grad, jouts, jgrad = _ops_case(lists, h)
    assert not lists["nbr_mask"][n - 5 : n - 1].any()  # receivers without edges
    for name, o, jo in zip(("z", "mean", "std", "deg", "min", "max"), outs, jouts):
        assert o.dtype == torch.float32 and jo.dtype == jnp.float32, name
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=OP_RTOL, atol=OP_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=OP_RTOL, atol=OP_ATOL)


def pytest_dense_minmax_splits_tied_gradients_as_jax():
    """Every message of a receiver is one of two values, so the max and the
    min are each tied among several slots: both split the cotangent evenly
    among them (``torch.max(dim)`` would give it all to one)."""
    lists, n = _lists(5, padded=False)
    h = np.random.default_rng(6).integers(0, 2, (n, 4)).astype(np.float32)
    outs, grad, jouts, jgrad = _ops_case(lists, h)
    nbr = torch.from_numpy(lists["nbr_idx"]).long()
    m = torch.from_numpy(lists["nbr_mask"])
    z = torch.from_numpy(h)[nbr]
    ties = ((z == z.amax(1, keepdim=True)) & m[..., None]).sum(1)
    assert int(ties.max()) >= 3  # real ties, several slots deep
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=OP_RTOL, atol=OP_ATOL)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=OP_RTOL, atol=OP_ATOL)

    # the split itself: one receiver, three slots tied at the max
    x = torch.tensor([[1.0], [2.0], [2.0], [2.0]], requires_grad=True)
    lists = dense.build_neighbor_lists(np.array([0, 1, 2, 3]), np.zeros(4, int), None, 4, 4, 1)
    t = {k: torch.from_numpy(v) for k, v in lists.items()}
    z = dense.gather_neighbors(x, t["nbr_idx"], t["rev_idx"], t["rev_mask"])
    has = t["nbr_mask"].any(1, keepdim=True)
    dense.dense_minmax(z, t["nbr_mask"], has)[1][0, 0].backward()
    np.testing.assert_allclose(x.grad.numpy().ravel(), [0.0, 1 / 3, 1 / 3, 1 / 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def pytest_dense_sum_and_aggregate_to_senders_match_jax(dtype):
    """Forward and ``jax.vjp`` of both (``aggregate_to_senders``'s backward
    is a gather through ``nbr_idx``, masked); bf16 values on a 1/8 grid,
    where every sum is exact, agree to the bit."""
    lists, n = _lists(12)
    t = {k: torch.from_numpy(v) for k, v in lists.items()}
    j = {k: jnp.asarray(v) for k, v in lists.items()}
    k_in = lists["nbr_idx"].shape[1]
    rng = np.random.default_rng(13)
    h = (rng.integers(-16, 17, (n, k_in, 3)) / 8.0).astype(np.float32)
    g_sum, g_snd = ((rng.integers(-16, 17, (n, 3)) / 8.0).astype(np.float32) for _ in range(2))
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16" else (torch.float32, jnp.float32)

    def jfn(x):
        return (jdense.dense_sum(x, j["nbr_mask"]),
                jdense.aggregate_to_senders(x, j["nbr_idx"], j["nbr_mask"], j["rev_idx"],
                                            j["rev_mask"]))

    jouts, vjp = jax.vjp(jfn, jnp.asarray(h).astype(jdt))
    (jgrad,) = vjp((jnp.asarray(g_sum).astype(jdt), jnp.asarray(g_snd).astype(jdt)))
    x = torch.from_numpy(h).to(tdt).requires_grad_(True)
    outs = (dense.dense_sum(x, t["nbr_mask"]),
            dense.aggregate_to_senders(x, t["nbr_idx"], t["nbr_mask"], t["rev_idx"],
                                       t["rev_mask"]))
    assert type(outs[1].grad_fn).__name__ == "_AggregateToSendersBackward"
    torch.autograd.backward(outs, [torch.from_numpy(g).to(tdt) for g in (g_sum, g_snd)])
    for got, want in zip(outs + (x.grad,), jouts + (jgrad,)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                                   rtol=OP_RTOL, atol=OP_ATOL)
    # the sum at the senders equals index_add_ of every real slot at its sender
    real = np.nonzero(lists["nbr_mask"])
    want = torch.zeros((n, 3)).index_add_(
        0, torch.from_numpy(lists["nbr_idx"][real]).long(), torch.from_numpy(h[real]))
    torch.testing.assert_close(outs[1].detach().float(), want, rtol=OP_RTOL, atol=OP_ATOL)


def pytest_dense_ops_are_exact_on_a_bf16_grid():
    """bf16 values on a 1/8 grid: every sum, square and mean the ops take
    is exact in f32, so the port and JAX agree to the bit, the outputs at
    bf16 as in JAX and the K-axis sums in f32."""
    lists, n = _lists(7)
    h = (np.random.default_rng(8).integers(-16, 17, (n, 4)) / 8.0).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in lists.items()}
    j = {k: jnp.asarray(v) for k, v in lists.items()}
    x = torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
    z = dense.gather_neighbors(x, t["nbr_idx"], t["rev_idx"], t["rev_mask"])
    z = torch.where(t["nbr_mask"][..., None], z, 0.0)
    mean, _, deg, has = dense.dense_moments(z, t["nbr_mask"])
    mn, mx = dense.dense_minmax(z, t["nbr_mask"], has)
    (2.0 * z.float().sum() + mn.float().sum() + mx.float().sum()).backward()

    def jfn(xj):
        zj = jdense.gather_neighbors(xj, j["nbr_idx"], j["rev_idx"], j["rev_mask"])
        zj = jnp.where(j["nbr_mask"][..., None], zj, 0.0)
        mj, _, dj, hj = jdense.dense_moments(zj, j["nbr_mask"])
        a, b = jdense.dense_minmax(zj, j["nbr_mask"], hj)
        return 2.0 * zj.astype(jnp.float32).sum() + a.astype(jnp.float32).sum() + \
            b.astype(jnp.float32).sum(), (mj, dj, a, b)

    xj = jnp.asarray(h).astype(jnp.bfloat16)
    (_, (mj, dj, a, b)), gj = jax.value_and_grad(jfn, has_aux=True)(xj)
    for got, want in ((mean, mj), (deg, dj), (mn, a), (mx, b)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    assert x.grad.dtype == torch.bfloat16 and gj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(gj, np.float32))


def _dense_pair(graphs, cfg):
    """The host batches with the lists attached, on both sides."""
    jbatch = jdense.attach_neighbor_lists(
        jax.tree_util.tree_map(jnp.asarray, jax_collate(graphs, *PADS)))
    batch = dense.attach_neighbor_lists(collate_graphs(graphs, *PADS))
    for key in KEYS:
        np.testing.assert_array_equal(batch.extras[key].numpy(), np.asarray(jbatch.extras[key]))
    return jbatch, batch


def _loss(outputs):
    return sum((o * o).sum() for o in outputs)


@pytest.mark.parametrize("edge_dim", [None, 1])
def pytest_pna_dense_matches_jax_dense_and_port_fused(edge_dim):
    cfg = arch(edge_dim=edge_dim)
    graphs = samples(seed=2, with_edge_attr=edge_dim is not None)
    jbatch, batch = _dense_pair(graphs, cfg)
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables(jmodel, jbatch)

    def jloss(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jbatch, train=False)
        return _loss(out), out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    outs, grads = {}, {}
    for name, b in (("dense", batch), ("fused", dataclasses.replace(batch, extras={}))):
        model = create_model_config(cfg, device="cpu", aggregation="fused")
        load_flax_variables(model, variables)
        out = model(b)
        _loss(out).backward()
        outs[name] = [o.detach().numpy() for o in out]
        grads[name] = {k: p.grad.numpy() for k, p in model.named_parameters()}

    masks = (batch.graph_mask.numpy(), batch.node_mask.numpy())
    for m, got, fused, want in zip(masks, outs["dense"], outs["fused"], ref):
        np.testing.assert_allclose(got[m], np.asarray(want)[m], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[m], fused[m], rtol=BRANCH_RTOL, atol=BRANCH_ATOL)
    want_model = create_model_config(cfg, device="cpu")
    load_flax_variables(want_model, {"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                     "batch_stats": variables["batch_stats"]})
    for name, w in want_model.named_parameters():
        w = w.detach().numpy()
        np.testing.assert_allclose(grads["dense"][name], w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()), err_msg=name)
        np.testing.assert_allclose(grads["dense"][name], grads["fused"][name], rtol=BRANCH_RTOL,
                                   atol=BRANCH_ATOL * max(1.0, np.abs(w).max()), err_msg=name)


STACK_CASES = [
    # model_type, equivariance, edge_dim
    ("GIN", False, None),
    ("SAGE", False, None),
    ("SchNet", True, None),
    ("SchNet", False, 1),
    ("EGNN", True, 1),
    ("EGNN", False, None),
]


@pytest.mark.parametrize("model_type,equivariance,edge_dim", STACK_CASES)
def pytest_stack_dense_branch_matches_jax_dense_and_port_fused(model_type, equivariance,
                                                               edge_dim):
    cfg = family_arch(model_type, equivariance=equivariance, edge_dim=edge_dim)
    graphs = samples(seed=4, with_edge_attr=edge_dim is not None)
    jbatch, batch = _dense_pair(graphs, cfg)
    jmodel = jax_create_model_config(cfg)
    variables = family_variables(jmodel, jbatch)
    stats = {"batch_stats": variables["batch_stats"]} if "batch_stats" in variables else {}

    def jloss(params):
        out = jmodel.apply({"params": params, **stats}, jbatch, train=False)
        return _loss(out), out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    outs, grads = {}, {}
    for name, b in (("dense", batch), ("fused", dataclasses.replace(batch, extras={}))):
        model = create_model_config(cfg, device="cpu", aggregation="fused")
        load_flax_variables(model, variables)
        out = model(b)
        _loss(out).backward()
        outs[name] = [o.detach().numpy() for o in out]
        grads[name] = {k: p.grad.numpy() for k, p in model.named_parameters()}

    masks = (batch.graph_mask.numpy(), batch.node_mask.numpy())
    for m, got, fused, want in zip(masks, outs["dense"], outs["fused"], ref):
        np.testing.assert_allclose(got[m], np.asarray(want)[m], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[m], fused[m], rtol=BRANCH_RTOL, atol=BRANCH_ATOL)
    want_model = create_model_config(cfg, device="cpu")
    load_flax_variables(want_model, {"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                     **stats})
    for name, w in want_model.named_parameters():
        w = w.detach().numpy()
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(grads["dense"][name], w, rtol=RTOL, atol=ATOL * scale,
                                   err_msg=name)
        np.testing.assert_allclose(grads["dense"][name], grads["fused"][name],
                                   rtol=BRANCH_RTOL, atol=BRANCH_ATOL * scale, err_msg=name)


def pytest_gather_backward_is_the_reverse_gather():
    """No scatter in the dense gather's backward: autograd records the
    Function's own rule, which equals ``index_add_``'s result."""
    lists, n = _lists(11)
    t = {k: torch.from_numpy(v) for k, v in lists.items()}
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    z = dense.gather_neighbors(x, t["nbr_idx"], t["rev_idx"], t["rev_mask"])
    assert type(z.grad_fn).__name__ == "_GatherNeighborsBackward"
    g = torch.randn(z.shape, generator=torch.Generator().manual_seed(1))
    g = torch.where(t["nbr_mask"][..., None], g, 0.0)  # what every consumer leaves
    z.backward(g)
    want = torch.zeros_like(x).index_add_(0, t["nbr_idx"].reshape(-1).long(), g.reshape(-1, 5))
    torch.testing.assert_close(x.grad, want, rtol=OP_RTOL, atol=OP_ATOL)


def pytest_layouts_and_plans_carry_the_lists_as_jax():
    graphs = _graphs(GraphData, PLAN_SIZES, 0)
    jgraphs = _graphs(JaxGraphData, PLAN_SIZES, 0)
    plan = plan_from_samples(graphs, max_batch_graphs=4, need_neighbors=True)
    jplan = jax_plan_from_samples(jgraphs, max_batch_graphs=4, need_neighbors=True)
    assert plan.num_buckets == jplan.num_buckets
    for lay, jlay in zip(plan.layouts, jplan.layouts):
        assert (lay.need_neighbors, lay.k_in, lay.k_out, lay.n_pad, lay.e_pad) == (
            jlay.need_neighbors, jlay.k_in, jlay.k_out, jlay.n_pad, jlay.e_pad)
    plain = plan_from_samples(graphs, max_batch_graphs=4)
    assert not any(lay.need_neighbors for lay in plain.layouts)
    assert all((lay.k_in, lay.k_out) == (1, 1) for lay in plain.layouts)

    lay = plan.layouts[-1]
    take = [g for g in graphs if g.num_nodes > 8][:4]
    jlay = jax_loaders.BatchLayout(lay.n_pad, lay.e_pad, lay.g_pad, (), (),
                                   need_neighbors=True, k_in=lay.k_in, k_out=lay.k_out)
    want = jax_loaders.collate_for_layout([jgraphs[graphs.index(g)] for g in take], jlay,
                                          with_targets=False)
    got = collate_for_layout(take, lay)
    assert set(got.extras) == set(KEYS)
    for key in KEYS:
        assert got.extras[key].numpy().dtype == np.asarray(want.extras[key]).dtype, key
        np.testing.assert_array_equal(got.extras[key].numpy(), np.asarray(want.extras[key]),
                                      err_msg=key)
    assert collate_for_layout(take, BatchLayout(lay.n_pad, lay.e_pad, lay.g_pad)).extras == {}
    packed, _ = plan.pack(take, plan.num_buckets - 1)
    for key in KEYS:
        assert torch.equal(packed.extras[key], got.extras[key]), key


@pytest.mark.parametrize("cfg,env", [
    ({"model_type": "PNA", "hidden_dim": 256}, None),
    ({"model_type": "PNA", "hidden_dim": 64}, None),
    ({"model_type": "GIN", "hidden_dim": 128}, None),
    ({"model_type": "SAGE", "hidden_dim": 256}, None),
    ({"model_type": "SchNet", "hidden_dim": 512}, None),
    ({"model_type": "CGCNN", "input_dim": 64, "hidden_dim": 8}, None),
    ({"model_type": "CGCNN", "input_dim": 65}, None),
    ({"model_type": "PNA", "hidden_dim": 256, "dense_aggregation": False}, None),
    ({"model_type": "GIN", "hidden_dim": 8, "dense_aggregation": True}, None),
    ({"model_type": "PNA", "hidden_dim": 256, "partition_axis": "graph"}, None),
    ({"model_type": "PNA", "hidden_dim": 8}, "dense"),
    ({"model_type": "PNA", "hidden_dim": 256, "dense_aggregation": True}, "fused"),
])
def pytest_dense_decision_matches_jax(monkeypatch, tmp_path, cfg, env):
    """The static policy and the layout rule, with ``HYDRAGNN_AGG`` first.
    The JAX side's measured cache points at an empty directory, so its
    static tier decides, as the port's only tier does."""
    monkeypatch.setenv("HYDRAGNN_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    monkeypatch.delenv("HYDRAGNN_AGG", raising=False)
    if env is not None:
        monkeypatch.setenv("HYDRAGNN_AGG", env)
    assert autotune.env_force() == jax_autotune.env_force()
    assert autotune.auto_dense_aggregation(cfg) == jax_autotune.auto_dense_aggregation(cfg)
    assert autotune.static_aggregation_choice(cfg) == jax_autotune.static_aggregation_choice(cfg)
    assert needs_dense_neighbors(cfg) == jax_loaders.needs_dense_neighbors(cfg)
    assert autotune.DENSE_AUTO_MIN_HIDDEN == jax_autotune.DENSE_AUTO_MIN_HIDDEN
    assert autotune.DENSE_AUTO_MAX_INPUT_DIM == jax_autotune.DENSE_AUTO_MAX_INPUT_DIM


def pytest_the_lists_travel_in_the_one_staged_buffer():
    batch = dense.attach_neighbor_lists(collate_graphs(samples(seed=1), *PADS))
    moved = batch.to("meta")
    assert set(moved.extras) == set(KEYS)
    for key in KEYS:
        assert (moved.extras[key].device.type, moved.extras[key].dtype, moved.extras[key].shape) == (
            "meta", batch.extras[key].dtype, batch.extras[key].shape), key
    assert batch.with_extras({}).extras == batch.extras
    assert collate_graphs(samples(seed=1), *PADS).extras == {}


@pytest.mark.parametrize("model_type", ["GIN", "SAGE", "SchNet", "EGNN"])
def pytest_stacks_without_a_dense_branch_refuse_the_lists(model_type):
    """Every ported stack now takes its dense branch for a batch that
    carries the lists, as the JAX package's does; a stack without one
    (``dense_branch`` False, as a stack ported later starts) refuses such a
    batch, since ignoring the lists would compute on a path the JAX
    package does not take."""
    batch = dense.attach_neighbor_lists(collate_graphs(samples(), *PADS))
    model = create_model_config(family_arch(model_type), device="cpu")
    assert model.dense_branch
    with torch.inference_mode():
        model(batch)
    without = type("NoDenseBranch", (type(model),), {"dense_branch": False})
    model.__class__ = without
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(batch)
    with torch.inference_mode():
        model(dataclasses.replace(batch, extras={}))
