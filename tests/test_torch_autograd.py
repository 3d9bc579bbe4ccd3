"""Port parity of the gradients: the backward rules of K1-K7, the min/max
pass, the losses and ``MaskedBatchNorm`` in training mode, each against the
JAX package on the same inputs (numpy seeds).

- K1 ``segment_sum_vjp``, K2 ``segment_moments_vjp`` and K3
  ``fused_gather_moments_vjp`` against ``jax.vjp`` of
  ``segment_sum_onehot``, ``segment_moments`` and ``fused_gather_moments``
  (the Pallas kernels in interpret mode), with out-of-range ids, padded
  edges, the cotangent of K3's per-edge ``z`` and ``ze``. On the CPU each
  Function runs the plain version forward and its own hand-written
  backward rule, which is what these tests hold (the ``grad_fn`` is the
  Function's).
- K4 ``fused_gather_sum_vjp``, K5 ``fused_gather_mean_vjp``, K6
  ``fused_gather_weighted_sum_vjp`` and K7 ``fused_egnn_edge_phase_vjp``
  against ``jax.vjp`` of the JAX package's wrappers over
  ``fused_message_reduce`` (ops ``copy``, ``copy_count``, ``mul``,
  ``egnn``; Pallas in interpret mode, its rule ``_fused_bwd``), with
  out-of-range senders and receivers and padded edges: every input's
  gradient, K7's ``pos`` and six parameters included, zero on the
  out-of-range rows, and finite where a padded edge has zero length.
- ``segment_minmax_fused`` with exact ties (duplicate edges give equal
  ``z`` at one receiver): both libraries split a max's gradient evenly.
- ``masked_error`` (mse, mae, rmse, smooth_l1) and
  ``masked_gaussian_nll``: values and gradients.
- ``MaskedBatchNorm`` in training mode: output, gradients and the running
  statistics, against flax's ``apply(..., mutable=["batch_stats"])``.

Tolerance: rtol 1e-4, atol 1e-5 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import segment_minmax_fused as jax_segment_minmax_fused
from hydragnn_tpu.models.common import MaskedBatchNorm as JaxMaskedBatchNorm
from hydragnn_tpu.models.common import masked_error as jax_masked_error
from hydragnn_tpu.models.common import masked_gaussian_nll as jax_masked_gaussian_nll
from hydragnn_tpu.ops import fused_egnn_edge_phase as jax_fused_egnn_edge_phase
from hydragnn_tpu.ops import fused_gather_mean as jax_fused_gather_mean
from hydragnn_tpu.ops import fused_gather_moments as jax_fused_gather_moments
from hydragnn_tpu.ops import fused_gather_sum as jax_fused_gather_sum
from hydragnn_tpu.ops import fused_gather_weighted_sum as jax_fused_gather_weighted_sum
from hydragnn_tpu.ops import segment_moments as jax_segment_moments
from hydragnn_tpu.ops import segment_sum_onehot as jax_segment_sum

from hydragnn_tpu_torch.graph import segment_minmax_fused
from hydragnn_tpu_torch.models.common import MaskedBatchNorm, masked_error, masked_gaussian_nll
from hydragnn_tpu_torch.ops import (
    fused_egnn_edge_phase_vjp,
    fused_gather_mean_vjp,
    fused_gather_moments,
    fused_gather_moments_vjp,
    fused_gather_sum_vjp,
    fused_gather_weighted_sum_vjp,
    launch_counts,
    segment_moments,
    segment_moments_vjp,
    segment_sum,
    segment_sum_vjp,
)

RTOL, ATOL = 1e-4, 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _ids(rng, e, s):
    """Receiver-like ids: duplicates, padded edges at the last segment, and
    out-of-range ids on both sides."""
    ids = rng.integers(0, s, e).astype(np.int32)
    ids[: e // 4] = ids[0]
    ids[-5:] = s - 1
    ids[3], ids[7], ids[11] = -1, s, s + 9
    return ids


@pytest.mark.parametrize("d", [1, 5])
def pytest_segment_sum_vjp_matches_jax(d):
    rng = np.random.default_rng(d)
    e, s = 60, 9
    data = rng.standard_normal((e, d)).astype(np.float32)
    ids = _ids(rng, e, s)
    g = rng.standard_normal((s, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jax_segment_sum(x, jnp.asarray(ids), s, interpret=True),
                       jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))

    x = _t(data, grad=True)
    before = launch_counts()
    got = segment_sum_vjp(x, _t(ids), s)
    assert type(got.grad_fn).__name__ == "_SegmentSumBackward"
    _close(got.detach(), out)
    got.backward(_t(g))
    _close(x.grad, want)
    assert np.all(x.grad.numpy()[[3, 7, 11]] == 0.0)  # out of range: exactly zero
    assert launch_counts() == before  # the CPU runs the plain version


@pytest.mark.parametrize("d", [1, 6])
def pytest_segment_moments_vjp_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    e, s = 70, 11
    data = rng.standard_normal((e, d)).astype(np.float32)
    ids = _ids(rng, e, s)
    g_sum = rng.standard_normal((s, d)).astype(np.float32)
    g_cnt = rng.standard_normal((s, 1)).astype(np.float32)  # no gradient either side
    g_sq = rng.standard_normal((s, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jax_segment_moments(x, jnp.asarray(ids), s, interpret=True),
                       jnp.asarray(data))
    (want,) = vjp(tuple(jnp.asarray(a) for a in (g_sum, g_cnt, g_sq)))

    x = _t(data, grad=True)
    got = segment_moments_vjp(x, _t(ids), s)
    assert type(got[0].grad_fn).__name__ != "_SegmentMomentsBackward"  # a view of it
    (parent, _), = got[0].grad_fn.next_functions
    assert type(parent).__name__ == "_SegmentMomentsBackward"
    for a, b in zip(got, out):
        _close(a.detach(), b)
    torch.autograd.backward(got, [_t(g_sum), _t(g_cnt), _t(g_sq)])
    _close(x.grad, want)
    assert np.all(x.grad.numpy()[[3, 7, 11]] == 0.0)


def _moments_case(rng, n, e, d, with_ze):
    yj = rng.standard_normal((n, d)).astype(np.float32)
    snd = rng.integers(0, n - 1, e).astype(np.int32)
    rcv = _ids(rng, e, n)
    snd[-5:] = n - 1  # padded edges: the padding node, mask 0
    snd[5], snd[9] = -2, n + 3  # out-of-range senders gather zero, add nothing
    mask = np.ones(e, bool)
    mask[-5:] = False
    ze = rng.standard_normal((e, d)).astype(np.float32) if with_ze else None
    return yj, snd, rcv, mask, ze


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_fused_gather_moments_vjp_matches_jax(d, with_ze):
    rng = np.random.default_rng(20 + d + 2 * with_ze)
    n, e = 13, 80
    yj, snd, rcv, mask, ze = _moments_case(rng, n, e, d, with_ze)
    cot = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((n, d), (n, 1), (n, d), (e, d))]  # s, cnt, sq, z

    def jfn(y, z_e):
        return jax_fused_gather_moments(y, jnp.asarray(snd), jnp.asarray(rcv), n,
                                        jnp.asarray(mask), ze=z_e, interpret=True)

    args = (jnp.asarray(yj), None if ze is None else jnp.asarray(ze))
    if ze is None:
        out, vjp = jax.vjp(lambda y: jfn(y, None), args[0])
    else:
        out, vjp = jax.vjp(jfn, *args)
    want = vjp(tuple(jnp.asarray(c) for c in cot))

    y = _t(yj, grad=True)
    z_e = None if ze is None else _t(ze, grad=True)
    got = fused_gather_moments_vjp(y, _t(snd), _t(rcv), n, _t(mask), ze=z_e)
    assert type(got[3].grad_fn).__name__ == "_FusedGatherMomentsBackward"
    for a, b in zip(got, out):
        _close(a.detach(), b)
    torch.autograd.backward(got, [_t(c) for c in cot])
    _close(y.grad, want[0])
    if ze is not None:
        _close(z_e.grad, want[1])
        assert np.all(z_e.grad.numpy()[-5:] == 0.0)  # masked edges


def pytest_fused_gather_moments_vjp_without_z_cotangent():
    """Only the statistics reach the loss (no min/max pass): ``g_z`` is
    absent, and the rule uses the reduced cotangents alone."""
    rng = np.random.default_rng(31)
    n, e, d = 9, 40, 3
    yj, snd, rcv, mask, _ = _moments_case(rng, n, e, d, False)
    w = rng.standard_normal((n, d)).astype(np.float32)

    def jloss(y):
        s, _, sq, _ = jax_fused_gather_moments(y, jnp.asarray(snd), jnp.asarray(rcv), n,
                                               jnp.asarray(mask), interpret=True)
        return jnp.sum(s * w) + jnp.sum(sq)

    want = jax.grad(jloss)(jnp.asarray(yj))
    y = _t(yj, grad=True)
    s, _, sq, _ = fused_gather_moments_vjp(y, _t(snd), _t(rcv), n, _t(mask))
    ((s * _t(w)).sum() + sq.sum()).backward()
    _close(y.grad, want)


@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("op", ["copy", "copy_count", "mul"])
def pytest_fused_gather_rules_match_jax(op, d):
    """K4, K5 and K6's rules: ``x``'s (``h``'s and ``w``'s) gradient; an
    out-of-range sender's edge gives nothing back, an out-of-range
    receiver's cotangent reads zero, a masked edge adds nothing."""
    rng = np.random.default_rng(40 + d + 3 * len(op))
    n, e = 13, 80
    x, snd, rcv, mask, _ = _moments_case(rng, n, e, d, False)
    w = rng.standard_normal((e, d)).astype(np.float32) * mask[:, None]
    g = rng.standard_normal((n, d)).astype(np.float32)
    g_deg = rng.standard_normal((n, 1)).astype(np.float32)  # no gradient either side
    ids = (jnp.asarray(snd), jnp.asarray(rcv))
    if op == "copy":
        jfn = lambda a: jax_fused_gather_sum(a, *ids, n, jnp.asarray(mask), interpret=True)  # noqa: E731
        fn, args, cots = fused_gather_sum_vjp, (x,), (g,)
    elif op == "copy_count":
        jfn = lambda a: jax_fused_gather_mean(a, *ids, n, jnp.asarray(mask), interpret=True)  # noqa: E731
        fn, args, cots = fused_gather_mean_vjp, (x,), (g, g_deg)
    else:
        jfn = lambda a, b: jax_fused_gather_weighted_sum(a, b, *ids, n, interpret=True)  # noqa: E731
        fn, args, cots = fused_gather_weighted_sum_vjp, (x, w), (g,)
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1 else jnp.asarray(cots[0]))

    inputs = [_t(a, grad=True) for a in args]
    if op == "mul":
        got = fn(*inputs, _t(snd), _t(rcv), n)
    else:
        got = fn(*inputs, _t(snd), _t(rcv), n, _t(mask))
    got = got if isinstance(got, tuple) else (got,)
    out = out if isinstance(out, tuple) else (out,)
    assert type(got[0].grad_fn).__name__.startswith("_FusedGather")
    for a, b in zip(got, out):
        _close(a.detach(), b)
    torch.autograd.backward(got[:1], [_t(cots[0])])
    for t, wnt in zip(inputs, want):
        _close(t.grad, wnt)
    assert np.all(inputs[0].grad.numpy()[n - 1] == 0.0) or op == "mul"  # padded edges
    if op == "mul":
        dw = inputs[1].grad.numpy()
        assert np.all(dw[[5, 9]] == 0.0)  # out-of-range senders gather zero
        assert np.all(dw[[3, 7, 11]] == 0.0)  # out-of-range receivers read no cotangent


def _egnn_case(rng, n, e, h, coord):
    y_snd, snd, rcv, mask, ze = _moments_case(rng, n, e, h, True)
    y_rcv = rng.standard_normal((n, h)).astype(np.float32)
    pos = rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    pos[n - 1] = 0.0  # the padding node: padded edges have zero length
    rcv[-5:] = n - 1
    lim = 1.0 / np.sqrt(h)
    shapes = [(h,), (h, h), (h,)] + ([(h, h), (h,), (h, 1)] if coord else [])
    params = [(rng.uniform(-lim, lim, s) * (2.0 if i < 3 else 1.0)).astype(np.float32)
              for i, s in enumerate(shapes)]
    return y_snd, y_rcv, pos, params, snd, rcv, mask, ze


@pytest.mark.parametrize("h", [4, 9])
@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_fused_egnn_rule_matches_jax(h, coord, with_ze):
    """K7's rule: the gradients of ``y_snd``, ``y_rcv``, ``pos`` (through
    both the senders' and the receivers' rows), ``ze`` and every edge
    parameter, against ``jax.vjp`` of the JAX wrapper; the padded edges'
    zero lengths give a finite (zero) gradient."""
    rng = np.random.default_rng(60 + h + 2 * coord + 4 * with_ze)
    n, e = 13, 80
    y_snd, y_rcv, pos, params, snd, rcv, mask, ze = _egnn_case(rng, n, e, h, coord)
    width = h + (4 if coord else 1)
    g = rng.standard_normal((n, width)).astype(np.float32)
    np_args = [y_snd, y_rcv, pos] + ([ze] if with_ze else []) + params
    k = 4 if with_ze else 3

    def jfn(*a):
        return jax_fused_egnn_edge_phase(
            a[0], a[1], a[2], list(a[k:]), jnp.asarray(snd), jnp.asarray(rcv), n,
            jnp.asarray(mask), ze=a[3] if with_ze else None, interpret=True)

    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in np_args))
    want = vjp(jnp.asarray(g))

    inputs = [_t(a, grad=True) for a in np_args]
    got = fused_egnn_edge_phase_vjp(
        inputs[0], inputs[1], inputs[2], inputs[k:], _t(snd), _t(rcv), n, _t(mask),
        ze=inputs[3] if with_ze else None)
    assert type(got.grad_fn).__name__ == "_FusedEgnnEdgePhaseBackward"
    _close(got.detach(), out)
    got.backward(_t(g))
    for name, t, wnt in zip(["y_snd", "y_rcv", "pos", "ze"][:k] + ["param"] * len(params),
                            inputs, want):
        assert bool(torch.isfinite(t.grad).all()), name
        scale = max(1.0, float(np.abs(np.asarray(wnt)).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)
    assert float(inputs[2].grad.abs().max()) > 0  # pos gets its gradient
    # the senders' rows of edges whose sender is out of range get nothing
    assert np.all(inputs[0].grad.numpy()[n - 1] == 0.0)


def pytest_vjp_functions_take_the_wrapper_without_grad():
    """Where autograd records nothing (serving, under ``inference_mode``)
    the ``*_vjp`` functions give the wrappers' results and record no
    Function node."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((10, 2)).astype(np.float32), grad=True)
    ids = _t(np.arange(10, dtype=np.int32) % 3)
    with torch.inference_mode():
        got = segment_sum_vjp(x, ids, 3)
        assert got.grad_fn is None
        torch.testing.assert_close(got, segment_sum(x, ids, 3), rtol=0, atol=0)
        got = segment_moments_vjp(x, ids, 3)
        assert got[0].grad_fn is None
        for a, b in zip(got, segment_moments(x, ids, 3)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        got = fused_gather_moments_vjp(x, ids, ids, 3, ids >= 0)
        assert got[3].grad_fn is None
        for a, b in zip(got, fused_gather_moments(x, ids, ids, 3, ids >= 0)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fill", [0.0, -1.0])
def pytest_segment_minmax_gradient_splits_ties_as_jax(fill):
    """Exact ties: duplicate rows at one receiver (a duplicate edge gives
    PNA two equal ``z``), a receiver whose rows are all equal, and an
    empty receiver that takes ``fill``."""
    rng = np.random.default_rng(7)
    s, d = 6, 3
    data = np.round(rng.standard_normal((24, d)), 1).astype(np.float32)
    ids = rng.integers(0, s - 1, 24).astype(np.int32)
    ids[ids == 3] = 1  # segment 3: rows 10-12 only (below)
    data[2] = 9.0  # the max of its segment in every column
    data[5], ids[5] = data[2], ids[2]  # an exact duplicate
    data[9], ids[9] = data[2], ids[2]  # three-way tie
    ids[[10, 11, 12]] = 3
    data[[10, 11, 12]] = 0.5  # every row of segment 3 equal
    ids[ids == 4] = 0  # segment 4 empty
    has = np.bincount(ids, minlength=s)[:, None] > 0
    g_mn = rng.standard_normal((s, d)).astype(np.float32)
    g_mx = rng.standard_normal((s, d)).astype(np.float32)

    def jfn(x):
        return jax_segment_minmax_fused(x, jnp.asarray(ids), s, fill=fill, has=jnp.asarray(has))

    out, vjp = jax.vjp(jfn, jnp.asarray(data))
    (want,) = vjp((jnp.asarray(g_mn), jnp.asarray(g_mx)))

    x = _t(data, grad=True)
    got = segment_minmax_fused(x, _t(ids), s, fill=fill, has=_t(has))
    for a, b in zip(got, out):
        _close(a.detach(), b)
    torch.autograd.backward(got, [_t(g_mn), _t(g_mx)])
    _close(x.grad, want)
    # three rows tied at a max share its cotangent in thirds; rows all
    # equal share both the min's and the max's
    grad = x.grad.numpy()
    np.testing.assert_allclose(grad[[2, 5, 9]], np.tile(g_mx[ids[2]] / 3.0, (3, 1)), rtol=1e-6)
    np.testing.assert_allclose(grad[[10, 11, 12]],
                               np.tile((g_mn[3] + g_mx[3]) / 3.0, (3, 1)), rtol=1e-6)


def _loss_case(seed, rows=12, d=3):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((rows, d + 1)).astype(np.float32) * 1.5
    target = rng.standard_normal((rows, d)).astype(np.float32)
    mask = rng.random(rows) > 0.3
    mask[0] = True
    pred[~mask] = np.nan  # garbage in padded rows must not leak in
    return pred, target, mask


@pytest.mark.parametrize("kind", ["mse", "mae", "rmse", "smooth_l1"])
def pytest_masked_error_matches_jax(kind):
    pred, target, mask = _loss_case(40)
    pred = pred[:, :-1]
    jf = lambda p: jax_masked_error(p, jnp.asarray(target), jnp.asarray(mask), kind)  # noqa: E731
    want, want_grad = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = _t(pred, grad=True)
    got = masked_error(p, _t(target), _t(mask), kind)
    got.backward()
    _close(got.detach(), want)
    _close(p.grad, want_grad)
    assert np.isfinite(p.grad.numpy()).all()


def pytest_masked_rmse_of_a_perfect_fit_has_a_zero_gradient():
    target = np.arange(6, dtype=np.float32).reshape(3, 2)
    p = _t(target.copy(), grad=True)
    got = masked_error(p, _t(target), _t(np.ones(3, bool)), "rmse")
    got.backward()
    assert float(got) == 0.0 and np.all(p.grad.numpy() == 0.0)
    with pytest.raises(ValueError, match="Unknown loss"):
        masked_error(p, _t(target), _t(np.ones(3, bool)), "huber")


def pytest_masked_gaussian_nll_matches_jax():
    pred, target, mask = _loss_case(41)
    pred[mask, -1] = np.where(np.arange(mask.sum()) % 3 == 0, -20.0, pred[mask, -1])  # clamped
    d = target.shape[1]

    def jf(p):
        return jax_masked_gaussian_nll(p[:, :d], p[:, d:].repeat(d, axis=1),
                                       jnp.asarray(target), jnp.asarray(mask))

    want, want_grad = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = _t(pred, grad=True)
    got = masked_gaussian_nll(p[:, :d], p[:, d:].repeat(1, d), _t(target), _t(mask))
    got.backward()
    _close(got.detach(), want)
    _close(p.grad, want_grad)


def pytest_masked_batchnorm_training_matches_flax():
    rng = np.random.default_rng(50)
    n, f = 20, 5
    x = (rng.standard_normal((n, f)) * 2.0 + 3.0).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-6:] = False
    x[~mask] = 1e3  # padding rows must not enter the statistics
    w_out = rng.standard_normal((n, f)).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
                   "bias": rng.standard_normal(f).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(f).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, f).astype(np.float32)},
    }
    bn = JaxMaskedBatchNorm(f)

    def jloss(params, xx):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          xx, jnp.asarray(mask), False, mutable=["batch_stats"])
        return jnp.sum(y * w_out), (y, mut["batch_stats"])

    (_, (want_y, want_stats)), (g_params, g_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    port = MaskedBatchNorm(f)
    with torch.no_grad():
        port.weight.copy_(_t(variables["params"]["scale"]))
        port.bias.copy_(_t(variables["params"]["bias"]))
        port.running_mean.copy_(_t(variables["batch_stats"]["mean"]))
        port.running_var.copy_(_t(variables["batch_stats"]["var"]))
    xt = _t(x, grad=True)
    y = port.train()(xt, _t(mask))
    (y * _t(w_out)).sum().backward()
    _close(y.detach(), want_y)
    _close(xt.grad, g_x)
    _close(port.weight.grad, g_params["scale"])
    _close(port.bias.grad, g_params["bias"])
    _close(port.running_mean, want_stats["mean"])
    _close(port.running_var, want_stats["var"])
    assert np.all(y.detach().numpy()[~mask] == 0.0)
    # eval mode reads the updated running statistics
    y_eval = port.eval()(xt.detach(), _t(mask))
    want_eval = bn.apply({"params": variables["params"], "batch_stats": want_stats},
                         jnp.asarray(x), jnp.asarray(mask), True)
    _close(y_eval, want_eval)
