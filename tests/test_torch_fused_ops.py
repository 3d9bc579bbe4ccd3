"""Port parity: K4-K7 (``fused_gather_sum``, ``fused_gather_mean``,
``fused_gather_weighted_sum``, ``fused_egnn_edge_phase``) against the JAX
package's fused Pallas kernel in interpret mode on the CPU.

Inputs come from a numpy seed: padded edges (mask 0, ids at the last node),
duplicate receivers, an out-of-range sender and receiver, and a tail of
edges whose ids are both out of range. Widths D = 1 and an odd D (K6 also
at its served D = 50). K7 runs
with and without the coordinate parameters and with and without ``ze``.
Tolerance: rtol 1e-5, atol 1e-6 for K4-K6; rtol 1e-4, atol 1e-5 for K7
(two H-term products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops import fused_egnn_edge_phase as jax_fused_egnn_edge_phase
from hydragnn_tpu.ops import fused_gather_mean as jax_fused_gather_mean
from hydragnn_tpu.ops import fused_gather_sum as jax_fused_gather_sum
from hydragnn_tpu.ops import fused_gather_weighted_sum as jax_fused_gather_weighted_sum

from hydragnn_tpu_torch.ops import (
    fused_egnn_edge_phase,
    fused_gather_mean,
    fused_gather_sum,
    fused_gather_weighted_sum,
    launch_counts,
)

RTOL, ATOL = 1e-5, 1e-6
EGNN_RTOL, EGNN_ATOL = 1e-4, 1e-5
N, E_REAL, E_PAD = 23, 70, 88


def _ids(rng, n=N, e_real=E_REAL, e_pad=E_PAD):
    senders = np.full(e_pad, n - 1, np.int32)
    receivers = np.full(e_pad, n - 1, np.int32)
    senders[:e_real] = rng.integers(0, n - 1, e_real)
    receivers[:e_real] = rng.integers(0, n - 1, e_real)
    receivers[: e_real // 3] = receivers[0]  # duplicates
    senders[1] = n + 5  # out-of-range sender: gathers a zero row
    receivers[2] = n  # out-of-range receiver: adds nothing
    senders[-4:] = n + 100  # a padded tail of out-of-range ids
    receivers[-4:] = 2**31 - 1
    mask = np.zeros(e_pad, bool)
    mask[:e_real] = True
    mask[-4:] = True  # masked in, yet reduced nowhere
    return senders, receivers, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, ref, rtol=RTOL, atol=ATOL):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [1, 5])
def pytest_fused_gather_sum_matches_pallas(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((N, d)).astype(np.float32)
    snd, rcv, mask = _ids(rng)
    ref = jax_fused_gather_sum(*_j(x, snd, rcv), N, jnp.asarray(mask), interpret=True)
    before = launch_counts()
    got = fused_gather_sum(*_t(x, snd, rcv), N, torch.from_numpy(mask))
    assert launch_counts() == before  # the CPU runs the plain version
    _close(got, ref)


@pytest.mark.parametrize("d", [1, 5])
def pytest_fused_gather_mean_matches_pallas(d):
    rng = np.random.default_rng(10 + d)
    x = rng.standard_normal((N, d)).astype(np.float32)
    snd, rcv, mask = _ids(rng)
    ref_mean, ref_deg = jax_fused_gather_mean(
        *_j(x, snd, rcv), N, jnp.asarray(mask), interpret=True
    )
    mean, deg = fused_gather_mean(*_t(x, snd, rcv), N, torch.from_numpy(mask))
    _close(mean, ref_mean)
    _close(deg, ref_deg)
    # the degree sums the mask: real edges at in-range receivers
    real = mask & (rcv >= 0) & (rcv < N)
    np.testing.assert_array_equal(deg[:, 0].numpy(), np.bincount(rcv[real], minlength=N))


@pytest.mark.parametrize("d", [1, 5, 50])  # 50: SchNet's served filters
def pytest_fused_gather_weighted_sum_matches_pallas(d):
    rng = np.random.default_rng(20 + d)
    h = rng.standard_normal((N, d)).astype(np.float32)
    snd, rcv, mask = _ids(rng)
    w = (rng.standard_normal((E_PAD, d)) * mask[:, None]).astype(np.float32)
    ref = jax_fused_gather_weighted_sum(*_j(h, w, snd, rcv), N, interpret=True)
    got = fused_gather_weighted_sum(*_t(h, w, snd, rcv), N)
    _close(got, ref)


def _egnn_case(seed, hidden, coord, with_ze):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    y_snd, y_rcv = f32(N, hidden), f32(N, hidden)
    pos = f32(N, 3, scale=2.0)
    pos[N - 1] = 0.0  # the padding node: padded edges have zero length
    lim = 1.0 / np.sqrt(hidden)
    params = [f32(hidden), f32(hidden, hidden, scale=lim), f32(hidden, scale=lim)]
    if coord:
        params += [f32(hidden, hidden, scale=lim), f32(hidden, scale=lim),
                   f32(hidden, 1, scale=lim)]
    snd, rcv, mask = _ids(rng)
    ze = f32(E_PAD, hidden) if with_ze else None
    return y_snd, y_rcv, pos, params, snd, rcv, mask, ze


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_fused_egnn_edge_phase_matches_pallas(coord, with_ze):
    hidden = 12
    y_snd, y_rcv, pos, params, snd, rcv, mask, ze = _egnn_case(
        30 + 2 * coord + with_ze, hidden, coord, with_ze
    )
    ref = jax_fused_egnn_edge_phase(
        *_j(y_snd, y_rcv, pos), _j(*params), *_j(snd, rcv), N, jnp.asarray(mask),
        ze=None if ze is None else jnp.asarray(ze), interpret=True,
    )
    got = fused_egnn_edge_phase(
        *_t(y_snd, y_rcv, pos), _t(*params), *_t(snd, rcv), N,
        torch.from_numpy(mask), ze=None if ze is None else torch.from_numpy(ze),
    )
    assert got.shape[1] == hidden + (4 if coord else 1)
    assert np.isfinite(got.numpy()).all()  # zero-length padded edges stay finite
    _close(got, ref, EGNN_RTOL, EGNN_ATOL)


def pytest_fused_ops_reject_bad_inputs():
    x = torch.zeros((5, 4))
    ids = torch.zeros(6, dtype=torch.int32)
    mask = torch.ones(6, dtype=torch.bool)
    for fn in (fused_gather_sum, fused_gather_mean):
        with pytest.raises(TypeError):
            fn(x.double(), ids, ids, 5, mask)
        with pytest.raises(TypeError):
            fn(x, ids.long(), ids, 5, mask)
        with pytest.raises(ValueError):
            fn(x, ids, ids, 5, mask[:4])
    with pytest.raises(TypeError):
        fused_gather_weighted_sum(x, torch.zeros((6, 3)), ids, ids, 5)
    params = [torch.zeros(4), torch.zeros((4, 4)), torch.zeros(4)]
    pos = torch.zeros((5, 3))
    with pytest.raises(TypeError):
        fused_egnn_edge_phase(x, x, pos[:, :2], params, ids, ids, 5, mask)
    with pytest.raises(TypeError):
        fused_egnn_edge_phase(x, x, pos, [params[0], torch.zeros((4, 3)), params[2]],
                              ids, ids, 5, mask)
    with pytest.raises(ValueError):
        fused_egnn_edge_phase(x, x, pos, params[:2], ids, ids, 5, mask)
    with pytest.raises(TypeError):
        fused_egnn_edge_phase(x, x, pos, params, ids, ids, 5, mask, ze=torch.zeros((6, 3)))
