"""Port parity: ``fused_gather_moments`` (K3) against the JAX package's
fused Pallas kernel in interpret mode on the CPU.

All four outputs are compared on every row, ``z`` included, with padded
edges (mask 0, ids pointing at the last node) and out-of-range senders and
receivers. Tolerance: rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops import fused_gather_moments as jax_fused_gather_moments

from hydragnn_tpu_torch.ops import fused_gather_moments

RTOL, ATOL = 1e-5, 1e-6


def _case(n, e_real, e_pad, d, seed, with_ze):
    rng = np.random.default_rng(seed)
    yj = rng.standard_normal((n, d)).astype(np.float32)
    senders = np.full(e_pad, n - 1, np.int32)
    receivers = np.full(e_pad, n - 1, np.int32)
    senders[:e_real] = rng.integers(0, n - 1, e_real)
    receivers[:e_real] = rng.integers(0, n - 1, e_real)
    receivers[: e_real // 3] = receivers[0]  # duplicates
    senders[1] = n + 5  # out-of-range sender: gathers a zero row
    receivers[2] = n  # out-of-range receiver: adds nothing
    mask = np.zeros(e_pad, bool)
    mask[:e_real] = True
    ze = rng.standard_normal((e_pad, d)).astype(np.float32) if with_ze else None
    return yj, senders, receivers, mask, ze


@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_fused_gather_moments_matches_pallas(d, with_ze):
    n, e_real, e_pad = 23, 70, 88
    yj, snd, rcv, mask, ze = _case(n, e_real, e_pad, d, seed=d + 10 * with_ze, with_ze=with_ze)
    ref = jax_fused_gather_moments(
        jnp.asarray(yj), jnp.asarray(snd), jnp.asarray(rcv), n, jnp.asarray(mask),
        ze=None if ze is None else jnp.asarray(ze), interpret=True,
    )
    got = fused_gather_moments(
        torch.from_numpy(yj), torch.from_numpy(snd), torch.from_numpy(rcv), n,
        torch.from_numpy(mask), ze=None if ze is None else torch.from_numpy(ze),
    )
    for name, r, g in zip(("sum", "count", "sq", "z"), ref, got):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    # count sums the mask: real edges only, at in-range receivers
    real = mask & (rcv >= 0) & (rcv < n)
    np.testing.assert_array_equal(got[1][:, 0].numpy(), np.bincount(rcv[real], minlength=n))


def pytest_fused_gather_moments_rejects_bad_inputs():
    yj = torch.zeros((5, 4))
    ids = torch.zeros(6, dtype=torch.int32)
    mask = torch.ones(6, dtype=torch.bool)
    with pytest.raises(TypeError):
        fused_gather_moments(yj.double(), ids, ids, 5, mask)
    with pytest.raises(TypeError):
        fused_gather_moments(yj, ids.long(), ids, 5, mask)
    with pytest.raises(TypeError):
        fused_gather_moments(yj, ids, ids, 5, mask, ze=torch.zeros((6, 3)))
