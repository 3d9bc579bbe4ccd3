"""The library call ``chip_smoke.py`` holds K4 and K5 against computes
their function: ``torch.sparse.mm`` of the CSR adjacency that
``chip_smoke.sparse_yardstick`` builds, against ``fused_gather_sum_plain``
and ``fused_gather_mean_plain`` on the CPU, so that the smoke's
``library_ms`` compares like with like.

The edges hold what the kernels' contract covers: duplicate receivers,
masked edges (the padding at the last node, and masked real edges), an
out-of-range sender (gathers a zero row, yet K5 counts it) and
out-of-range receivers (add nothing). Tolerance: rtol 1e-5, atol 1e-6
(two f32 sums in another order); the counts are small integers, held
exactly.
"""

import numpy as np
import pytest
import torch

from chip_smoke import sparse_yardstick
from hydragnn_tpu_torch.ops import fused_gather_mean_plain, fused_gather_sum_plain

N, E_REAL, E_PAD = 29, 90, 112


def _case(d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32)
    x[N - 1] = 0.0  # the padding node
    senders = np.full(E_PAD, N - 1, np.int32)
    receivers = np.full(E_PAD, N - 1, np.int32)
    senders[:E_REAL] = rng.integers(0, N - 1, E_REAL)
    receivers[:E_REAL] = rng.integers(0, N - 1, E_REAL)
    receivers[:12] = 3  # a run of duplicates
    senders[5] = N + 7  # out of range: gathers a zero row
    senders[6] = -2
    receivers[7] = N  # out of range: adds nothing
    receivers[8] = -1
    mask = np.zeros(E_PAD, bool)
    mask[:E_REAL] = True
    mask[20:26] = False  # masked real edges
    return [torch.from_numpy(a) for a in (x, senders, receivers, mask)]


@pytest.mark.parametrize("d", [1, 5, 16])
@pytest.mark.parametrize("kernel", ["fused_gather_sum", "fused_gather_mean"])
def pytest_sparse_mm_yardstick_computes_the_kernel_function(kernel, d):
    x, senders, receivers, mask = _case(d, seed=d)
    count = kernel == "fused_gather_mean"
    a, xs = sparse_yardstick(x, senders, receivers, N, mask, count=count)
    assert a.layout == torch.sparse_csr
    got = torch.sparse.mm(a, xs)
    if count:
        mean, deg = fused_gather_mean_plain(x, senders, receivers, N, mask)
        assert got.shape == (N, d + 1)
        assert torch.equal(got[:, d:], deg)
        # the out-of-range senders' edges count at their receivers
        assert float(deg.sum()) == float(mask[(receivers >= 0) & (receivers < N)].sum())
        want = mean * torch.clamp(deg, min=1.0)
        got = got[:, :d]
    else:
        want = fused_gather_sum_plain(x, senders, receivers, N, mask)
    assert got.shape == want.shape == (N, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
