"""Port parity: ``fused_gather_moments`` (K3) against the JAX package's
fused Pallas kernel in interpret mode on the CPU.

All four outputs are compared on every row, ``z`` included, with padded
edges (mask 0, ids pointing at the last node) and out-of-range senders and
receivers, on random ids and on a batch laid out as the served ones
(``chip_smoke.make_graphs`` through ``collate_graphs``: each graph's edges
contiguous, the first half in runs of 6 senders, the second in runs of 6
receivers, padding edges at the end). Tolerance: rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops import fused_gather_moments as jax_fused_gather_moments
from hydragnn_tpu.ops import segment_moments as jax_segment_moments

from chip_smoke import make_graphs
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.ops import fused_gather_moments, segment_moments
from hydragnn_tpu_torch.ops.segment_kernels import moments_layout, moments_views

RTOL, ATOL = 1e-5, 1e-6


def _served_case(d, seed, with_ze):
    """A served-layout batch: 3 graphs of 8-12 atoms, 12 edges per atom,
    padded by 5 nodes and 37 edges (at the last node, mask 0)."""
    graphs = make_graphs(3, 12, 12, seed=seed)
    n = sum(g.x.shape[0] for g in graphs) + 5
    e = sum(g.edge_index.shape[1] for g in graphs) + 37
    batch = collate_graphs(graphs, n, e, len(graphs) + 1)
    rng = np.random.default_rng(seed)
    yj = rng.standard_normal((n, d)).astype(np.float32)
    ze = rng.standard_normal((e, d)).astype(np.float32) if with_ze else None
    return yj, batch.senders.numpy(), batch.receivers.numpy(), batch.edge_mask.numpy(), ze


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


@pytest.mark.parametrize("layout", ["random", "served"])
@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_fused_gather_moments_matches_pallas(d, with_ze, layout):
    seed = d + 10 * with_ze
    if layout == "served":
        yj, snd, rcv, mask, ze = _served_case(d, seed, with_ze)
    else:
        yj, snd, rcv, mask, ze = _case(23, 70, 88, d, seed=seed, with_ze=with_ze)
    n = yj.shape[0]
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


def pytest_moments_count_rules_differ_on_the_padding_node():
    """On a served batch K3 counts the mask (padding edges count 0) and K2
    every in-range id (the padding edges count at the padding node, as
    ``_onehot`` does): the two counts agree on every node but the last,
    where K2's is the number of padding edges. Both held against Pallas."""
    yj, snd, rcv, mask, _ = _served_case(8, seed=3, with_ze=False)
    n = yj.shape[0]
    pad_edges = int((~mask).sum())
    assert pad_edges > 0 and (rcv[~mask] == n - 1).all() and (rcv[mask] < n - 1).all()
    t = torch.from_numpy
    _, cnt3, _, z = fused_gather_moments(t(yj), t(snd), t(rcv), n, t(mask))
    _, cnt2, _ = segment_moments(z, t(rcv), n)
    ref3 = jax_fused_gather_moments(
        jnp.asarray(yj), jnp.asarray(snd), jnp.asarray(rcv), n, jnp.asarray(mask), interpret=True
    )[1]
    ref2 = jax_segment_moments(jnp.asarray(z.numpy()), jnp.asarray(rcv), n, interpret=True)[1]
    np.testing.assert_array_equal(cnt3.numpy(), np.asarray(ref3))
    np.testing.assert_array_equal(cnt2.numpy(), np.asarray(ref2))
    diff = (cnt2 - cnt3)[:, 0].numpy()
    assert np.flatnonzero(diff).tolist() == [n - 1]
    assert diff[n - 1] == pad_edges and cnt3[n - 1, 0] == 0


@pytest.mark.parametrize("d", [1, 3, 4, 50, 256])
def pytest_moments_layout_views_are_the_right_columns(d):
    """K2 and K3's packed row on the card: the views are the sum, count and
    square columns, and each part of the row starts 16 bytes apart from the
    row's start (16-byte atomics on the float4 path) when D % 4 == 0."""
    sq_off, cnt_off, ldo = moments_layout(d)
    assert d <= sq_off and sq_off + d <= cnt_off < ldo and ldo % 4 == 0
    if d % 4 == 0:
        assert sq_off == d and sq_off % 4 == 0 and cnt_off % 4 == 0
    rows = 3
    out = torch.arange(rows * ldo, dtype=torch.float32).reshape(rows, ldo)
    s, cnt, sq = moments_views(out, d)
    assert s.shape == sq.shape == (rows, d) and cnt.shape == (rows, 1)
    base = torch.arange(rows)[:, None] * ldo
    assert torch.equal(s, (base + torch.arange(d)).float())
    assert torch.equal(sq, (base + sq_off + torch.arange(d)).float())
    assert torch.equal(cnt, (base + cnt_off).float())
    assert (sq.storage_offset() * 4) % 16 == 0 and (cnt.storage_offset() * 4) % 16 == 0
