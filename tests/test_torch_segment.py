"""Port parity: segment sum and segment moments (K1, K2) and the segment
ops of ``graph/segment.py``, against the JAX package on the CPU.

The Pallas side runs in interpret mode, as the JAX package's own tests run
it; the port's side runs its plain versions (CPU tensors). Every row is
compared, padding included. Tolerance: rtol 1e-5, atol 1e-6 (f32 sums of
the same values in a different order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.graph import segment as jax_segment
from hydragnn_tpu.ops import segment_moments as jax_segment_moments
from hydragnn_tpu.ops import segment_sum_onehot as jax_segment_sum

from hydragnn_tpu_torch.graph import segment as port_segment
from hydragnn_tpu_torch.ops import segment_kernels

RTOL, ATOL = 1e-5, 1e-6


def _case(e, d, s, seed):
    """Data and ids with duplicates, ids past both ends, and (with s large
    enough) empty segments."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(0, max(s // 2, 1), e).astype(np.int32)  # upper half empty
    ids[::7] = ids[0]  # heavy duplicates
    ids[1] = s  # one past the end
    ids[2] = -1  # negative
    ids[3] = s + 100
    return data, ids


CASES = [(40, 1, 12, 0), (57, 16, 10, 1), (300, 16, 33, 2), (5, 1, 4, 3)]


@pytest.mark.parametrize("e,d,s,seed", CASES)
def pytest_segment_sum_matches_pallas(e, d, s, seed):
    data, ids = _case(e, d, s, seed)
    ref = np.asarray(jax_segment_sum(jnp.asarray(data), jnp.asarray(ids), s, interpret=True))
    got = segment_kernels.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    assert got.shape == (s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert not got[s // 2 + 1 :].any()  # empty segments stay zero


@pytest.mark.parametrize("e,d,s,seed", CASES)
def pytest_segment_moments_matches_pallas(e, d, s, seed):
    data, ids = _case(e, d, s, seed)
    ref = jax_segment_moments(jnp.asarray(data), jnp.asarray(ids), s, interpret=True)
    got = segment_kernels.segment_moments(torch.from_numpy(data), torch.from_numpy(ids), s)
    for name, r, g in zip(("sum", "count", "sq"), ref, got):
        assert tuple(g.shape) == tuple(np.asarray(r).shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)
    # the count is unweighted over in-range ids
    in_range = ids[(ids >= 0) & (ids < s)]
    np.testing.assert_array_equal(got[1][:, 0].numpy(), np.bincount(in_range, minlength=s))


def pytest_segment_kernels_reject_what_the_kernel_does_not_take():
    data = torch.zeros((4, 2))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        segment_kernels.segment_sum(data.double(), ids, 3)
    with pytest.raises(TypeError):
        segment_kernels.segment_sum(data, ids.long(), 3)
    with pytest.raises(ValueError):
        segment_kernels.segment_moments(data[:, 0], ids, 3)
    with pytest.raises(ValueError):
        segment_kernels.segment_sum(data, ids[:3], 3)


@pytest.mark.parametrize("d", [1, 16])
def pytest_segment_minmax_fused_matches_jax(d):
    data, ids = _case(60, d, 20, 5)
    ids = np.clip(ids, 0, 19)  # the XLA scatter's contract is in-range ids
    ref_mn, ref_mx = jax_segment.segment_minmax_fused(jnp.asarray(data), jnp.asarray(ids), 20)
    mn, mx = port_segment.segment_minmax_fused(torch.from_numpy(data), torch.from_numpy(ids), 20)
    np.testing.assert_allclose(mn.numpy(), np.asarray(ref_mn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mx.numpy(), np.asarray(ref_mx), rtol=RTOL, atol=ATOL)
    # with a precomputed non-empty mask that hides segment 0
    has = np.bincount(ids, minlength=20)[:, None] > 0
    has[0] = False
    ref_mn, ref_mx = jax_segment.segment_minmax_fused(
        jnp.asarray(data), jnp.asarray(ids), 20, has=jnp.asarray(has)
    )
    mn, mx = port_segment.segment_minmax_fused(
        torch.from_numpy(data), torch.from_numpy(ids), 20, has=torch.from_numpy(has)
    )
    np.testing.assert_allclose(mn.numpy(), np.asarray(ref_mn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mx.numpy(), np.asarray(ref_mx), rtol=RTOL, atol=ATOL)


def pytest_segment_sum_bf16_contract_matches_jax():
    """bf16 in -> f32 accumulate -> bf16 back. Values on a 1/8 grid sum
    exactly in f32, so both sides round the same sum to bf16."""
    rng = np.random.default_rng(7)
    data = (rng.integers(-64, 64, (50, 16)) / 8.0).astype(np.float32)
    ids = rng.integers(0, 9, 50).astype(np.int32)
    ref = jax_segment.segment_sum(jnp.asarray(data, jnp.bfloat16), jnp.asarray(ids), 9)
    got = port_segment.segment_sum(torch.from_numpy(data).to(torch.bfloat16), torch.from_numpy(ids), 9)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("weighted", [False, True])
def pytest_segment_count_and_moments_fused_match_jax(weighted):
    data, ids = _case(45, 16, 11, 9)
    ids = np.clip(ids, 0, 10)
    w = (np.arange(45) % 3 != 0) if weighted else None
    ref_cnt = jax_segment.segment_count(
        jnp.asarray(ids), 11, None if w is None else jnp.asarray(w, jnp.float32)
    )
    got_cnt = port_segment.segment_count(
        torch.from_numpy(ids), 11, None if w is None else torch.from_numpy(w)
    )
    np.testing.assert_allclose(got_cnt.numpy(), np.asarray(ref_cnt), rtol=RTOL, atol=ATOL)
    ref = jax_segment.segment_moments_fused(
        jnp.asarray(data), jnp.asarray(ids), 11, None if w is None else jnp.asarray(w)
    )
    got = port_segment.segment_moments_fused(
        torch.from_numpy(data), torch.from_numpy(ids), 11, None if w is None else torch.from_numpy(w)
    )
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
