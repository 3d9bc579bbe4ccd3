"""K1-K3 on the card: each CUDA kernel against its plain PyTorch version on
the same CUDA tensors, at small and main-path-like shapes; and a host batch
carried to the card in one copy.

Marked ``cuda``; each test skips inside itself when no card is present.
On the H100 run ``python -m pytest tests/test_torch_cuda_kernels.py -q
-p no:randomly --noconftest``: this file imports only the port, while the
suite's ``conftest.py`` imports the JAX package, which a machine set up
for the port alone does not have. Tolerance: ``atomic_tolerance`` —
``1e-5 * (max |partial sum| + 1)``, since atomics add in a run-dependent
order; ``z`` of K3 is elementwise and held to the same bound.
"""

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.graph import collate_graphs, pad_sizes_for
from hydragnn_tpu_torch.ops import (
    fused_gather_moments,
    fused_gather_moments_plain,
    segment_moments,
    segment_moments_plain,
    segment_sum,
    segment_sum_plain,
)
from hydragnn_tpu_torch.ops.segment_kernels import atomic_tolerance

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ids(e, s, seed, sorted_ids=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s, e).astype(np.int32)
    if sorted_ids:
        ids.sort()
    ids[-(e // 10):] = s - 1  # padded edges at the padding segment
    ids[0] = s + 3  # out of range: adds nothing
    return ids


SHAPES = [(300, 1, 40), (1000, 16, 77), (20000, 256, 1700)]


@pytest.mark.parametrize("e,d,s", SHAPES)
def pytest_segment_sum_kernel_matches_plain(card, e, d, s):
    rng = np.random.default_rng(e)
    data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(card)
    ids = torch.from_numpy(_ids(e, s, e, sorted_ids=True)).to(card)
    before = segment_sum.launches
    got = segment_sum(data, ids, s)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    ref = segment_sum_plain(data, ids, s)
    tol = atomic_tolerance(segment_sum_plain(data.abs(), ids, s))
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("e,d,s", SHAPES)
def pytest_segment_moments_kernel_matches_plain(card, e, d, s):
    rng = np.random.default_rng(e + 1)
    data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(card)
    ids = torch.from_numpy(_ids(e, s, e + 1)).to(card)
    got = segment_moments(data, ids, s)
    torch.cuda.synchronize()
    ref = segment_moments_plain(data, ids, s)
    abs_sq = segment_sum_plain(torch.cat([data.abs(), data * data], 1), ids, s)
    tol = atomic_tolerance(abs_sq)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= tol
    assert torch.equal(got[1], ref[1])  # counts are small integers: exact


@pytest.mark.parametrize("e,d,s", SHAPES)
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_fused_gather_moments_kernel_matches_plain(card, e, d, s, with_ze):
    rng = np.random.default_rng(e + 2)
    yj = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(card)
    snd = torch.from_numpy(_ids(e, s, e + 3)).to(card)
    rcv = torch.from_numpy(_ids(e, s, e + 4)).to(card)
    mask = torch.from_numpy(np.arange(e) < e - e // 10).to(card)
    ze = (
        torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(card)
        if with_ze else None
    )
    got = fused_gather_moments(yj, snd, rcv, s, mask, ze=ze)
    torch.cuda.synchronize()
    ref = fused_gather_moments_plain(yj, snd, rcv, s, mask, ze=ze)
    z = ref[3]
    tol = atomic_tolerance(segment_sum_plain(torch.cat([z.abs(), z * z], 1), rcv, s))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= tol


def pytest_cuda_kernels_are_forward_only(card):
    data = torch.zeros((8, 4), device=card, requires_grad=True)
    ids = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        segment_sum(data, ids, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        segment_moments(data, ids, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_gather_moments(data, ids, ids, 2, ids > 0)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum(torch.zeros((4, 8), device=card).t(), ids, 2)


def pytest_host_batch_reaches_the_card_in_one_buffer(card):
    rng = np.random.default_rng(0)

    class _S:
        pass

    graphs = []
    for n in (5, 9, 7):
        g = _S()
        g.x = rng.random((n, 1)).astype(np.float32)
        g.pos = rng.random((n, 3)).astype(np.float32)
        g.edge_index = np.stack([np.arange(n), (np.arange(n) + 1) % n]).astype(np.int64)
        g.edge_attr = rng.random((n, 2)).astype(np.float32)
        graphs.append(g)
    host = collate_graphs(graphs, *pad_sizes_for(9, 9, 3))
    moved = host.to(card)
    torch.cuda.synchronize()
    ptrs = set()
    for name in host.__dataclass_fields__:
        h, d = getattr(host, name), getattr(moved, name)
        assert d.device.type == "cuda" and d.dtype == h.dtype and d.shape == h.shape, name
        assert torch.equal(d.cpu(), h), name
        ptrs.add(d.untyped_storage().data_ptr())
    assert len(ptrs) == 1  # every field is a view of the one device buffer
