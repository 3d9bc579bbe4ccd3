"""K1-K7 on the card: each CUDA kernel against its plain PyTorch version on
the same CUDA tensors, at small and main-path-like shapes; and a host batch
carried to the card in one copy.

K4 and K5's kernel is held at D = 1, 3, 4, 50, 64, 65 and 256 on a batch
laid out as the served ones (padding edges at the end), on random ids, all
edges into one receiver, runs of receivers and senders that cross the ends
of a group's edges and of a tile, and out-of-range senders (in runs) and
receivers; on an unaligned node table (the scalar path), a float mask and
no edges at all. K5's degree is held exactly.

K6 (SchNet's filtered sum, the same kernel with a weight row per edge) is
held at D = 1, 3, 50, 51, 126 and 256 (single floats, float2 and float4
chunks) on the same five layouts, on 20000 edges (no multiple of any
tile), on a weight view 4 bytes past an 8-byte boundary (the scalar
path), and with no edges or no segments.

K3 and K2 (PNA's statistics) are held at D = 1, 3, 4, 50, 64, 256, 260
and 512 on a served batch and on sorted, random, all-equal, out-of-range
and tile-crossing runs of ids, with padding edges at the last row, K3 with
and without ``ze``, z compared on every edge, and each kernel's count held
exactly to its own rule; on unaligned views (the scalar path), a float
mask and no edges at all.

The backward rules of K1-K3 (``segment_sum_vjp``, ``segment_moments_vjp``,
``fused_gather_moments_vjp``) are held on the card against the same
Functions on the CPU (plain forward, the same rule): K1's on its id
patterns at D = 1, 3, 50 and 256 (a gather: exact); K3's and K2's on the
moments' id patterns at D = 1, 64 and 256 with and without ``ze``, the
cotangent of ``z`` included (``yj``'s gradient, summed at the senders
through K1, within ``atomic_tolerance`` of ``|dz|`` summed there;
elementwise gradients within ``1e-6 * (max |grad| + 1)``), and at the
main path's largest batch (n_pad 5768, e_pad 69120, hidden 256).

The backward rules of K4-K7 (``fused_gather_sum_vjp``,
``fused_gather_mean_vjp``, ``fused_gather_weighted_sum_vjp``,
``fused_egnn_edge_phase_vjp``) are held the same way: K4's and K5's (K4
with the ids swapped, K5's cotangent over ``max(deg, 1)`` first) on the
K4/K5 id patterns at D = 1, 64 and 256; K6's ``d_h`` (K6 swapped) on its
patterns at D = 1 to 256 and ``d_w`` (a product, exact up to one rounding);
K7's ``d_y_snd``, ``d_y_rcv``, ``d_pos`` (``pos`` requiring grad, padded
edges of zero length), ``d_ze`` and the six parameters at H = 8, 33, 128
and 256, within ``egnn_tolerance`` of each gradient.

K1's run reduction is held on the id patterns that stress it (all ids
equal; runs that cross a thread's, a block's and a tile's boundary; fully
unsorted; out-of-range ids in the middle of a run) at D = 1, 3, 50, 256
and 257 with 3001 rows, and on a view that is not 16-byte aligned (the
scalar path). K7's tile is held at H = 8, 33, 100, 128 and 256 with 1001
edges, with and without ``ze``, the coordinate parameters, and all edges
on one sender.

The dense branch's gather (``ops/dense_agg.gather_neighbors``, PyTorch
ops in a Function with the reverse-list backward) is held on the card
against the same Function on the CPU at the headline's ``[5768, 22, 256]``
in f32 and bf16, and one PNA dense bf16 training step against the exact
step within ``chip_smoke.BF16_FACTOR``'s bound.

Marked ``cuda``; each test skips inside itself when no card is present.
On the H100 run ``python -m pytest tests/test_torch_cuda_kernels.py -q
-p no:randomly --noconftest``: this file imports only the port, while the
suite's ``conftest.py`` imports the JAX package, which a machine set up
for the port alone does not have. Tolerance: ``atomic_tolerance`` —
``1e-5 * (max |partial sum| + 1)``, since atomics add in a run-dependent
order; ``z`` of K3 is elementwise and held to the same bound. K7 (two
H-term products per edge, summed in another order than PyTorch's matmul):
``egnn_tolerance``, ``1e-4 * (max |out| + 1)``.
"""

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.graph import collate_graphs, pad_sizes_for
from hydragnn_tpu_torch.ops import (
    fused_egnn_edge_phase,
    fused_egnn_edge_phase_plain,
    fused_egnn_edge_phase_vjp,
    fused_gather_mean,
    fused_gather_mean_plain,
    fused_gather_mean_vjp,
    fused_gather_moments,
    fused_gather_moments_plain,
    fused_gather_sum,
    fused_gather_sum_plain,
    fused_gather_sum_vjp,
    fused_gather_weighted_sum,
    fused_gather_weighted_sum_plain,
    fused_gather_weighted_sum_vjp,
    fused_gather_moments_vjp,
    segment_moments,
    segment_moments_plain,
    segment_moments_vjp,
    segment_sum,
    segment_sum_plain,
    segment_sum_vjp,
)
from hydragnn_tpu_torch.ops.fused_mp import egnn_tolerance
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


def _run_ids(e, s, pattern, seed):
    """Segment ids of length ``e`` into ``s`` segments, by pattern."""
    rng = np.random.default_rng(seed)
    if pattern == "all_equal":
        return np.full(e, s // 2, np.int32)
    if pattern == "unsorted":
        return rng.integers(0, s, e).astype(np.int32)
    # sorted runs whose lengths cross a thread's slice (8-32 rows), a
    # block's (4-128 rows at D=256) and any tile's boundary
    lengths = np.resize([1, 7, 33, 100, 300, 5, 64, 129], e)
    ids = np.repeat(np.arange(lengths.shape[0]) % s, lengths)[:e].astype(np.int32)
    if pattern == "out_of_range_mid_run":
        ids[20::37] = -1
        ids[45::101] = s + 5
    return ids


@pytest.mark.parametrize("d", [1, 3, 50, 256, 257])
@pytest.mark.parametrize("pattern", ["all_equal", "runs", "unsorted", "out_of_range_mid_run"])
def pytest_segment_sum_kernel_id_patterns(card, pattern, d):
    e, s = 3001, 40  # 3001 rows: no multiple of a slice, a block or a tile
    rng = np.random.default_rng(d)
    data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(card)
    ids = torch.from_numpy(_run_ids(e, s, pattern, d)).to(card)
    got = segment_sum(data, ids, s)
    torch.cuda.synchronize()
    ref = segment_sum_plain(data, ids, s)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= atomic_tolerance(segment_sum_plain(data.abs(), ids, s))


@pytest.mark.parametrize("d", [4, 256])
def pytest_segment_sum_kernel_unaligned_view(card, d):
    """A view 4 bytes past a 16-byte boundary takes the scalar path (or
    raises); it never gives a wrong sum."""
    e, s = 1001, 17
    rng = np.random.default_rng(d)
    flat = torch.from_numpy(rng.standard_normal(e * d + 1).astype(np.float32)).to(card)
    data = flat[1:].view(e, d).contiguous()
    assert data.data_ptr() % 16 != 0
    ids = torch.from_numpy(_run_ids(e, s, "runs", d)).to(card)
    got = segment_sum(data, ids, s)
    torch.cuda.synchronize()
    ref = segment_sum_plain(data, ids, s)
    assert float((got - ref).abs().max()) <= atomic_tolerance(segment_sum_plain(data.abs(), ids, s))


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


def _gather_case(card, e, d, s, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(card)
    snd = torch.from_numpy(_ids(e, s, seed + 1)).to(card)
    rcv = torch.from_numpy(_ids(e, s, seed + 2)).to(card)
    mask = torch.from_numpy(np.arange(e) < e - e // 10).to(card)
    return rng, x, snd, rcv, mask


@pytest.mark.parametrize("e,d,s", SHAPES + [(20000, 50, 1700)])
def pytest_fused_gather_sum_mean_kernels_match_plain(card, e, d, s):
    _, x, snd, rcv, mask = _gather_case(card, e, d, s, e + d)
    # partial sums are bounded by the segment sums of |message|
    tol = atomic_tolerance(fused_gather_sum_plain(x.abs(), snd, rcv, s, mask))
    for kernel, plain in ((fused_gather_sum, fused_gather_sum_plain),
                          (fused_gather_mean, fused_gather_mean_plain)):
        before = kernel.launches
        got = kernel(x, snd, rcv, s, mask)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        ref = plain(x, snd, rcv, s, mask)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= tol, kernel.__name__


# K4 / K5's kernel (csrc/gather_reduce.cuh): 128-edge tiles; a group of
# lanes walks 8 consecutive edges of a tile (at D >= 64), reusing a gathered
# row while the sender repeats and summing in registers while the receiver
# does
COPY_TILE = 128
COPY_WIDTHS = [1, 3, 4, 50, 64, 65, 256]
COPY_PATTERNS = ["served", "random", "one_receiver", "runs_across_tiles", "out_of_range"]


def _served_copy_case(card, d, seed):
    """A batch laid out as the served ones: chip_smoke's graphs (from
    benchmarks/model_bench.py:make_graphs) through collate_graphs, with
    padding edges at the end (at the last node, mask 0)."""
    from chip_smoke import make_graphs

    graphs = make_graphs(7, 40, 12, seed=seed)
    n = sum(g.x.shape[0] for g in graphs)
    e = sum(g.edge_index.shape[1] for g in graphs)
    batch = collate_graphs(graphs, n + 9, e + 333, len(graphs) + 1)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch.num_nodes, d)).astype(np.float32)
    x[~batch.node_mask.numpy()] = 0.0
    return (torch.from_numpy(x).to(card), batch.senders.to(card), batch.receivers.to(card),
            batch.edge_mask.to(card), batch.num_nodes)


def _copy_case(card, pattern, d, seed=0):
    """Inputs of K4 / K5: 1741 edges (no multiple of a tile or a group's
    run) into 700 rows, a bool mask with a tenth masked."""
    if pattern == "served":
        return _served_copy_case(card, d, seed)
    e, s = 13 * COPY_TILE + 77, 700
    rng = np.random.default_rng(seed + d)
    x = rng.standard_normal((s, d)).astype(np.float32)
    snd = rng.integers(0, s, e)
    if pattern == "random":  # no runs of either id
        rcv = rng.integers(0, s, e)
    elif pattern == "one_receiver":  # one run through every tile
        rcv = np.full(e, s // 2)
    elif pattern == "runs_across_tiles":  # runs crossing groups' and tiles' ends
        rcv = np.repeat(rng.permutation(s), 100)[:e]
        snd = np.repeat(rng.integers(0, s, e), 7)[:e]
    else:  # out of range both ways, senders in runs (a reused zero row)
        rcv = rng.integers(-3, s + 3, e)
        snd = np.repeat(rng.integers(-3, s + 3, e), 3)[:e]
    mask = rng.random(e) < 0.9
    arrays = (x, snd.astype(np.int32), rcv.astype(np.int32), mask)
    return tuple(torch.from_numpy(a).to(card) for a in arrays) + (s,)


def _check_copy_kernels(x, snd, rcv, s, mask):
    """K4 and K5 against their plain versions; K5's deg exactly the mask
    summed at the in-range receivers; each call one launch."""
    tol = atomic_tolerance(fused_gather_sum_plain(x.abs(), snd, rcv, s, mask))
    for kernel, plain in ((fused_gather_sum, fused_gather_sum_plain),
                          (fused_gather_mean, fused_gather_mean_plain)):
        before = kernel.launches
        got = kernel(x, snd, rcv, s, mask)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        ref = plain(x, snd, rcv, s, mask)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= tol, kernel.__name__
    deg = got[1][:, 0]
    valid = (rcv >= 0) & (rcv < s)
    want = torch.zeros(s, device=x.device).index_add_(
        0, rcv[valid].long(), mask[valid].to(torch.float32))
    assert torch.equal(deg, want)


@pytest.mark.parametrize("d", COPY_WIDTHS)
@pytest.mark.parametrize("pattern", COPY_PATTERNS)
def pytest_fused_gather_sum_mean_kernel_id_patterns(card, pattern, d):
    x, snd, rcv, mask, s = _copy_case(card, pattern, d)
    _check_copy_kernels(x, snd, rcv, s, mask)


@pytest.mark.parametrize("d", [4, 64, 256])
def pytest_fused_gather_sum_mean_unaligned_view(card, d):
    """A node table 4 bytes past a 16-byte boundary takes the scalar path."""
    x, snd, rcv, mask, s = _copy_case(card, "served", d, seed=3)
    flat = torch.empty(x.numel() + 1, device=card)
    flat[1:] = x.reshape(-1)
    x = flat[1:].view(x.shape)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _check_copy_kernels(x, snd, rcv, s, mask)


@pytest.mark.parametrize("d", [1, 64])
def pytest_fused_gather_sum_mean_float_mask_and_no_edges(card, d):
    """A float mask (cast once, weights other than 0 and 1 too) and E = 0."""
    x, snd, rcv, mask, s = _copy_case(card, "random", d, seed=5)
    weights = torch.rand(mask.shape, device=card) * mask
    tol = atomic_tolerance(fused_gather_sum_plain(x.abs(), snd, rcv, s, weights))
    got = fused_gather_sum(x, snd, rcv, s, weights)
    assert float((got - fused_gather_sum_plain(x, snd, rcv, s, weights)).abs().max()) <= tol
    for g, r in zip(fused_gather_mean(x, snd, rcv, s, weights),
                    fused_gather_mean_plain(x, snd, rcv, s, weights)):
        assert float((g - r).abs().max()) <= tol
    none = snd[:0]
    assert torch.equal(fused_gather_sum(x, none, none, s, mask[:0]), torch.zeros((s, d), device=card))
    mean, deg = fused_gather_mean(x, none, none, s, mask[:0])
    assert torch.equal(mean, torch.zeros((s, d), device=card))
    assert torch.equal(deg, torch.zeros((s, 1), device=card))


# K6 (csrc/gather_reduce.cuh, Op::kMul): the K4/K5 tile walk with the edge's
# own weight row streamed beside the gathered one; float2 chunks where
# D % 4 != 0 and D % 2 == 0 (the served 50 filters), float4 where D % 4 ==
# 0, single floats otherwise
MUL_WIDTHS = [1, 3, 50, 51, 126, 256]


def _weights(card, mask, d, seed):
    """A masked weight row per edge, as SchNet's filter network gives."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((mask.shape[0], d)).astype(np.float32)).to(card)
    return w * mask[:, None]


def _check_weighted(h, w, snd, rcv, s):
    """K6 against its plain version; one launch per call."""
    before = fused_gather_weighted_sum.launches
    got = fused_gather_weighted_sum(h, w, snd, rcv, s)
    torch.cuda.synchronize()
    assert fused_gather_weighted_sum.launches == before + 1
    ref = fused_gather_weighted_sum_plain(h, w, snd, rcv, s)
    assert got.shape == ref.shape == (s, h.shape[1])
    if ref.numel():
        tol = atomic_tolerance(fused_gather_weighted_sum_plain(h.abs(), w.abs(), snd, rcv, s))
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("d", MUL_WIDTHS)
@pytest.mark.parametrize("pattern", COPY_PATTERNS)
def pytest_fused_gather_weighted_sum_kernel_id_patterns(card, pattern, d):
    h, snd, rcv, mask, s = _copy_case(card, pattern, d)
    _check_weighted(h, _weights(card, mask, d, d), snd, rcv, s)


@pytest.mark.parametrize("d", [50, 51, 256])
def pytest_fused_gather_weighted_sum_kernel_many_edges(card, d):
    """20000 edges: no multiple of a tile of 128, 256 or 512 edges."""
    _, h, snd, rcv, mask = _gather_case(card, 20000, d, 1700, 20000 + d)
    _check_weighted(h, _weights(card, mask, d, d + 1), snd, rcv, 1700)


@pytest.mark.parametrize("d", [50, 256])
def pytest_fused_gather_weighted_sum_unaligned_weights(card, d):
    """``w`` a contiguous view 4 bytes past an 8-byte boundary of a larger
    buffer takes the scalar path, and still matches."""
    h, snd, rcv, mask, s = _copy_case(card, "served", d, seed=3)
    w = _weights(card, mask, d, d + 2)
    flat = torch.empty(w.numel() + 3, device=card)
    flat[1 : w.numel() + 1] = w.reshape(-1)
    w = flat[1 : w.numel() + 1].view(w.shape)
    assert w.data_ptr() % 8 == 4 and w.is_contiguous()
    _check_weighted(h, w, snd, rcv, s)


@pytest.mark.parametrize("d", [1, 50])
def pytest_fused_gather_weighted_sum_no_edges_or_segments(card, d):
    """E = 0 gives zeros; S = 0 an empty result (every receiver is out of
    range)."""
    h, snd, rcv, mask, s = _copy_case(card, "random", d, seed=5)
    w = _weights(card, mask, d, d + 3)
    none = snd[:0]
    got = fused_gather_weighted_sum(h, w[:0], none, none, s)
    assert torch.equal(got, torch.zeros((s, d), device=card))
    _check_weighted(h, w, snd, rcv, 0)


# K3 and K2 (csrc/gather_reduce.cuh, the K4/K5 tile walk with a sum of
# squares; K3 writes z per edge, K2 reads its rows in order): both put their
# statistics in one packed [S, ldo] row (moments_layout). From 8 lanes per
# group on (D >= 29 on single floats, D >= 64 on float4) a block sorts its
# 256 edges by receiver first; narrower rows walk in tile order
MOMENT_WIDTHS = [1, 3, 4, 50, 64, 256, 260, 512]
MOMENT_PATTERNS = ["served", "sorted", "random", "all_equal", "runs_across_tiles",
                   "out_of_range"]


def _moments_case(card, pattern, d, seed=0):
    """Inputs of K3 (and K2 on its z): 1741 edges (no multiple of a tile or
    a group's run) into 700 rows, the last 10% padding edges at row 699
    (mask 0), as a served batch has; or a served batch itself."""
    if pattern == "served":
        return _served_copy_case(card, d, seed)
    e, s = 13 * COPY_TILE + 77, 700
    rng = np.random.default_rng(seed + d)
    x = rng.standard_normal((s, d)).astype(np.float32)
    snd = rng.integers(0, s - 1, e)
    if pattern == "sorted":
        rcv = np.sort(rng.integers(0, s - 1, e))
    elif pattern == "random":
        rcv = rng.integers(0, s - 1, e)
    elif pattern == "all_equal":
        rcv = np.full(e, s // 2)
    elif pattern == "runs_across_tiles":  # runs of 100 crossing every tile's end
        rcv = np.repeat(rng.permutation(s - 1), 100)[:e]
        snd = np.repeat(rng.integers(0, s - 1, e), 7)[:e]
    else:  # out of range both ways, senders in runs (a reused zero row)
        rcv = rng.integers(-3, s + 3, e)
        snd = np.repeat(rng.integers(-3, s + 3, e), 3)[:e]
    mask = np.ones(e, bool)
    pad = e // 10
    snd[-pad:], rcv[-pad:], mask[-pad:] = s - 1, s - 1, False
    arrays = (x, snd.astype(np.int32), rcv.astype(np.int32), mask)
    return tuple(torch.from_numpy(a).to(card) for a in arrays) + (s,)


def _moments_tolerance(z, rcv, s):
    return atomic_tolerance(segment_sum_plain(torch.cat([z.abs(), z * z], 1), rcv, s))


def _check_moments(got, ref, tol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if g.numel():
            assert float((g - r).abs().max()) <= tol


def _check_k3_k2(x, snd, rcv, s, mask, ze=None):
    """K3 against its plain version, ``z`` on every edge; then K2 on that
    ``z`` by receiver. Each call one launch. With a bool mask both counts
    are held exactly to their own rule: K3 the mask summed at the in-range
    receivers, K2 the number of in-range ids (padding edges included)."""
    before = fused_gather_moments.launches
    got = fused_gather_moments(x, snd, rcv, s, mask, ze=ze)
    torch.cuda.synchronize()
    assert fused_gather_moments.launches == before + 1
    ref = fused_gather_moments_plain(x, snd, rcv, s, mask, ze=ze)
    z = ref[3]
    tol = _moments_tolerance(z, rcv, s)
    _check_moments(got, ref, tol)
    before = segment_moments.launches
    got2 = segment_moments(z, rcv, s)
    torch.cuda.synchronize()
    assert segment_moments.launches == before + 1
    _check_moments(got2, segment_moments_plain(z, rcv, s), tol)
    valid = (rcv >= 0) & (rcv < s)
    ids = rcv[valid].long()
    assert torch.equal(got2[1][:, 0], torch.bincount(ids, minlength=s).float())
    if mask.dtype == torch.bool:
        want = torch.zeros(s, device=x.device).index_add_(0, ids, mask[valid].float())
        assert torch.equal(got[1][:, 0], want)


@pytest.mark.parametrize("d", MOMENT_WIDTHS)
@pytest.mark.parametrize("pattern", MOMENT_PATTERNS)
def pytest_moments_kernels_id_patterns(card, pattern, d):
    """K3 with and without ``ze`` and K2, on every id pattern and width
    class: D = 1 and 3 single floats in tile order, 50 single floats in a
    sorted tile, 4 float4 chunks in tile order, 64 a sorted tile, 256 one
    sorted slab, 260 and 512 two sorted slabs; runs of 100
    receivers cross every tile's end."""
    x, snd, rcv, mask, s = _moments_case(card, pattern, d)
    _check_k3_k2(x, snd, rcv, s, mask)
    ze = torch.randn((snd.shape[0], d), device=card)
    _check_k3_k2(x, snd, rcv, s, mask, ze=ze)


@pytest.mark.parametrize("d", [4, 64, 256])
def pytest_moments_kernels_unaligned_view(card, d):
    """Inputs 4 bytes past a 16-byte boundary take the scalar path."""
    x, snd, rcv, mask, s = _moments_case(card, "served", d, seed=3)

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, device=card)
        flat[1:] = t.reshape(-1)
        v = flat[1:].view(t.shape)
        assert v.data_ptr() % 16 != 0 and v.is_contiguous()
        return v

    _check_k3_k2(unaligned(x), snd, rcv, s, mask)
    _check_k3_k2(x, snd, rcv, s, mask, ze=unaligned(torch.randn((snd.shape[0], d), device=card)))


@pytest.mark.parametrize("d", [1, 64])
def pytest_moments_kernels_float_mask_and_no_edges(card, d):
    """K3 with a float mask (weights other than 0 and 1, cast once), and
    both kernels with E = 0."""
    x, snd, rcv, mask, s = _moments_case(card, "random", d, seed=5)
    weights = torch.rand(mask.shape, device=card) * mask
    _check_k3_k2(x, snd, rcv, s, weights)
    _check_k3_k2(x, snd, rcv, s, weights.double())
    none = snd[:0]
    sm, cnt, sq, z = fused_gather_moments(x, none, none, s, mask[:0])
    assert z.shape == (0, d)
    for t in (sm, cnt, sq):
        assert torch.equal(t, torch.zeros_like(t))
    for t in segment_moments(x[:0], none, s):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.parametrize("e,h,s", [(300, 8, 40), (1000, 33, 77), (20000, 256, 1700)])
@pytest.mark.parametrize("coord", [False, True])
def pytest_fused_egnn_edge_phase_kernel_matches_plain(card, e, h, s, coord):
    rng, y_snd, snd, rcv, mask = _gather_case(card, e, h, s, e + h)
    f32 = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(card)
    y_rcv, pos = f32(s, h), f32(s, 3, scale=2.0)
    pos[s - 1] = 0.0  # padded edges at the padding node have zero length
    lim = 1.0 / np.sqrt(h)
    params = [f32(h), f32(h, h, scale=lim), f32(h, scale=lim)]
    if coord:
        params += [f32(h, h, scale=lim), f32(h, scale=lim), f32(h, 1, scale=lim)]
    for ze in (None, f32(e, h)):
        got = fused_egnn_edge_phase(y_snd, y_rcv, pos, params, snd, rcv, s, mask, ze=ze)
        torch.cuda.synchronize()
        ref = fused_egnn_edge_phase_plain(y_snd, y_rcv, pos, params, snd, rcv, s, mask, ze=ze)
        assert got.shape == ref.shape == (s, h + (4 if coord else 1))
        assert torch.isfinite(got).all()
        tol = egnn_tolerance(ref)
        assert float((got - ref).abs().max()) <= tol


def _egnn_case(card, e, h, s, coord, one_sender, seed):
    rng, y_snd, snd, rcv, mask = _gather_case(card, e, h, s, seed)
    if one_sender:
        snd = torch.full_like(snd, s // 3)
    f32 = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(card)
    y_rcv, pos = f32(s, h), f32(s, 3, scale=2.0)
    pos[s - 1] = 0.0
    lim = 1.0 / np.sqrt(h)
    params = [f32(h), f32(h, h, scale=lim), f32(h, scale=lim)]
    if coord:
        params += [f32(h, h, scale=lim), f32(h, scale=lim), f32(h, 1, scale=lim)]
    return y_snd, y_rcv, pos, params, snd, rcv, mask, f32(e, h)


@pytest.mark.parametrize("h", [8, 33, 100, 128, 256])
@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("one_sender", [False, True])
def pytest_fused_egnn_edge_phase_kernel_widths(card, h, coord, one_sender):
    """Every width class of the tile (32, 64, 128, 256 columns; 33 takes
    the 4-byte path), 1001 edges (no multiple of a 64- or 128-edge tile),
    with and without ``ze``, and all edges on one sender."""
    e, s = 1001, 61
    y_snd, y_rcv, pos, params, snd, rcv, mask, ze_full = _egnn_case(
        card, e, h, s, coord, one_sender, seed=h + 7 * coord)
    for ze in (None, ze_full):
        got = fused_egnn_edge_phase(y_snd, y_rcv, pos, params, snd, rcv, s, mask, ze=ze)
        torch.cuda.synchronize()
        ref = fused_egnn_edge_phase_plain(y_snd, y_rcv, pos, params, snd, rcv, s, mask, ze=ze)
        assert got.shape == ref.shape == (s, h + (4 if coord else 1))
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= egnn_tolerance(ref)


def pytest_cuda_kernels_are_forward_only(card):
    """A wrapper called with grad on an input that requires it raises and
    names its ``*_vjp`` twin, which takes the gradient through the rule."""
    data = torch.zeros((8, 4), device=card, requires_grad=True)
    ids = torch.zeros(8, dtype=torch.int32, device=card)
    mask = ids > 0
    with pytest.raises(NotImplementedError, match="segment_sum_vjp"):
        segment_sum(data, ids, 2)
    with pytest.raises(NotImplementedError, match="forward-only"):
        segment_moments(data, ids, 2)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_gather_moments(data, ids, ids, 2, mask)
    for fn, vjp in ((fused_gather_sum, fused_gather_sum_vjp),
                    (fused_gather_mean, fused_gather_mean_vjp)):
        with pytest.raises(NotImplementedError, match=f"{fn.__name__}_vjp"):
            fn(data, ids, ids, 2, mask)
        out = vjp(data, ids, ids, 2, mask)
        (out[0] if isinstance(out, tuple) else out).sum().backward()
    w = torch.zeros((8, 4), device=card)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_gather_weighted_sum(data, w, ids, ids, 2)
    fused_gather_weighted_sum_vjp(data, w, ids, ids, 2).sum().backward()
    params = [torch.zeros(4, device=card), torch.zeros((4, 4), device=card),
              torch.zeros(4, device=card)]
    pos = torch.zeros((8, 3), device=card)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_egnn_edge_phase(data, data, pos, params, ids, ids, 2, mask)
    fused_egnn_edge_phase_vjp(data, data, pos, params, ids, ids, 2, mask).sum().backward()
    assert data.grad is not None
    with torch.inference_mode():  # parameters that require grad, where none is recorded
        fused_egnn_edge_phase(data, data, pos, params, ids, ids, 2, mask)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum(torch.zeros((4, 8), device=card).t(), ids, 2)
    with pytest.raises(ValueError, match="does not fit"):
        wide = torch.zeros((8, 264), device=card)
        fused_egnn_edge_phase(wide, wide, pos, [torch.zeros(264, device=card),
                              torch.zeros((264, 264), device=card),
                              torch.zeros(264, device=card)], ids, ids, 2, mask)


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
        g.targets = [rng.random(1).astype(np.float32), rng.random((n, 2)).astype(np.float32)]
        graphs.append(g)
    host = collate_graphs(graphs, *pad_sizes_for(9, 9, 3), head_types=("graph", "node"),
                          head_dims=(1, 2))
    moved = host.to(card)
    torch.cuda.synchronize()
    ptrs = set()
    pairs = [(name, getattr(host, name), getattr(moved, name))
             for name in host.__dataclass_fields__ if name not in ("targets", "extras")]
    pairs += [(f"targets[{i}]", h, d) for i, (h, d) in enumerate(zip(host.targets, moved.targets))]
    assert len(moved.targets) == 2 and host.extras == moved.extras == {}
    for name, h, d in pairs:
        assert d.device.type == "cuda" and d.dtype == h.dtype and d.shape == h.shape, name
        assert torch.equal(d.cpu(), h), name
        ptrs.add(d.untyped_storage().data_ptr())
    assert len(ptrs) == 1  # every field, the targets too, is a view of the one device buffer


# ---------------------------------------------------------------------------
# the backward rules of K1-K3 on the card against the same Functions on the
# CPU (plain forward, the same rule)
# ---------------------------------------------------------------------------


def _vjp_run(fn, inputs, grad_inputs, cotangents):
    """``fn(*inputs)`` with ``grad_inputs`` (indices) requiring grad, its
    outputs' backward with ``cotangents``; returns the outputs and the
    gradients, detached."""
    inputs = [t.detach().clone().requires_grad_(i in grad_inputs) if t is not None else None
              for i, t in enumerate(inputs)]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, list(cotangents))
    return [o.detach() for o in outs], [inputs[i].grad for i in grad_inputs]


def _cpu(tensors):
    return [None if t is None else t.cpu() for t in tensors]


@pytest.mark.parametrize("d", [1, 3, 50, 256])
@pytest.mark.parametrize("pattern", ["all_equal", "runs", "unsorted", "out_of_range_mid_run"])
def pytest_segment_sum_vjp_on_the_card(card, pattern, d):
    """K1's rule, ``g[ids]`` with zero out of range: a gather, exact."""
    e, s = 3001, 100
    rng = np.random.default_rng(d)
    data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(card)
    ids = torch.from_numpy(_run_ids(e, s, pattern, seed=d)).to(card)
    g = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(card)
    fn = lambda x, i: segment_sum_vjp(x, i, s)  # noqa: E731
    before = segment_sum.launches
    outs, grads = _vjp_run(fn, [data, ids], [0], [g])
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1  # the forward only: the rule is a gather
    ref_outs, ref_grads = _vjp_run(fn, _cpu([data, ids]), [0], [g.cpu()])
    assert torch.equal(grads[0].cpu(), ref_grads[0])
    tol = atomic_tolerance(segment_sum_plain(data.abs().cpu(), ids.cpu(), s))
    assert float((outs[0].cpu() - ref_outs[0]).abs().max()) <= tol


def _check_moment_vjps(x, snd, rcv, s, mask, ze, seed):
    """K3's and K2's rules on the card against the CPU: K3 with the
    cotangents of all four outputs (``z``'s included) into ``yj`` (summed
    at the senders through K1) and ``ze``; K2 into its data."""
    rng = np.random.default_rng(seed)
    d, e = x.shape[1], snd.shape[0]

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(x.device)

    cots = [rand(s, d), rand(s, 1), rand(s, d), rand(e, d)]
    cpu_cots = _cpu(cots)
    grad_inputs = [0] if ze is None else [0, 1]

    def k3(snd, rcv, mask):
        return lambda y, z_e: fused_gather_moments_vjp(y, snd, rcv, s, mask, ze=z_e)

    before = (fused_gather_moments.launches, segment_sum.launches)
    outs, grads = _vjp_run(k3(snd, rcv, mask), [x, ze], grad_inputs, cots)
    torch.cuda.synchronize()
    assert (fused_gather_moments.launches, segment_sum.launches) == (before[0] + 1, before[1] + 1)
    k3_cpu = k3(*_cpu([snd, rcv, mask]))
    ref_outs, ref_grads = _vjp_run(k3_cpu, _cpu([x, ze]), grad_inputs, cpu_cots)
    # dz per edge: the same rule on the CPU with a zero ze (z unchanged)
    _, (dz,) = _vjp_run(k3_cpu, [x.cpu(), torch.zeros((e, d))], [1], cpu_cots)
    _check_moments([o.cpu() for o in outs], ref_outs, _moments_tolerance(ref_outs[3], rcv.cpu(), s))
    yj_tol = atomic_tolerance(segment_sum_plain(dz.abs(), snd.cpu(), x.shape[0]))
    assert float((grads[0].cpu() - ref_grads[0]).abs().max()) <= yj_tol
    if ze is not None:  # elementwise: the same ops on both devices
        assert float((grads[1].cpu() - ref_grads[1]).abs().max()) <= 1e-6 * (
            float(ref_grads[1].abs().max()) + 1.0)

    z = ref_outs[3]
    before = segment_moments.launches
    _, (g2,) = _vjp_run(lambda t: segment_moments_vjp(t, rcv, s), [z.to(x.device)], [0], cots[:3])
    torch.cuda.synchronize()
    assert segment_moments.launches == before + 1
    _, (ref_g2,) = _vjp_run(lambda t: segment_moments_vjp(t, rcv.cpu(), s), [z], [0], cpu_cots[:3])
    assert float((g2.cpu() - ref_g2).abs().max()) <= 1e-6 * (float(ref_g2.abs().max()) + 1.0)


@pytest.mark.parametrize("d", [1, 64, 256])
@pytest.mark.parametrize("pattern", MOMENT_PATTERNS)
@pytest.mark.parametrize("with_ze", [False, True])
def pytest_moments_vjps_on_the_card(card, pattern, d, with_ze):
    x, snd, rcv, mask, s = _moments_case(card, pattern, d)
    ze = None
    if with_ze:
        rng = np.random.default_rng(d + 5)
        ze = torch.from_numpy(rng.standard_normal((snd.shape[0], d)).astype(np.float32)).to(card)
    _check_moment_vjps(x, snd, rcv, s, mask, ze, seed=d)


def pytest_vjps_at_the_main_path_shape(card):
    """The main path's largest batch (n_pad 5768, e_pad 69120, hidden 256):
    K3's and K2's rules, the padding node and the pool's K1 rule."""
    from chip_smoke import FULL, largest_batch, make_graphs
    from hydragnn_tpu_torch.serve import plan_from_samples

    graphs = make_graphs(FULL["graphs"], FULL["nodes"], FULL["degree"], seed=0)
    plan = plan_from_samples(graphs, max_batch_graphs=FULL["batch"], num_buckets=3)
    batch = largest_batch(plan, graphs).to(card)
    n, h = batch.num_nodes, FULL["hidden"]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(card)
    _check_moment_vjps(x, batch.senders, batch.receivers, n, batch.edge_mask, None, seed=2)
    g = torch.from_numpy(rng.standard_normal((batch.num_graphs, h)).astype(np.float32)).to(card)
    fn = lambda t, i: segment_sum_vjp(t, i, batch.num_graphs)  # noqa: E731
    _, (got,) = _vjp_run(fn, [x, batch.node_graph], [0], [g])
    _, (want,) = _vjp_run(fn, _cpu([x, batch.node_graph]), [0], [g.cpu()])
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the dense neighbour-list branch (no kernel of its own) and bf16 training
# ---------------------------------------------------------------------------


def _headline_lists():
    """``MXU_HEADLINE``'s batch with its lists (n_pad 5768, K_in 22,
    K_out 22), on the host."""
    from hydragnn_tpu_torch.benchmarks import model_bench
    from hydragnn_tpu_torch.ops.dense_agg import attach_neighbor_lists

    h = model_bench.MXU_HEADLINE
    graphs = model_bench.make_graphs(h["num_graphs"], h["nodes"], h["degree"], seed=0)
    return attach_neighbor_lists(model_bench._collate(graphs, h["num_graphs"], h["nodes"], h["degree"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_gather_neighbors_on_the_card(card, dtype):
    """``gather_neighbors``' Function on the card against the same Function
    on the CPU at the headline's ``[5768, 22, 256]``: the gather exactly;
    the reverse-list backward (a sum over K_out in float32, then the
    cotangent's dtype) within ``atomic_tolerance`` of the summed ``|g|``,
    and in bf16 one bf16 rounding (``2^-8`` of the value) more."""
    from hydragnn_tpu_torch.ops.dense_agg import gather_neighbors

    batch = _headline_lists()
    lists = [batch.extras[k] for k in ("nbr_idx", "rev_idx", "rev_mask")]
    n, k_in = lists[0].shape
    assert (n, k_in, lists[1].shape[1]) == (5768, 22, 22)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((n, k_in, 256)).astype(np.float32)).to(dtype)
    g = torch.where(batch.extras["nbr_mask"][..., None], g, 0.0)
    fn = lambda t, *ls: gather_neighbors(t, *ls)  # noqa: E731
    outs, (grad,) = _vjp_run(fn, [x.to(card)] + [t.to(card) for t in lists], [0], [g.to(card)])
    ref_outs, (ref_grad,) = _vjp_run(fn, [x] + lists, [0], [g])
    assert outs[0].dtype == grad.dtype == dtype
    assert torch.equal(outs[0].cpu(), ref_outs[0])
    abs_sum = torch.zeros((n, 256)).index_add_(
        0, lists[0].reshape(-1).long(), g.float().abs().reshape(-1, 256))
    tol = atomic_tolerance(abs_sum)
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * ref_grad.float().abs()
    assert bool(((grad.cpu().float() - ref_grad.float()).abs() <= tol).all())


def pytest_pna_dense_bf16_step_on_the_card(card):
    """One PNA dense bf16 step (16 graphs at the headline's width) on the
    card against the exact step, as the smoke holds it: each tensor within
    ``BF16_FACTOR`` times the bf16 CPU steps' own error on it (the graphs
    in both orders)."""
    import chip_smoke as cs
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.serve import plan_from_samples
    from hydragnn_tpu_torch.train import Trainer

    size = dict(cs.FULL, graphs=16, batch=16)
    graphs = cs.make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0)
    plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=1)
    cs.set_targets(graphs, seed=1)
    cfg = cs.arch(size, "PNA")
    host = cs.train_batch(plan, graphs, cfg, dense=True)
    model = create_model_config(cfg, device=card, seed=0)
    cpu, exact = cs.cpu_references(
        model, host, bf16=True,
        reversed_host=cs.train_batch(plan, graphs, cfg, dense=True, reverse=True))
    trainer = Trainer(model, cs.train_config(bf16=True))
    before = segment_sum.launches
    _, met = trainer.train_step(trainer.init_state(host), trainer.put_batch(host))
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1  # the pool; the dense branch runs no kernel
    rows, bad, _ = cs.hold_step_against_cpu(cs.snapshot(model), float(met["loss"]), cpu, exact,
                                            bf16=True)
    assert rows and not bad, bad


# ---------------------------------------------------------------------------
# the backward rules of K4-K7 on the card against the same Functions on the
# CPU (plain forward, the same rule on the plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 64, 256])
@pytest.mark.parametrize("pattern", COPY_PATTERNS)
def pytest_gather_sum_mean_rules_on_the_card(card, pattern, d):
    """K4's rule (K4 with the ids swapped) and K5's (the cotangent over
    ``max(deg, 1)``, then the same): ``x``'s gradient within
    ``atomic_tolerance`` of the swapped fold of ``|g|``; each backward one
    K4 launch."""
    x, snd, rcv, mask, s = _copy_case(card, pattern, d)
    rng = np.random.default_rng(d + 11)
    g = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(card)
    for vjp, scale in ((fused_gather_sum_vjp, False), (fused_gather_mean_vjp, True)):
        def fn(t, i, j, m, vjp=vjp):
            out = vjp(t, i, j, s, m)
            return out[0] if scale else out  # K5's deg takes no gradient

        before = fused_gather_sum.launches
        _, (got,) = _vjp_run(lambda t: fn(t, snd, rcv, mask), [x], [0], [g])
        torch.cuda.synchronize()
        assert fused_gather_sum.launches == before + 1 + (not scale)  # the rule (and K4 forward)
        cpu = _cpu([snd, rcv, mask])
        _, (want,) = _vjp_run(lambda t: fn(t, *cpu), [x.cpu()], [0], [g.cpu()])
        cot = g.cpu()
        if scale:
            deg = fused_gather_mean_plain(x.cpu(), *cpu[:2], s, cpu[2])[1]
            cot = cot / torch.clamp(deg, min=1.0)
        tol = atomic_tolerance(fused_gather_sum_plain(cot.abs(), cpu[1], cpu[0], x.shape[0],
                                                      cpu[2]))
        assert got.shape == x.shape
        assert float((got.cpu() - want).abs().max()) <= tol, vjp.__name__


@pytest.mark.parametrize("d", MUL_WIDTHS)
@pytest.mark.parametrize("pattern", COPY_PATTERNS)
def pytest_weighted_sum_rule_on_the_card(card, pattern, d):
    """K6's rule: ``d_h`` (K6 with the ids swapped) within
    ``atomic_tolerance``, ``d_w = h[s] * g[r]`` within one rounding."""
    h, snd, rcv, mask, s = _copy_case(card, pattern, d)
    w = _weights(card, mask, d, d + 4)
    rng = np.random.default_rng(d + 12)
    g = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(card)
    fn = lambda a, b, i, j: fused_gather_weighted_sum_vjp(a, b, i, j, s)  # noqa: E731
    before = fused_gather_weighted_sum.launches
    _, (d_h, d_w) = _vjp_run(lambda a, b: fn(a, b, snd, rcv), [h, w], [0, 1], [g])
    torch.cuda.synchronize()
    assert fused_gather_weighted_sum.launches == before + 2  # forward and d_h
    cpu = _cpu([snd, rcv])
    _, (want_h, want_w) = _vjp_run(lambda a, b: fn(a, b, *cpu), [h.cpu(), w.cpu()], [0, 1],
                                   [g.cpu()])
    tol = atomic_tolerance(fused_gather_weighted_sum_plain(g.cpu().abs(), w.cpu().abs(), cpu[1],
                                                           cpu[0], h.shape[0]))
    assert float((d_h.cpu() - want_h).abs().max()) <= tol
    assert float((d_w.cpu() - want_w).abs().max()) <= 1e-6 * (float(want_w.abs().max()) + 1.0)


@pytest.mark.parametrize("h", [8, 33, 128, 256])
@pytest.mark.parametrize("coord", [False, True])
def pytest_egnn_rule_on_the_card(card, h, coord):
    """K7's rule: every input's gradient (``pos``'s through both its
    sender and receiver rows) within ``egnn_tolerance`` of the CPU's,
    finite where a padded edge has zero length; its folds are K1 launches
    (two for the node rows, two more for ``pos``)."""
    e, s = 1001, 61
    y_snd, y_rcv, pos, params, snd, rcv, mask, ze = _egnn_case(
        card, e, h, s, coord, one_sender=False, seed=h + 3 * coord)
    rcv = torch.where(mask, rcv, s - 1)
    snd = torch.where(mask, snd, s - 1)  # padded edges: the padding node, zero length
    rng = np.random.default_rng(h)
    g = torch.from_numpy(rng.standard_normal((s, h + (4 if coord else 1))).astype(np.float32))
    inputs = [y_snd, y_rcv, pos, ze] + params
    grad_inputs = list(range(len(inputs)))

    def fn(snd, rcv, mask):
        return lambda a, b, p, z, *ps: fused_egnn_edge_phase_vjp(a, b, p, list(ps), snd, rcv, s,
                                                                 mask, ze=z)

    before = (fused_egnn_edge_phase.launches, segment_sum.launches)
    outs, grads = _vjp_run(fn(snd, rcv, mask), inputs, grad_inputs, [g.to(card)])
    torch.cuda.synchronize()
    assert (fused_egnn_edge_phase.launches, segment_sum.launches) == (before[0] + 1, before[1] + 4)
    ref_outs, ref_grads = _vjp_run(fn(*_cpu([snd, rcv, mask])), _cpu(inputs), grad_inputs, [g])
    assert float((outs[0].cpu() - ref_outs[0]).abs().max()) <= egnn_tolerance(ref_outs[0])
    names = ["y_snd", "y_rcv", "pos", "ze"] + [f"param {i}" for i in range(len(params))]
    for name, got, want in zip(names, grads, ref_grads):
        assert bool(torch.isfinite(got).all()), name
        assert float((got.cpu() - want).abs().max()) <= egnn_tolerance(want), name
    assert float(ref_grads[2].abs().max()) > 0  # pos gets its gradient
