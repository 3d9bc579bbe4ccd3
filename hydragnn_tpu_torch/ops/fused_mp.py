"""Fused message passing: gather -> edge op -> segment reduce in one kernel.

Port of ``hydragnn_tpu/ops/fused_mp.py``. Every edge op of its one Pallas
kernel (``fused_message_reduce``) becomes a CUDA kernel here, each behind
a wrapper with a plain PyTorch version beside it:

| Id | Wrapper | Edge op | Stack | Source |
|----|---------|---------|-------|--------|
| K3 | :func:`fused_gather_moments` | ``moments`` | PNA | ``csrc/fused_mp.cu`` |
| K4 | :func:`fused_gather_sum` | ``copy`` | GIN | ``csrc/fused_mp.cu`` |
| K5 | :func:`fused_gather_mean` | ``copy_count`` | SAGE | ``csrc/fused_mp.cu`` |
| K6 | :func:`fused_gather_weighted_sum` | ``mul`` | SchNet | ``csrc/fused_mp.cu`` |
| K7 | :func:`fused_egnn_edge_phase` | ``egnn`` | EGNN | ``csrc/fused_egnn.cu`` |

The padding contract is the TPU kernel's: a gather id outside the node
table reads a zero row, a reduce id outside ``[0, S)`` adds nothing, and a
count sums the edge mask.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. The wrappers are forward-only;
each takes gradients through its ``*_vjp`` twin, a
``torch.autograd.Function`` around the wrapper with the JAX package's
backward rule (``_fused_bwd``, ``hydragnn_tpu/ops/fused_mp.py:376-452``)
applied to its op. The rules run the port's kernels on the card:

| Id | Rule (``*_rule``) | Kernels it launches |
|----|-------------------|---------------------|
| K3 | ``dz`` per edge in PyTorch, summed at the senders | K1 |
| K4 | the kernel itself with the two id arrays swapped | K4 |
| K5 | the cotangent over ``max(deg, 1)``, then K4 swapped | K4 |
| K6 | ``d_h``: K6 swapped; ``d_w = h[s] * g[r]`` in PyTorch | K6 |
| K7 | the edge body recomputed and pulled back by autograd, the node rows folded at the senders and the receivers | K1 (2 or 4) |

An id outside the table gathers a zero row and adds nothing, in the rules
as in the forwards: a padded edge gets a zero cotangent. Launches are
counted in ``<wrapper>.launches``, the rules' too. Kernel against plain on
the card: relative tolerance ``1e-5 * (max |partial sum| + 1)`` (atomics
add in a run-dependent order); K7 :func:`egnn_tolerance`.
"""

from typing import Optional, Sequence

import torch

from hydragnn_tpu_torch.ops import _build
from hydragnn_tpu_torch.ops.segment_kernels import (
    _on_cpu,
    _stream,
    check_cuda_launch,
    gather_cotangent,
    moments_layout,
    moments_row,
    moments_views,
    pack_moments_rows,
    segment_sum,
    segment_sum_plain,
    upcast,
)

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _check_ids(senders, receivers, device):
    e = senders.shape[0]
    for name, ids in (("senders", senders), ("receivers", receivers)):
        if ids.dtype != torch.int32 or ids.ndim != 1 or ids.shape[0] != e:
            raise TypeError(f"{name} must be 1-D int32 of length {e}")
        if ids.device != device:
            raise ValueError("all inputs must be on one device")
    return e


def _check_f32(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise TypeError(
            f"{name} must be float32 {list(shape)}, got {t.dtype} shape {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError("all inputs must be on one device")


def _check_mask(edge_mask, e, device):
    if edge_mask.ndim != 1 or edge_mask.shape[0] != e:
        raise ValueError(f"edge_mask must be 1-D of length {e}")
    if edge_mask.device != device:
        raise ValueError("all inputs must be on one device")


def _check_segments(num_segments):
    if not 0 <= int(num_segments) < 2**31:
        raise ValueError(f"num_segments out of range: {num_segments}")


def _check_node_table(name, x):
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(
            f"{name} must be 2-D float32, got {x.dtype} shape {tuple(x.shape)}"
        )


def _gather_rows(table, ids):
    """``table[ids]`` with a zero row where an id is outside the table."""
    valid = (ids >= 0) & (ids < table.shape[0])
    return torch.where(valid[:, None], table[torch.where(valid, ids, 0)], 0.0)


# ---------------------------------------------------------------------------
# K3: op "moments" (PNA)
# ---------------------------------------------------------------------------


def _check_moments_inputs(yj, senders, receivers, num_segments, edge_mask, ze):
    _check_node_table("yj", yj)
    e = _check_ids(senders, receivers, yj.device)
    _check_mask(edge_mask, e, yj.device)
    if ze is not None:
        _check_f32("ze", ze, (e, yj.shape[1]), yj.device)
    _check_segments(num_segments)


def fused_gather_moments_plain(yj, senders, receivers, num_segments,
                               edge_mask, ze=None):
    """Plain PyTorch version of :func:`fused_gather_moments`: a gather that
    reads a zero row for out-of-range senders, then one ``index_add_`` at
    the receivers of the rows ``segment_kernels.pack_moments_rows`` lays
    out, counting the mask."""
    _check_moments_inputs(yj, senders, receivers, num_segments, edge_mask, ze)
    xs = _gather_rows(yj, senders)
    if ze is not None:
        xs = xs + ze
    mask = edge_mask.to(torch.float32)
    z = xs * mask[:, None]
    out = segment_sum_plain(pack_moments_rows(z, mask), receivers, num_segments)
    return moments_views(out, yj.shape[1]) + (z,)


def fused_gather_moments(yj: torch.Tensor, senders: torch.Tensor,
                         receivers: torch.Tensor, num_segments: int,
                         edge_mask: torch.Tensor,
                         ze: Optional[torch.Tensor] = None):
    """K3, PNA's statistics pass: ``z = (yj[senders] (+ ze)) * mask`` with
    (sum, count, sum of squares) reduced at the receivers and ``z``
    returned per edge for the min/max pass. Out-of-range senders gather a
    zero row; out-of-range receivers add nothing; count sums the mask.

    Returns ``(s [S, D], cnt [S, 1], sq [S, D], z [E, D])``, float32.

    ``s``, ``cnt`` and ``sq`` are views of one packed ``[S, ldo]`` row
    (``segment_kernels.moments_views``). On the card it comes from
    ``torch.empty`` and the C entry zeroes it on the current stream; a bool
    mask is read as bytes, any other mask cast to f32 once."""
    _check_moments_inputs(yj, senders, receivers, num_segments, edge_mask, ze)
    if _on_cpu(yj):
        return fused_gather_moments_plain(
            yj, senders, receivers, num_segments, edge_mask, ze
        )
    mask = _cuda_mask("fused_gather_moments", yj, senders, receivers, edge_mask)
    if ze is not None:
        check_cuda_launch("fused_gather_moments", ze)
    n, d = yj.shape
    e = senders.shape[0]
    num_segments = int(num_segments)
    sq_off, cnt_off, ldo = moments_layout(d)
    out = yj.new_empty((num_segments, ldo))
    z = yj.new_empty((e, d))
    rc = _build.entry("fused_mp", "hg_fused_gather_moments_f32")(
        yj.data_ptr(), None if ze is None else ze.data_ptr(), mask.data_ptr(),
        mask.dtype is _BOOL, senders.data_ptr(), receivers.data_ptr(), out.data_ptr(),
        z.data_ptr(), e, n, d, num_segments, ldo, sq_off, cnt_off, _stream(yj.device),
    )
    if rc:
        _build.check(rc, "fused_gather_moments")
    fused_gather_moments.launches += 1
    return moments_views(out, d) + (z,)


fused_gather_moments.launches = 0


class _FusedGatherMoments(torch.autograd.Function):
    """K3 with ``_fused_bwd``'s rule for op ``moments``
    (``hydragnn_tpu/ops/fused_mp.py:376-452``, the op at ``:82-94``).

    Per edge ``dz = (g_sum[r] + 2 z g_sq[r] + g_z) * mask``, where an
    out-of-range receiver gathers zero and ``g_z`` is the cotangent of the
    per-edge ``z`` output; ``ze`` gets ``dz`` and ``yj`` gets ``dz`` summed
    at the senders through K1 (:func:`segment_kernels.segment_sum`), where
    an out-of-range sender adds nothing. The forward's ``z`` is saved: it
    is the value the JAX rule recomputes. Returns the packed row and ``z``;
    the caller takes the views."""

    @staticmethod
    def forward(ctx, yj, ze, senders, receivers, num_segments, edge_mask):
        ctx.set_materialize_grads(False)
        s, _, _, z = fused_gather_moments(
            yj.detach(), senders, receivers, num_segments, edge_mask,
            None if ze is None else ze.detach(),
        )
        ctx.save_for_backward(z, senders, receivers, edge_mask)
        ctx.num_nodes = yj.shape[0]
        return moments_row(s), z

    @staticmethod
    def backward(ctx, g_out, g_z):
        z, senders, receivers, edge_mask = ctx.saved_tensors
        d = z.shape[1]
        if g_out is None:
            dz = torch.zeros_like(z)
        else:
            sq_off, _, _ = moments_layout(d)
            rows = gather_cotangent(g_out, receivers)  # zero rows out of range
            dz = rows[:, :d] + 2.0 * z * rows[:, sq_off : sq_off + d]
        if g_z is not None:
            dz = dz + g_z
        dz = dz * edge_mask.to(torch.float32)[:, None]
        d_yj = None
        if ctx.needs_input_grad[0]:
            d_yj = segment_sum(dz.contiguous(), senders, ctx.num_nodes)
        d_ze = dz if ctx.needs_input_grad[1] else None
        return d_yj, d_ze, None, None, None, None


def _records(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (``None`` allowed)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_gather_moments_vjp(yj: torch.Tensor, senders: torch.Tensor,
                             receivers: torch.Tensor, num_segments: int,
                             edge_mask: torch.Tensor,
                             ze: Optional[torch.Tensor] = None):
    """:func:`fused_gather_moments` (K3) with its backward rule; the
    wrapper itself where autograd records nothing (as
    ``segment_kernels.segment_sum_vjp``). Returns ``(s, cnt, sq, z)`` as
    the wrapper does, float32 (bf16 ``yj`` and ``ze`` are upcast first)."""
    yj, ze = upcast(yj), upcast(ze)
    if not _records(yj, ze):
        return fused_gather_moments(yj, senders, receivers, num_segments, edge_mask, ze)
    out, z = _FusedGatherMoments.apply(
        yj, ze, senders, receivers, num_segments, edge_mask
    )
    return moments_views(out, yj.shape[1]) + (z,)


# ---------------------------------------------------------------------------
# K4 op "copy" (GIN), K5 op "copy_count" (SAGE): one gather-reduce kernel,
# one C entry each; the C entry zeroes the output and, for K5, divides by the
# count in place
# ---------------------------------------------------------------------------


def _check_gather_inputs(x, senders, receivers, num_segments, edge_mask):
    _check_node_table("x", x)
    e = _check_ids(senders, receivers, x.device)
    _check_mask(edge_mask, e, x.device)
    _check_segments(num_segments)


def _gather_copy_ready(x, senders, receivers, num_segments, edge_mask):
    """One test of every condition :func:`_check_gather_inputs` and
    :func:`check_cuda_launch` check, for the common case on the card:
    contiguous f32 ``x``, int32 ids and a bool mask on one card, nothing
    that autograd would record."""
    return (
        x.is_cuda and x.dtype is _F32 and x.dim() == 2 and x.is_contiguous()
        and not x.requires_grad
        and senders.dtype is _I32 and receivers.dtype is _I32 and edge_mask.dtype is _BOOL
        and senders.dim() == 1 and senders.shape == receivers.shape == edge_mask.shape
        and senders.is_contiguous() and receivers.is_contiguous() and edge_mask.is_contiguous()
        and senders.get_device() == receivers.get_device() == edge_mask.get_device()
        == x.get_device()
        and type(num_segments) is int and 0 <= num_segments < 2**31
    )


def _cuda_mask(name, x, senders, receivers, edge_mask):
    """The launch checks of a gather kernel's inputs (K3's, and K4's or
    K5's that failed :func:`_gather_copy_ready`); returns the mask the
    kernel reads: a bool mask as it is (bytes), any other cast to f32
    once."""
    mask = edge_mask if edge_mask.dtype is _BOOL else edge_mask.to(_F32)
    check_cuda_launch(name, x, mask, senders, receivers)
    return mask


def _launch_gather_copy(entry, name, x, senders, receivers, num_segments,
                        edge_mask, ldo):
    """K4 or K5 into ``[S, ldo]`` from ``torch.empty``, which the C entry
    zeroes on the current stream."""
    n, d = x.shape
    out = x.new_empty((num_segments, ldo))
    rc = _build.entry("fused_mp", entry)(
        x.data_ptr(), edge_mask.data_ptr(), edge_mask.dtype is _BOOL,
        senders.data_ptr(), receivers.data_ptr(), out.data_ptr(),
        senders.shape[0], n, d, num_segments, ldo, _stream(x.device),
    )
    if rc:
        _build.check(rc, name)
    return out


def fused_gather_sum_plain(x, senders, receivers, num_segments, edge_mask):
    """Plain PyTorch version of :func:`fused_gather_sum`."""
    _check_gather_inputs(x, senders, receivers, num_segments, edge_mask)
    msg = _gather_rows(x, senders) * edge_mask.to(torch.float32)[:, None]
    return segment_sum_plain(msg, receivers, num_segments)


def fused_gather_sum(x: torch.Tensor, senders: torch.Tensor,
                     receivers: torch.Tensor, num_segments: int,
                     edge_mask: torch.Tensor) -> torch.Tensor:
    """K4, GIN's aggregation: ``out[r] += x[s] * mask`` over the edges
    ``s -> r``. Returns ``[S, D]`` float32."""
    if not _gather_copy_ready(x, senders, receivers, num_segments, edge_mask):
        _check_gather_inputs(x, senders, receivers, num_segments, edge_mask)
        if _on_cpu(x):
            return fused_gather_sum_plain(x, senders, receivers, num_segments, edge_mask)
        edge_mask = _cuda_mask("fused_gather_sum", x, senders, receivers, edge_mask)
        num_segments = int(num_segments)
    out = _launch_gather_copy(
        "hg_fused_gather_sum_f32", "fused_gather_sum", x, senders, receivers,
        num_segments, edge_mask, x.shape[1],
    )
    fused_gather_sum.launches += 1
    return out


fused_gather_sum.launches = 0


def fused_gather_mean_plain(x, senders, receivers, num_segments, edge_mask):
    """Plain PyTorch version of :func:`fused_gather_mean`: one
    ``index_add_`` of the packed ``[x[s] * mask, mask]`` columns."""
    _check_gather_inputs(x, senders, receivers, num_segments, edge_mask)
    mask = edge_mask.to(torch.float32)[:, None]
    packed = torch.cat([_gather_rows(x, senders) * mask, mask], dim=1)
    out = segment_sum_plain(packed, receivers, num_segments)
    d = x.shape[1]
    deg = out[:, d:]
    return out[:, :d] / torch.clamp(deg, min=1.0), deg


def fused_gather_mean(x: torch.Tensor, senders: torch.Tensor,
                      receivers: torch.Tensor, num_segments: int,
                      edge_mask: torch.Tensor):
    """K5, SAGE's aggregation: the masked sum at the receivers and the real
    in-degree (the sum of the mask) from one reduction; the mean is
    ``sum / max(deg, 1)``. Returns ``(mean [S, D], deg [S, 1])`` float32.

    On the card both are views of the kernel's ``[S, ldo]`` output, whose
    rows are padded to a multiple of 4 floats (16 bytes, so the sums go out
    as vector atomics): the C entry divides columns ``[0, D)`` by the count
    at column D in place."""
    if not _gather_copy_ready(x, senders, receivers, num_segments, edge_mask):
        _check_gather_inputs(x, senders, receivers, num_segments, edge_mask)
        if _on_cpu(x):
            return fused_gather_mean_plain(x, senders, receivers, num_segments, edge_mask)
        edge_mask = _cuda_mask("fused_gather_mean", x, senders, receivers, edge_mask)
        num_segments = int(num_segments)
    d = x.shape[1]
    out = _launch_gather_copy(
        "hg_fused_gather_count_f32", "fused_gather_mean", x, senders, receivers,
        num_segments, edge_mask, -(-(d + 1) // 4) * 4,
    )
    fused_gather_mean.launches += 1
    return out[:, :d], out[:, d : d + 1]


fused_gather_mean.launches = 0


def fused_gather_sum_rule(g, senders, receivers, num_nodes, edge_mask):
    """K4's backward rule: ``d_x[s] = sum_{e: snd=s} mask_e * g[r_e]``,
    which is K4 with the two id arrays swapped (a receiver outside ``[0,
    S)`` gathers a zero row of ``g``, a sender outside ``[0, N)`` adds
    nothing). No ``[E, D]`` intermediate; the kernel flushes each run of
    equal reduce ids with atomics, so the senders' order (unsorted where
    the edges are grouped by receiver) costs time, not correctness."""
    return fused_gather_sum(g.contiguous(), receivers, senders, num_nodes, edge_mask)


def fused_gather_mean_rule(g_mean, deg, senders, receivers, num_nodes, edge_mask):
    """K5's backward rule: the mean's cotangent over ``max(deg, 1)``, then
    :func:`fused_gather_sum_rule`. ``deg`` (the mask summed) carries no
    gradient."""
    scaled = g_mean / torch.clamp(deg, min=1.0)
    return fused_gather_sum_rule(scaled, senders, receivers, num_nodes, edge_mask)


class _FusedGatherSum(torch.autograd.Function):
    """K4 with ``_fused_bwd``'s rule for op ``copy`` (``fused_mp.py:67-69``):
    :func:`fused_gather_sum_rule`."""

    @staticmethod
    def forward(ctx, x, senders, receivers, num_segments, edge_mask):
        ctx.save_for_backward(senders, receivers, edge_mask)
        ctx.num_nodes = x.shape[0]
        return fused_gather_sum(x.detach(), senders, receivers, num_segments, edge_mask)

    @staticmethod
    def backward(ctx, g):
        senders, receivers, edge_mask = ctx.saved_tensors
        d_x = fused_gather_sum_rule(g, senders, receivers, ctx.num_nodes, edge_mask)
        return d_x, None, None, None, None


class _FusedGatherMean(torch.autograd.Function):
    """K5 with ``_fused_bwd``'s rule for op ``copy_count`` (``:72-74``) and
    the division outside it (``:475-487``): :func:`fused_gather_mean_rule`
    on the saved degree."""

    @staticmethod
    def forward(ctx, x, senders, receivers, num_segments, edge_mask):
        mean, deg = fused_gather_mean(x.detach(), senders, receivers, num_segments, edge_mask)
        ctx.mark_non_differentiable(deg)
        ctx.save_for_backward(deg, senders, receivers, edge_mask)
        ctx.num_nodes = x.shape[0]
        return mean, deg

    @staticmethod
    def backward(ctx, g_mean, _g_deg):
        deg, senders, receivers, edge_mask = ctx.saved_tensors
        d_x = fused_gather_mean_rule(g_mean, deg, senders, receivers, ctx.num_nodes, edge_mask)
        return d_x, None, None, None, None


def fused_gather_sum_vjp(x, senders, receivers, num_segments, edge_mask):
    """:func:`fused_gather_sum` (K4) with its backward rule; the wrapper
    itself where autograd records nothing. float32 out (bf16 ``x`` is
    upcast first)."""
    x = upcast(x)
    if not _records(x):
        return fused_gather_sum(x, senders, receivers, num_segments, edge_mask)
    return _FusedGatherSum.apply(x, senders, receivers, num_segments, edge_mask)


def fused_gather_mean_vjp(x, senders, receivers, num_segments, edge_mask):
    """:func:`fused_gather_mean` (K5) with its backward rule: ``(mean,
    deg)``, float32, ``deg`` without a gradient."""
    x = upcast(x)
    if not _records(x):
        return fused_gather_mean(x, senders, receivers, num_segments, edge_mask)
    return _FusedGatherMean.apply(x, senders, receivers, num_segments, edge_mask)


# ---------------------------------------------------------------------------
# K6 op "mul" (SchNet)
# ---------------------------------------------------------------------------


def _check_weighted_inputs(h, w, senders, receivers, num_segments):
    _check_node_table("h", h)
    e = _check_ids(senders, receivers, h.device)
    _check_f32("w", w, (e, h.shape[1]), h.device)
    _check_segments(num_segments)


def fused_gather_weighted_sum_plain(h, w, senders, receivers, num_segments):
    """Plain PyTorch version of :func:`fused_gather_weighted_sum`."""
    _check_weighted_inputs(h, w, senders, receivers, num_segments)
    return segment_sum_plain(_gather_rows(h, senders) * w, receivers, num_segments)


def fused_gather_weighted_sum(h: torch.Tensor, w: torch.Tensor,
                              senders: torch.Tensor, receivers: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """K6, SchNet's CFConv aggregation: ``out[r] += h[s] * w[e]`` over the
    edges ``e = s -> r``; ``w [E, F]`` comes masked. Returns ``[S, F]``
    float32, from ``torch.empty``: the C entry zeroes it on the current
    stream."""
    _check_weighted_inputs(h, w, senders, receivers, num_segments)
    if _on_cpu(h):
        return fused_gather_weighted_sum_plain(h, w, senders, receivers, num_segments)
    check_cuda_launch("fused_gather_weighted_sum", h, w, senders, receivers)
    n, d = h.shape
    num_segments = int(num_segments)
    out = h.new_empty((num_segments, d))
    rc = _build.entry("fused_mp", "hg_fused_gather_mul_f32")(
        h.data_ptr(), w.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        out.data_ptr(), senders.shape[0], n, d, num_segments, _stream(h.device),
    )
    if rc:
        _build.check(rc, "fused_gather_weighted_sum")
    fused_gather_weighted_sum.launches += 1
    return out


fused_gather_weighted_sum.launches = 0


def fused_gather_weighted_sum_rule(g, h, w, senders, receivers, need_h=True, need_w=True):
    """K6's backward rule (``_fused_bwd`` for op ``mul``, ``:77-79``):
    ``d_h`` is K6 with the two id arrays swapped, ``d_h[s] = sum_{e: snd=s}
    g[r_e] * w[e]``; ``d_w[e] = h[s_e] * g[r_e]`` (the JAX rule's ``d_ef =
    xs * ge``) in PyTorch, zero where either id is out of range. Returns
    ``(d_h, d_w)``, ``None`` for one not asked for."""
    g = g.contiguous()
    d_h = (fused_gather_weighted_sum(g, w, receivers, senders, h.shape[0])
           if need_h else None)
    d_w = _gather_rows(h, senders) * gather_cotangent(g, receivers) if need_w else None
    return d_h, d_w


class _FusedGatherWeightedSum(torch.autograd.Function):
    """K6 with :func:`fused_gather_weighted_sum_rule`."""

    @staticmethod
    def forward(ctx, h, w, senders, receivers, num_segments):
        ctx.save_for_backward(h, w, senders, receivers)
        return fused_gather_weighted_sum(h.detach(), w.detach(), senders, receivers,
                                         num_segments)

    @staticmethod
    def backward(ctx, g):
        h, w, senders, receivers = ctx.saved_tensors
        d_h, d_w = fused_gather_weighted_sum_rule(
            g, h, w, senders, receivers, *ctx.needs_input_grad[:2])
        return d_h, d_w, None, None, None


def fused_gather_weighted_sum_vjp(h, w, senders, receivers, num_segments):
    """:func:`fused_gather_weighted_sum` (K6) with its backward rule;
    float32 out (bf16 ``h`` and ``w`` are upcast first)."""
    h, w = upcast(h), upcast(w)
    if not _records(h, w):
        return fused_gather_weighted_sum(h, w, senders, receivers, num_segments)
    return _FusedGatherWeightedSum.apply(h, w, senders, receivers, num_segments)


# ---------------------------------------------------------------------------
# K7: op "egnn" (EGNN's edge phase)
# ---------------------------------------------------------------------------


def _check_egnn_inputs(y_snd, y_rcv, pos, edge_params, senders, receivers,
                       num_segments, edge_mask, ze):
    _check_node_table("y_snd", y_snd)
    n, h = y_snd.shape
    dev = y_snd.device
    _check_f32("y_rcv", y_rcv, (n, h), dev)
    _check_f32("pos", pos, (n, 3), dev)
    e = _check_ids(senders, receivers, dev)
    _check_mask(edge_mask, e, dev)
    if ze is not None:
        _check_f32("ze", ze, (e, h), dev)
    _check_segments(num_segments)
    if len(edge_params) not in (3, 6):
        raise ValueError(
            "edge_params must be (w_rad, W2, b2) or (w_rad, W2, b2, Wc0, bc0, Wc1), "
            f"got {len(edge_params)} tensors"
        )
    names = ("w_rad", "W2", "b2", "Wc0", "bc0", "Wc1")
    shapes = ((h,), (h, h), (h,), (h, h), (h,), (h, 1))
    for name, p, shape in zip(names, edge_params, shapes):
        _check_f32(name, p, shape, dev)


def _egnn_messages(xs, xr, pos_s, pos_r, edge_params, mask, ze=None):
    """K7's edge body on gathered rows (``mask [E, 1]`` float): the packed
    per-edge message ``[e, (trans,) mask]`` that the kernel sums at the
    senders. The plain version's and the backward rule's (which pulls its
    cotangent back through it), as the JAX rule recomputes ``_op_egnn``."""
    w_rad, w2, b2 = edge_params[:3]
    coord_diff = pos_s - pos_r
    radial = (coord_diff * coord_diff).sum(-1, keepdim=True)
    # the double-where safe sqrt: a zero distance gives 0, never NaN, and
    # a zero gradient
    nonzero = radial > 0
    norm = torch.where(nonzero, torch.sqrt(torch.where(nonzero, radial, 1.0)), 0.0)
    coord_diff = coord_diff / (norm + 1.0)
    pre = xs + xr + radial * w_rad
    if ze is not None:
        pre = pre + ze
    e = torch.relu(torch.relu(pre) @ w2 + b2) * mask
    if len(edge_params) == 6:
        wc0, bc0, wc1 = edge_params[3:]
        cw = torch.tanh(torch.relu(e @ wc0 + bc0) @ wc1)
        trans = torch.clamp(coord_diff * cw, -100.0, 100.0) * mask
        return torch.cat([e, trans, mask], dim=1)
    return torch.cat([e, mask], dim=1)


def fused_egnn_edge_phase_plain(y_snd, y_rcv, pos, edge_params, senders,
                                receivers, num_segments, edge_mask, ze=None):
    """Plain PyTorch version of :func:`fused_egnn_edge_phase`: the edge
    MLP on gathered rows, then one ``index_add_`` of the packed messages at
    the senders."""
    _check_egnn_inputs(y_snd, y_rcv, pos, edge_params, senders, receivers,
                       num_segments, edge_mask, ze)
    msg = _egnn_messages(
        _gather_rows(y_snd, senders), _gather_rows(y_rcv, receivers),
        _gather_rows(pos, senders), _gather_rows(pos, receivers), edge_params,
        edge_mask.to(torch.float32)[:, None], ze,
    )
    return segment_sum_plain(msg, senders, num_segments)


def egnn_tolerance(out: torch.Tensor) -> float:
    """K7 against its plain version: ``1e-4 * (max |out| + 1)``. Each
    message element ends two H-term dot products (256 terms on the main
    path) that the kernel sums in another order than PyTorch's matmul, and
    the atomics add in a run-dependent order; the message columns are
    ``relu(...) * mask >= 0``, so no partial sum exceeds the final one."""
    return 1e-4 * (float(out.abs().max()) + 1.0) if out.numel() else 1e-4


def egnn_shared_bytes(hidden: int) -> int:
    """Dynamic shared memory K7 needs at width ``hidden`` (its C entry's
    own count), or -1 when the kernel has no instantiation that wide."""
    return int(_build.entry("fused_egnn", "hg_fused_egnn_smem_bytes")(int(hidden)))


EGNN_MAX_SHARED_BYTES = 232448  # what one block may use on sm_90


def fused_egnn_edge_phase(y_snd: torch.Tensor, y_rcv: torch.Tensor,
                          pos: torch.Tensor, edge_params: Sequence[torch.Tensor],
                          senders: torch.Tensor, receivers: torch.Tensor,
                          num_segments: int, edge_mask: torch.Tensor,
                          ze: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7, EGNN's whole edge phase fused with its sender-side reduction.

    Per edge ``s -> r``: ``coord_diff = pos[s] - pos[r]``, ``radial =
    |coord_diff|^2``, ``e = relu(relu(y_snd[s] + y_rcv[r] + radial * w_rad
    (+ ze)) @ W2 + b2) * mask``; with the coordinate parameters present,
    ``cw = tanh(relu(e @ Wc0 + bc0) @ Wc1)`` and ``trans = clip(coord_diff
    / (sqrt(radial) + 1) * cw, -100, 100) * mask``. ``[e, (trans,) mask]``
    is summed at the **senders**.

    ``edge_params`` is ``(w_rad [H], W2 [H, H], b2 [H])`` or that plus
    ``(Wc0 [H, H], bc0 [H], Wc1 [H, 1])``, matrices in the ``x @ W``
    layout. Returns ``[S, H + 4]`` (coordinate parameters present) or
    ``[S, H + 1]`` float32.

    On the card the result is a view of the first columns of a
    ``torch.empty`` buffer whose rows are padded to a multiple of 4 floats
    (16 bytes, so the kernel's atomics go four floats at a time); the C
    entry zeroes that buffer on the current stream before the kernel."""
    _check_egnn_inputs(y_snd, y_rcv, pos, edge_params, senders, receivers,
                       num_segments, edge_mask, ze)
    if _on_cpu(y_snd):
        return fused_egnn_edge_phase_plain(
            y_snd, y_rcv, pos, edge_params, senders, receivers, num_segments,
            edge_mask, ze,
        )
    n, h = y_snd.shape
    mask = edge_mask.to(torch.float32)
    params = list(edge_params) + [None] * (6 - len(edge_params))
    tensors = [y_snd, y_rcv, pos, senders, receivers, mask]
    tensors += [t for t in [ze] + params if t is not None]
    check_cuda_launch("fused_egnn_edge_phase", *tensors)
    smem = egnn_shared_bytes(h)
    if not 0 < smem <= EGNN_MAX_SHARED_BYTES:
        raise ValueError(
            f"fused_egnn_edge_phase: hidden width {h} does not fit the kernel "
            f"({smem} bytes of shared memory; widths up to 256 are built)"
        )
    width = h + (4 if len(edge_params) == 6 else 1)
    ldo = -(-width // 4) * 4  # rows 16-byte aligned, for the vector atomics
    out = y_snd.new_empty((num_segments, ldo))  # zeroed by the C entry
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _build.entry("fused_egnn", "hg_fused_egnn_f32")(
        y_snd.data_ptr(), y_rcv.data_ptr(), pos.data_ptr(), ptr(ze), mask.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), *[ptr(p) for p in params],
        out.data_ptr(), senders.shape[0], n, h, num_segments, ldo, _stream(y_snd.device),
    )
    _build.check(rc, "fused_egnn_edge_phase")
    fused_egnn_edge_phase.launches += 1
    return out[:, :width]


fused_egnn_edge_phase.launches = 0


def fused_egnn_edge_phase_rule(g, y_snd, y_rcv, pos, edge_params, senders, receivers,
                               edge_mask, ze=None, needs=None):
    """K7's backward rule (``_fused_bwd`` for op ``egnn``, ``:97-149``):
    the edge body recomputed per edge from the saved inputs
    (:func:`_egnn_messages`), the cotangent of the packed sum gathered at
    the **senders** (K7's reduce ids; zero out of range) and pulled back by
    ``torch.autograd.grad``; the node rows' cotangents folded through K1,
    ``y_snd``'s and ``pos``'s sender half at the senders, ``y_rcv``'s and
    ``pos``'s receiver half at the receivers. ``pos`` gets its gradient as
    JAX's ``node_a = [y_snd, pos]`` and ``node_b = [y_rcv, pos]`` do: with
    ``equivariance`` each layer's ``pos`` feeds the next layer's radial
    term. A zero distance (a padded edge) goes through the double-where
    square root: a zero gradient, never NaN.

    ``needs``: which of ``(y_snd, y_rcv, pos, ze, *edge_params)`` want a
    gradient (default all present). Returns ``(d_y_snd, d_y_rcv, d_pos,
    d_ze, [d_params])``, ``None`` for each not asked for."""
    inputs = [y_snd, y_rcv, pos, ze] + list(edge_params)
    if needs is None:
        needs = [t is not None for t in inputs]
    n = y_snd.shape[0]
    y_snd, y_rcv, pos = y_snd.detach(), y_rcv.detach(), pos.detach()
    mask = edge_mask.to(torch.float32)[:, None]
    with torch.enable_grad():
        leaves = [_gather_rows(y_snd, senders), _gather_rows(y_rcv, receivers),
                  _gather_rows(pos, senders), _gather_rows(pos, receivers),
                  None if ze is None else ze.detach()] + [p.detach() for p in edge_params]
        want = [needs[0], needs[1], needs[2], needs[2]] + list(needs[3:])
        for t, w in zip(leaves, want):
            if t is not None:
                t.requires_grad_(bool(w))
        xs, xr, pos_s, pos_r, ze_leaf = leaves[:5]
        msg = _egnn_messages(xs, xr, pos_s, pos_r, leaves[5:], mask, ze_leaf)
        asked = [t for t, w in zip(leaves, want) if w]
        grads = iter(torch.autograd.grad(msg, asked, gather_cotangent(g.contiguous(), senders)))
    d = [next(grads) if w else None for w in want]
    fold = lambda t, ids: segment_sum(t.contiguous(), ids, n)  # noqa: E731
    d_y_snd = None if d[0] is None else fold(d[0], senders)
    d_y_rcv = None if d[1] is None else fold(d[1], receivers)
    d_pos = None if d[2] is None else fold(d[2], senders) + fold(d[3], receivers)
    return d_y_snd, d_y_rcv, d_pos, d[4], d[5:]


class _FusedEgnnEdgePhase(torch.autograd.Function):
    """K7 with :func:`fused_egnn_edge_phase_rule`; the edge parameters come
    last, as many as are given (3 or 6)."""

    @staticmethod
    def forward(ctx, y_snd, y_rcv, pos, ze, senders, receivers, num_segments, edge_mask,
                *edge_params):
        ctx.save_for_backward(y_snd, y_rcv, pos, ze, senders, receivers, edge_mask,
                              *edge_params)
        return fused_egnn_edge_phase(
            y_snd.detach(), y_rcv.detach(), pos.detach(), [p.detach() for p in edge_params],
            senders, receivers, num_segments, edge_mask,
            None if ze is None else ze.detach(),
        )

    @staticmethod
    def backward(ctx, g):
        y_snd, y_rcv, pos, ze, senders, receivers, edge_mask, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        d_y_snd, d_y_rcv, d_pos, d_ze, d_params = fused_egnn_edge_phase_rule(
            g, y_snd, y_rcv, pos, params, senders, receivers, edge_mask, ze,
            needs=needs[:4] + needs[8:],
        )
        return (d_y_snd, d_y_rcv, d_pos, d_ze, None, None, None, None, *d_params)


def fused_egnn_edge_phase_vjp(y_snd: torch.Tensor, y_rcv: torch.Tensor,
                              pos: torch.Tensor, edge_params: Sequence[torch.Tensor],
                              senders: torch.Tensor, receivers: torch.Tensor,
                              num_segments: int, edge_mask: torch.Tensor,
                              ze: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`fused_egnn_edge_phase` (K7) with its backward rule; float32
    out (bf16 inputs and parameters are upcast first)."""
    y_snd, y_rcv, pos, ze = upcast(y_snd), upcast(y_rcv), upcast(pos), upcast(ze)
    edge_params = [upcast(p) for p in edge_params]
    if not _records(y_snd, y_rcv, pos, ze, *edge_params):
        return fused_egnn_edge_phase(y_snd, y_rcv, pos, edge_params, senders, receivers,
                                     num_segments, edge_mask, ze)
    return _FusedEgnnEdgePhase.apply(y_snd, y_rcv, pos, ze, senders, receivers,
                                     num_segments, edge_mask, *edge_params)
