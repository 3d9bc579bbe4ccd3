"""Segment sum and segment moments: CUDA kernels and their plain versions.

Port of ``hydragnn_tpu/ops/pallas_segment.py``. Two functions with the
TPU kernels' contract, each a wrapper over a CUDA kernel
(``csrc/segment.cu``) with a plain PyTorch version beside it:

- :func:`segment_sum` (K1, replaces ``segment_sum_onehot``):
  ``out[s] = sum_{e: ids[e]==s} data[e]``;
- :func:`segment_moments` (K2, replaces ``segment_moments``): sum, count
  and sum of squares per segment in one pass; count is every in-range id,
  unweighted.

Ids outside ``[0, S)`` add nothing. Data is ``[E, D]`` float32 (callers
upcast bf16 with :func:`upcast`), ids ``[E]`` int32; outputs are float32.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back. A wrapper
is forward-only: a CUDA input that requires grad, with grad enabled,
raises ``NotImplementedError``. Gradients go through
:func:`segment_sum_vjp` and :func:`segment_moments_vjp`, each a
``torch.autograd.Function`` around the wrapper (kernel on the card, plain
version on the CPU) whose backward rule is the JAX package's custom VJP
(``_segment_sum_bwd``, ``_moments_bwd``): a masked gather of the
cotangent, written in PyTorch. Each wrapper counts its kernel launches in
``<wrapper>.launches``.

Kernel against plain on the card: atomics add in a run-dependent order, so
the tolerance is relative, ``1e-5 * (max |partial sum| + 1)``.

The K1 call is kept lean, since at the pool's size the host's work per call
is as long as the kernel: its checks take one combined test on the common
path, its C function is looked up once (:func:`_build.entry`), the output
comes from ``torch.empty`` and the C entry zeroes it on the stream
(``cudaMemsetAsync``), so no PyTorch fill kernel runs before it.
"""

import torch

from hydragnn_tpu_torch.ops import _build

_F32, _I32 = torch.float32, torch.int32


def check_segment_inputs(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int):
    """Raise on what the kernels do not take (both devices alike)."""
    if data.ndim != 2:
        raise ValueError(f"data must be 2-D [E, D], got shape {tuple(data.shape)}")
    if data.dtype != torch.float32:
        raise TypeError(f"data must be float32, got {data.dtype}")
    if segment_ids.dtype != torch.int32 or segment_ids.ndim != 1:
        raise TypeError(
            f"segment_ids must be 1-D int32, got {segment_ids.dtype} "
            f"shape {tuple(segment_ids.shape)}"
        )
    if segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"{segment_ids.shape[0]} ids for {data.shape[0]} data rows"
        )
    if segment_ids.device != data.device:
        raise ValueError(
            f"data on {data.device} but segment_ids on {segment_ids.device}"
        )
    if not 0 <= int(num_segments) < 2**31:
        raise ValueError(f"num_segments out of range: {num_segments}")


def check_cuda_launch(name: str, *tensors: torch.Tensor):
    """The conditions every CUDA launch needs beyond the shape contract.
    A parameter that requires grad is taken where autograd records nothing
    (under ``torch.inference_mode()`` or ``torch.no_grad()``)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: the kernel wrapper is forward-only (run it under "
                "torch.inference_mode()); gradients go through its *_vjp "
                f"twin ({name}_vjp), the autograd Function with the "
                "kernel's backward rule"
            )


def atomic_tolerance(abs_sums: torch.Tensor) -> float:
    """Kernel-against-plain tolerance for an f32 sum taken with atomics in
    a run-dependent order: ``1e-5 * (max |partial sum| + 1)``, where every
    partial sum is bounded by the segment's sum of absolute values."""
    return 1e-5 * (float(abs_sums.abs().max()) + 1.0) if abs_sums.numel() else 1e-5


def upcast(t):
    """``t`` in float32 where it is bf16 or f16 (a kernel's input), else
    ``t`` itself (float64 stays float64; ``None`` stays ``None``). Outside
    an autograd Function, so the gradient comes back at ``t``'s dtype."""
    if t is not None and t.dtype in (torch.bfloat16, torch.float16):
        return t.to(torch.float32)
    return t


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"tensors on {t.device} are not supported")
    return False


def _stream(device):
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# K1: segment_sum
# ---------------------------------------------------------------------------


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum` (``index_add_``)."""
    check_segment_inputs(data, segment_ids, num_segments)
    out = torch.zeros(
        (num_segments, data.shape[1]), dtype=torch.float32, device=data.device
    )
    if num_segments == 0:  # no row 0 to park the out-of-range ids at
        return out
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    safe = torch.where(valid, segment_ids, 0)
    return out.index_add_(0, safe, torch.where(valid[:, None], data, 0.0))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """K1: ``out[s] = sum_{e: ids[e]==s} data[e]`` -> ``[S, D]`` float32.

    On the card, the C entry zeroes the ``torch.empty`` output on the
    current stream, then reduces each run of equal ids in registers before
    one atomic (``csrc/segment.cu``). The common case (contiguous f32 data
    and int32 ids on one card, nothing that autograd would record) is one
    test of every condition :func:`check_segment_inputs` and
    :func:`check_cuda_launch` check; anything else goes through them,
    which raise on what the kernel does not take."""
    if not (
        data.is_cuda and segment_ids.is_cuda
        and data.dtype is _F32 and segment_ids.dtype is _I32
        and data.dim() == 2 and segment_ids.dim() == 1
        and segment_ids.shape[0] == data.shape[0]
        and segment_ids.get_device() == data.get_device()
        and type(num_segments) is int and 0 <= num_segments < 2**31
        and data.is_contiguous() and segment_ids.is_contiguous()
        and not (data.requires_grad or segment_ids.requires_grad)
    ):
        check_segment_inputs(data, segment_ids, num_segments)
        if _on_cpu(data):
            return segment_sum_plain(data, segment_ids, num_segments)
        check_cuda_launch("segment_sum", data, segment_ids)
        num_segments = int(num_segments)
    e, d = data.shape
    out = data.new_empty((num_segments, d))
    rc = _build.entry("segment", "hg_segment_sum_f32")(
        data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), e, d,
        num_segments, _stream(data.device),
    )
    if rc:
        _build.check(rc, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


# ---------------------------------------------------------------------------
# K2: segment_moments
# ---------------------------------------------------------------------------


def moments_layout(d: int):
    """Where K2 and K3 put their statistics in a packed ``[S, ldo]`` row:
    ``[sum (D) | pad | sum of squares (D) | pad | count | pad]``, each part
    starting a multiple of 4 floats (16 bytes) into the row and ``ldo`` a
    multiple of 4, so that on the float4 path every run goes out as
    16-byte atomics. Returns ``(sq_off, cnt_off, ldo)``."""
    d4 = -(-d // 4) * 4
    return d4, 2 * d4, 2 * d4 + 4


def moments_views(out: torch.Tensor, d: int):
    """``(sum [S, D], count [S, 1], sum_of_squares [S, D])``: views of the
    packed ``[S, ldo]`` row ``out``."""
    sq_off, cnt_off, _ = moments_layout(d)
    return out[:, :d], out[:, cnt_off : cnt_off + 1], out[:, sq_off : sq_off + d]


def moments_row(s: torch.Tensor) -> torch.Tensor:
    """The packed ``[S, ldo]`` row whose first columns the sum view ``s``
    of :func:`moments_views` is, over the same memory (inference tensors
    keep no ``_base``)."""
    ldo = moments_layout(s.shape[1])[2]
    if s.stride() != (ldo, 1):
        raise ValueError("not the sum view of a packed moments row")
    return s.as_strided((s.shape[0], ldo), (ldo, 1))


def pack_moments_rows(z: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``[E, ldo]`` rows ``[z | pad | z^2 | pad | count | pad]`` laid out by
    :func:`moments_layout` (zero padding); ``count`` is ``[E]``."""
    d = z.shape[1]
    sq_off, cnt_off, ldo = moments_layout(d)
    rows = z.new_zeros((z.shape[0], ldo))
    rows[:, :d] = z
    rows[:, sq_off : sq_off + d] = z * z
    rows[:, cnt_off] = count
    return rows


def segment_moments_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int):
    """Plain PyTorch version of :func:`segment_moments`: one ``index_add_``
    of the rows :func:`pack_moments_rows` lays out."""
    check_segment_inputs(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
    out = segment_sum_plain(pack_moments_rows(data, ones), segment_ids, num_segments)
    return moments_views(out, data.shape[1])


def segment_moments(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int):
    """K2: ``(sum [S, D], count [S, 1], sum_of_squares [S, D])`` per
    segment in one pass. ``count`` counts every in-range id, unweighted.

    The three are views of one packed ``[S, ldo]`` row
    (:func:`moments_views`). On the card it comes from ``torch.empty`` and
    the C entry zeroes it on the current stream; each run of equal ids is
    reduced in registers before one atomic per part
    (``csrc/gather_reduce.cuh``)."""
    check_segment_inputs(data, segment_ids, num_segments)
    if _on_cpu(data):
        return segment_moments_plain(data, segment_ids, num_segments)
    check_cuda_launch("segment_moments", data, segment_ids)
    e, d = data.shape
    num_segments = int(num_segments)
    sq_off, cnt_off, ldo = moments_layout(d)
    out = data.new_empty((num_segments, ldo))
    rc = _build.entry("segment", "hg_segment_moments_f32")(
        data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), e, d, num_segments,
        ldo, sq_off, cnt_off, _stream(data.device),
    )
    if rc:
        _build.check(rc, "segment_moments")
    segment_moments.launches += 1
    return moments_views(out, d)


segment_moments.launches = 0


# ---------------------------------------------------------------------------
# backward rules of K1 and K2 (the JAX package's custom VJPs)
# ---------------------------------------------------------------------------


def gather_cotangent(g: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """``g[ids]`` per row, and exactly zero for an id outside ``[0, S)``:
    such an edge added nothing forward (a bare ``g[ids]`` would read
    another segment's cotangent)."""
    s = g.shape[0]
    if s == 0:
        return g.new_zeros((segment_ids.shape[0],) + tuple(g.shape[1:]))
    valid = (segment_ids >= 0) & (segment_ids < s)
    rows = g.index_select(0, torch.where(valid, segment_ids, 0))
    return torch.where(valid[:, None], rows, 0.0)


class _SegmentSum(torch.autograd.Function):
    """K1 with ``_segment_sum_bwd``'s rule (``pallas_segment.py:153-161``):
    ``d data = g[ids]``, zero where an id is out of range; no gradient for
    the ids."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return segment_sum(data.detach(), segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return gather_cotangent(g, segment_ids), None, None


class _SegmentMoments(torch.autograd.Function):
    """K2 with ``_moments_bwd``'s rule (``pallas_segment.py:237-245``):
    ``d data = g_sum[ids] + 2 data g_sq[ids]``, zero where an id is out of
    range; the count gets no gradient. Returns the packed ``[S, ldo]`` row;
    the caller takes :func:`moments_views` of it, so that the views share
    one base outside the Function."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        data = data.detach()
        ctx.save_for_backward(data, segment_ids)
        return moments_row(segment_moments(data, segment_ids, num_segments)[0])

    @staticmethod
    def backward(ctx, g):
        data, segment_ids = ctx.saved_tensors
        d = data.shape[1]
        sq_off, _, _ = moments_layout(d)
        rows = gather_cotangent(g, segment_ids)  # zero rows out of range
        return rows[:, :d] + 2.0 * data * rows[:, sq_off : sq_off + d], None, None


# Where autograd records nothing (serving, under inference_mode) the *_vjp
# functions call the wrapper itself: a Function's apply costs the host
# 7-21 us a call on the H100 machine (tools/vjp_dispatch_cost.py, PERF.md),
# and serving is host-paced.


def segment_sum_vjp(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """:func:`segment_sum` (K1) with its backward rule."""
    if not (torch.is_grad_enabled() and data.requires_grad):
        return segment_sum(data, segment_ids, num_segments)
    return _SegmentSum.apply(data, segment_ids, num_segments)


def segment_moments_vjp(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int):
    """:func:`segment_moments` (K2) with its backward rule: ``(sum, count,
    sum_of_squares)``, views of one packed row, float32 (bf16 data is
    upcast first)."""
    data = upcast(data)
    if not (torch.is_grad_enabled() and data.requires_grad):
        return segment_moments(data, segment_ids, num_segments)
    return moments_views(
        _SegmentMoments.apply(data, segment_ids, num_segments), data.shape[1]
    )
