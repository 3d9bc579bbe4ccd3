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
upcast), ids ``[E]`` int32; outputs are float32.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back. The kernels
are forward-only: a CUDA input that requires grad raises
``NotImplementedError`` (the backward rules are queued in ``ROADMAP.md``).
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

Kernel against plain on the card: atomics add in a run-dependent order, so
the tolerance is relative, ``1e-5 * (max |partial sum| + 1)``.
"""

import torch

from hydragnn_tpu_torch.ops import _build


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
    """The conditions every CUDA launch needs beyond the shape contract."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                f"{name}: the CUDA kernel is forward-only; its backward rule "
                "is queued in ROADMAP.md (run under torch.inference_mode())"
            )


def atomic_tolerance(abs_sums: torch.Tensor) -> float:
    """Kernel-against-plain tolerance for an f32 sum taken with atomics in
    a run-dependent order: ``1e-5 * (max |partial sum| + 1)``, where every
    partial sum is bounded by the segment's sum of absolute values."""
    return 1e-5 * (float(abs_sums.abs().max()) + 1.0) if abs_sums.numel() else 1e-5


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"tensors on {t.device} are not supported")
    return False


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: segment_sum
# ---------------------------------------------------------------------------


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum` (``index_add_``)."""
    check_segment_inputs(data, segment_ids, num_segments)
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    safe = torch.where(valid, segment_ids, 0)
    out = torch.zeros(
        (num_segments, data.shape[1]), dtype=torch.float32, device=data.device
    )
    return out.index_add_(0, safe, torch.where(valid[:, None], data, 0.0))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """K1: ``out[s] = sum_{e: ids[e]==s} data[e]`` -> ``[S, D]`` float32."""
    check_segment_inputs(data, segment_ids, num_segments)
    if _on_cpu(data):
        return segment_sum_plain(data, segment_ids, num_segments)
    check_cuda_launch("segment_sum", data, segment_ids)
    e, d = data.shape
    out = torch.zeros((num_segments, d), dtype=torch.float32, device=data.device)
    rc = _build.load("segment").hg_segment_sum_f32(
        data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), e, d,
        num_segments, _stream(data.device),
    )
    _build.check(rc, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


# ---------------------------------------------------------------------------
# K2: segment_moments
# ---------------------------------------------------------------------------


def segment_moments_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int):
    """Plain PyTorch version of :func:`segment_moments`: one ``index_add_``
    of the packed ``[data, data^2, 1]`` columns."""
    check_segment_inputs(data, segment_ids, num_segments)
    d = data.shape[1]
    ones = torch.ones((data.shape[0], 1), dtype=torch.float32, device=data.device)
    out = segment_sum_plain(
        torch.cat([data, data * data, ones], dim=1), segment_ids, num_segments
    )
    return out[:, :d], out[:, 2 * d :], out[:, d : 2 * d]


def segment_moments(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int):
    """K2: ``(sum [S, D], count [S, 1], sum_of_squares [S, D])`` per
    segment in one pass. ``count`` counts every in-range id, unweighted."""
    check_segment_inputs(data, segment_ids, num_segments)
    if _on_cpu(data):
        return segment_moments_plain(data, segment_ids, num_segments)
    check_cuda_launch("segment_moments", data, segment_ids)
    e, d = data.shape
    dev = data.device
    s = torch.zeros((num_segments, d), dtype=torch.float32, device=dev)
    cnt = torch.zeros((num_segments, 1), dtype=torch.float32, device=dev)
    sq = torch.zeros((num_segments, d), dtype=torch.float32, device=dev)
    rc = _build.load("segment").hg_segment_moments_f32(
        data.data_ptr(), segment_ids.data_ptr(), s.data_ptr(), cnt.data_ptr(),
        sq.data_ptr(), e, d, num_segments, _stream(dev),
    )
    _build.check(rc, "segment_moments")
    segment_moments.launches += 1
    return s, cnt, sq


segment_moments.launches = 0
