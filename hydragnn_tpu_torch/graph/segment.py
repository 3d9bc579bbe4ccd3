"""Segment reductions — the substrate of message passing (port of
``graph/segment.py``).

All ops take the segment count explicitly and are safe under padding:
padded edges carry zeroed data or are masked by the caller; padded
segments give the reduction's identity (0 for sums, ``fill`` for min/max).
"""

import torch

from hydragnn_tpu_torch.ops import segment_kernels
from hydragnn_tpu_torch.ops.segment_kernels import upcast


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum per segment through the K1 kernel (its plain version on the CPU),
    with K1's backward rule (``segment_kernels.segment_sum_vjp``).

    Low precision in, f32 accumulate, the caller's dtype back: bf16/f16
    data is summed in float32 and the result cast back."""
    in_dtype = data.dtype
    data = upcast(data)
    flat = data.reshape(data.shape[0], -1)
    out = segment_kernels.segment_sum_vjp(flat.contiguous(), segment_ids, num_segments)
    out = out.reshape((num_segments,) + tuple(data.shape[1:]))
    return out.to(in_dtype) if out.dtype != in_dtype else out


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  weights: torch.Tensor = None) -> torch.Tensor:
    """Elements per segment (in-degree when the ids are edge receivers), or
    the sum of ``weights`` per segment. Ids outside ``[0, S)`` count
    nothing."""
    ones = (
        torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
        if weights is None
        else weights.to(torch.float32)
    )
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=segment_ids.device)
    return out.index_add_(0, torch.where(valid, segment_ids, 0), torch.where(valid, ones, 0.0))


def segment_minmax_fused(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int, fill: float = 0.0,
                         has: torch.Tensor = None):
    """``(min, max)`` per segment from one packed ``scatter_reduce`` (amax)
    of ``[data, -data]``.

    Empty segments, and entries that come out non-finite, get ``fill``.
    ``has``: an optional precomputed non-empty mask (PNA passes the one its
    moments pass produced). Ids outside ``[0, S)`` add nothing.

    The gradient of a max is split evenly among the entries tied at it
    (``scatter_reduce``'s rule, as JAX's scatter-max JVP splits it): two
    equal ``z`` at one receiver, as a duplicate edge gives, get half each."""
    d = data.shape[1]
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    packed = torch.where(
        valid[:, None], torch.cat([data, -data], dim=1), float("-inf")
    )
    index = torch.where(valid, segment_ids, 0).to(torch.int64)[:, None]
    out = torch.full(
        (num_segments, 2 * d), float("-inf"), dtype=data.dtype, device=data.device
    )
    out = out.scatter_reduce_(0, index.expand_as(packed), packed, "amax")
    if has is None:
        has = segment_count(segment_ids, num_segments) > 0
    has = has.reshape(-1, 1)
    mx_raw = out[:, :d]
    mn_raw = -out[:, d:]
    mx = torch.where(has & torch.isfinite(mx_raw), mx_raw, fill)
    mn = torch.where(has & torch.isfinite(mn_raw), mn_raw, fill)
    return mn, mx


def segment_moments_fused(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int, weights: torch.Tensor = None):
    """``(sum, count, sum_of_squares)`` per segment from one segment sum of
    the packed ``[data, data^2, weights]`` columns. ``weights``: optional
    ``[E]`` count weights (e.g. an edge mask); default 1 per element."""
    d = data.shape[1]
    w = (
        torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
        if weights is None
        else weights.to(torch.float32)
    )
    packed = torch.cat([data, data * data, w[:, None].to(data.dtype)], dim=1)
    s = segment_sum(packed, segment_ids, num_segments)
    return s[:, :d], s[:, -1:], s[:, d : 2 * d]
