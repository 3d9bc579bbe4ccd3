"""Fused message passing: gather -> edge op -> segment reduce in one kernel.

Port of ``hydragnn_tpu/ops/fused_mp.py``. Of its edge ops, the PNA path
runs only ``moments``, through :func:`fused_gather_moments` (K3), a
wrapper over the CUDA kernel in ``csrc/fused_mp.cu`` with a plain PyTorch
version beside it. The other ops (``copy``, ``copy_count``, ``mul``,
``egnn``) belong to stacks the port does not have yet and raise
``NotImplementedError``; ``ROADMAP.md`` queues them.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. The kernel is forward-only.
Launches are counted in ``fused_gather_moments.launches``. Kernel against
plain on the card: relative tolerance ``1e-5 * (max |partial sum| + 1)``
(atomics add in a run-dependent order).
"""

from typing import Optional

import torch

from hydragnn_tpu_torch.ops import _build
from hydragnn_tpu_torch.ops.segment_kernels import (
    _on_cpu,
    _stream,
    check_cuda_launch,
    segment_sum_plain,
)


def _check_moments_inputs(yj, senders, receivers, num_segments, edge_mask, ze):
    if yj.ndim != 2 or yj.dtype != torch.float32:
        raise TypeError(
            f"yj must be 2-D float32, got {yj.dtype} shape {tuple(yj.shape)}"
        )
    e = senders.shape[0]
    for name, ids in (("senders", senders), ("receivers", receivers)):
        if ids.dtype != torch.int32 or ids.ndim != 1 or ids.shape[0] != e:
            raise TypeError(f"{name} must be 1-D int32 of length {e}")
    if edge_mask.ndim != 1 or edge_mask.shape[0] != e:
        raise ValueError(f"edge_mask must be 1-D of length {e}")
    if ze is not None and (ze.dtype != torch.float32 or tuple(ze.shape) != (e, yj.shape[1])):
        raise TypeError(
            f"ze must be float32 [{e}, {yj.shape[1]}], got {ze.dtype} "
            f"shape {tuple(ze.shape)}"
        )
    for t in (senders, receivers, edge_mask) + (() if ze is None else (ze,)):
        if t.device != yj.device:
            raise ValueError("all inputs must be on one device")
    if not 0 <= int(num_segments) < 2**31:
        raise ValueError(f"num_segments out of range: {num_segments}")


def fused_gather_moments_plain(yj, senders, receivers, num_segments,
                               edge_mask, ze=None):
    """Plain PyTorch version of :func:`fused_gather_moments`: a gather that
    reads a zero row for out-of-range senders, then one ``index_add_`` of
    the packed ``[z, z^2, mask]`` columns at the receivers."""
    _check_moments_inputs(yj, senders, receivers, num_segments, edge_mask, ze)
    n, d = yj.shape
    valid = (senders >= 0) & (senders < n)
    xs = torch.where(valid[:, None], yj[torch.where(valid, senders, 0)], 0.0)
    if ze is not None:
        xs = xs + ze
    mask = edge_mask.to(torch.float32)[:, None]
    z = xs * mask
    out = segment_sum_plain(
        torch.cat([z, z * z, mask], dim=1), receivers, num_segments
    )
    return out[:, :d], out[:, 2 * d :], out[:, d : 2 * d], z


def fused_gather_moments(yj: torch.Tensor, senders: torch.Tensor,
                         receivers: torch.Tensor, num_segments: int,
                         edge_mask: torch.Tensor,
                         ze: Optional[torch.Tensor] = None):
    """K3, PNA's statistics pass: ``z = (yj[senders] (+ ze)) * mask`` with
    (sum, count, sum of squares) reduced at the receivers and ``z``
    returned per edge for the min/max pass. Out-of-range senders gather a
    zero row; out-of-range receivers add nothing; count sums the mask.

    Returns ``(s [S, D], cnt [S, 1], sq [S, D], z [E, D])``, float32."""
    _check_moments_inputs(yj, senders, receivers, num_segments, edge_mask, ze)
    if _on_cpu(yj):
        return fused_gather_moments_plain(
            yj, senders, receivers, num_segments, edge_mask, ze
        )
    mask = edge_mask.to(torch.float32)
    tensors = (yj, senders, receivers, mask) + (() if ze is None else (ze,))
    check_cuda_launch("fused_gather_moments", *tensors)
    n, d = yj.shape
    e = senders.shape[0]
    out = torch.zeros((num_segments, 2 * d + 1), dtype=torch.float32, device=yj.device)
    z = torch.empty((e, d), dtype=torch.float32, device=yj.device)
    rc = _build.load("fused_mp").hg_fused_gather_moments_f32(
        yj.data_ptr(), None if ze is None else ze.data_ptr(), mask.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), out.data_ptr(), z.data_ptr(),
        e, n, d, num_segments, _stream(yj.device),
    )
    _build.check(rc, "fused_gather_moments")
    fused_gather_moments.launches += 1
    return out[:, :d], out[:, 2 * d :], out[:, d : 2 * d], z


fused_gather_moments.launches = 0


def _not_ported(name: str, stack: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} ({stack}) is not ported yet: see ROADMAP.md, queue 2"
        )

    fn.__name__ = name
    return fn


fused_gather_sum = _not_ported("fused_gather_sum", "edge op 'copy', GIN")
fused_gather_mean = _not_ported("fused_gather_mean", "edge op 'copy_count', SAGE")
fused_gather_weighted_sum = _not_ported(
    "fused_gather_weighted_sum", "edge op 'mul', SchNet"
)
fused_egnn_edge_phase = _not_ported("fused_egnn_edge_phase", "edge op 'egnn', EGNN")
