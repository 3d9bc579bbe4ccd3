"""The port's kernels: CUDA for Hopper, each with a plain PyTorch version.

| Id | Wrapper | Replaces (TPU kernel) | Source |
|----|---------|-----------------------|--------|
| K1 | ``segment_kernels.segment_sum`` | ``pallas_segment.segment_sum_onehot`` | ``csrc/segment.cu`` |
| K2 | ``segment_kernels.segment_moments`` | ``pallas_segment.segment_moments`` | ``csrc/segment.cu`` |
| K3 | ``fused_mp.fused_gather_moments`` | ``fused_mp.fused_message_reduce`` op ``moments`` | ``csrc/fused_mp.cu`` |
| K4 | ``fused_mp.fused_gather_sum`` | ``fused_mp.fused_message_reduce`` op ``copy`` | ``csrc/fused_mp.cu`` |
| K5 | ``fused_mp.fused_gather_mean`` | ``fused_mp.fused_message_reduce`` op ``copy_count`` | ``csrc/fused_mp.cu`` |
| K6 | ``fused_mp.fused_gather_weighted_sum`` | ``fused_mp.fused_message_reduce`` op ``mul`` | ``csrc/fused_mp.cu`` |
| K7 | ``fused_mp.fused_egnn_edge_phase`` | ``fused_mp.fused_message_reduce`` op ``egnn`` | ``csrc/fused_egnn.cu`` |

Each kernel takes gradients through its ``*_vjp`` twin: a
``torch.autograd.Function`` around the wrapper, with the JAX package's
backward rule, which runs the port's kernels on the card (K3's and K7's
folds through K1, K4's and K5's through K4 with the ids swapped, K6's
through K6 swapped). The wrappers themselves are forward-only.
"""

from hydragnn_tpu_torch.ops.fused_mp import (
    fused_egnn_edge_phase,
    fused_egnn_edge_phase_plain,
    fused_egnn_edge_phase_vjp,
    fused_gather_mean,
    fused_gather_mean_plain,
    fused_gather_mean_vjp,
    fused_gather_moments,
    fused_gather_moments_plain,
    fused_gather_moments_vjp,
    fused_gather_sum,
    fused_gather_sum_plain,
    fused_gather_sum_vjp,
    fused_gather_weighted_sum,
    fused_gather_weighted_sum_plain,
    fused_gather_weighted_sum_vjp,
)
from hydragnn_tpu_torch.ops.segment_kernels import (
    segment_moments,
    segment_moments_plain,
    segment_moments_vjp,
    segment_sum,
    segment_sum_plain,
    segment_sum_vjp,
)

# kernel wrapper -> its plain version, in kernel-id order (K1 ... K7)
KERNELS = {
    "segment_sum": (segment_sum, segment_sum_plain),
    "segment_moments": (segment_moments, segment_moments_plain),
    "fused_gather_moments": (fused_gather_moments, fused_gather_moments_plain),
    "fused_gather_sum": (fused_gather_sum, fused_gather_sum_plain),
    "fused_gather_mean": (fused_gather_mean, fused_gather_mean_plain),
    "fused_gather_weighted_sum": (fused_gather_weighted_sum, fused_gather_weighted_sum_plain),
    "fused_egnn_edge_phase": (fused_egnn_edge_phase, fused_egnn_edge_phase_plain),
}


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {name: fn.launches for name, (fn, _) in KERNELS.items()}


def reset_launch_counts():
    for fn, _ in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "fused_egnn_edge_phase",
    "fused_egnn_edge_phase_plain",
    "fused_egnn_edge_phase_vjp",
    "fused_gather_mean",
    "fused_gather_mean_plain",
    "fused_gather_mean_vjp",
    "fused_gather_moments",
    "fused_gather_moments_plain",
    "fused_gather_moments_vjp",
    "fused_gather_sum",
    "fused_gather_sum_plain",
    "fused_gather_sum_vjp",
    "fused_gather_weighted_sum",
    "fused_gather_weighted_sum_plain",
    "fused_gather_weighted_sum_vjp",
    "launch_counts",
    "reset_launch_counts",
    "segment_moments",
    "segment_moments_plain",
    "segment_moments_vjp",
    "segment_sum",
    "segment_sum_plain",
    "segment_sum_vjp",
]
