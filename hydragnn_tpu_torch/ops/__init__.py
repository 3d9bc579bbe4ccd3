"""The port's kernels: CUDA for Hopper, each with a plain PyTorch version.

| Id | Wrapper | Replaces (TPU kernel) | Source |
|----|---------|-----------------------|--------|
| K1 | ``segment_kernels.segment_sum`` | ``pallas_segment.segment_sum_onehot`` | ``csrc/segment.cu`` |
| K2 | ``segment_kernels.segment_moments`` | ``pallas_segment.segment_moments`` | ``csrc/segment.cu`` |
| K3 | ``fused_mp.fused_gather_moments`` | ``fused_mp.fused_message_reduce`` op ``moments`` | ``csrc/fused_mp.cu`` |
"""

from hydragnn_tpu_torch.ops.fused_mp import (
    fused_gather_moments,
    fused_gather_moments_plain,
)
from hydragnn_tpu_torch.ops.segment_kernels import (
    segment_moments,
    segment_moments_plain,
    segment_sum,
    segment_sum_plain,
)

# kernel wrapper -> its plain version, in kernel-id order (K1, K2, K3)
KERNELS = {
    "segment_sum": (segment_sum, segment_sum_plain),
    "segment_moments": (segment_moments, segment_moments_plain),
    "fused_gather_moments": (fused_gather_moments, fused_gather_moments_plain),
}


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {name: fn.launches for name, (fn, _) in KERNELS.items()}


def reset_launch_counts():
    for fn, _ in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "fused_gather_moments",
    "fused_gather_moments_plain",
    "launch_counts",
    "reset_launch_counts",
    "segment_moments",
    "segment_moments_plain",
    "segment_sum",
    "segment_sum_plain",
]
