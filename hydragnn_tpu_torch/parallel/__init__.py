"""Parallelism (port of ``hydragnn_tpu/parallel``): so far only the job's
wall-clock guard (``distributed.check_remaining``); meshes, DDP and FSDP
are ``ROADMAP.md``'s queue 1, item 8."""

from hydragnn_tpu_torch.parallel.distributed import check_remaining

__all__ = ["check_remaining"]
