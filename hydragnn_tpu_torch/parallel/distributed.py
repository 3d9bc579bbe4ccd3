"""The SLURM wall-clock guard and the data plane's counts exchange (port of
``parallel/distributed.py``'s ``check_remaining``, ``_parse_slurm_timeleft``
and ``host_allgather_int``; the rest of that module is ``ROADMAP.md``'s
queue 1, item 8). The exchange goes over ``torch.distributed`` when a group
is initialised and is the identity in one process."""

import os
from typing import List

from hydragnn_tpu_torch.utils.timers import comm_size_and_rank


def host_allgather_int(value: int) -> List[int]:
    """Every process's ``value``, in rank order."""
    world, _ = comm_size_and_rank()
    if world == 1:
        return [int(value)]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, int(value))
    return [int(v) for v in out]


def check_remaining(elapsed_per_epoch: float) -> bool:
    """True when the job has time left for one more unit of work that
    took ``elapsed_per_epoch`` seconds (with 20% to spare). Outside SLURM,
    or when ``squeue`` cannot say, always True."""
    job = os.getenv("SLURM_JOB_ID")
    if job is None:
        return True
    import subprocess

    try:
        out = subprocess.run(["squeue", "-h", "-j", job, "-o", "%L"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except Exception:
        return True  # no squeue: the guard has nothing to go on
    seconds = _parse_slurm_timeleft(out)
    return seconds is None or seconds > 1.2 * elapsed_per_epoch


def _parse_slurm_timeleft(s: str):
    """Seconds of ``squeue``'s ``%L``: ``D-HH:MM:SS``, ``HH:MM:SS``,
    ``MM:SS`` or ``SS``; None for ``INVALID`` or nothing."""
    if not s or "INVALID" in s.upper():
        return None
    days = 0
    if "-" in s:
        d, s = s.split("-", 1)
        days = int(d)
    parts = [int(p) for p in s.split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, sec = parts[-3:]
    return ((days * 24 + h) * 60 + m) * 60 + sec
