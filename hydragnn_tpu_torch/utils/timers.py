"""Wall-clock timers with a reduction over processes (port of
``utils/timers.py``): named timers that add up across instances of one
name, and their min/max/avg over the processes printed at the end of a run.

The port runs one process per run until parallelism is ported
(``ROADMAP.md``, queue 1, item 8); when ``torch.distributed`` is
initialised the figures are reduced over its group, else they are this
process's own.
"""

import time
from typing import Dict

import numpy as np

_timers: Dict[str, "Timer"] = {}


class Timer:
    def __init__(self, name: str):
        self.name = name
        self.elapsed = _timers[name].elapsed if name in _timers else 0.0
        self._start = None
        _timers[name] = self

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None


def reset_timers():
    _timers.clear()


def comm_size_and_rank():
    """``(world size, rank)`` of ``torch.distributed``'s group, or ``(1, 0)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _reduce(values: np.ndarray, op: str) -> np.ndarray:
    import torch
    import torch.distributed as dist

    world, _ = comm_size_and_rank()
    if world == 1:
        return values
    t = torch.as_tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op={"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
                           "sum": dist.ReduceOp.SUM}[op])
    return t.numpy()


def print_timers(verbosity: int = 0):
    """Print min/max/avg over the processes for each named timer."""
    world, rank = comm_size_and_rank()
    if not _timers:
        return
    names = sorted(_timers)
    values = np.asarray([_timers[n].elapsed for n in names])
    tmin, tmax, tsum = (_reduce(values, op) for op in ("min", "max", "sum"))
    if rank == 0:
        print(f"{'timer':<28}{'min_s':>12}{'max_s':>12}{'avg_s':>12}")
        for i, n in enumerate(names):
            print(f"{n:<28}{tmin[i]:>12.4f}{tmax[i]:>12.4f}{tsum[i] / world:>12.4f}")
