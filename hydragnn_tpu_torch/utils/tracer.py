"""Tracer facade: nested region timers (port of ``utils/tracer.py``).

A registry of backends, enable/disable, an optional device sync at region
boundaries for honest attribution, and a ``@profile`` decorator. Backends:

* ``timer``: pure-Python region timers with per-process summaries.
* ``torch``: each region as a ``torch.profiler.record_function`` range, so
  that it shows in a profiler trace (the JAX package's ``jax`` backend,
  ``TraceAnnotation``).
* ``native``: the C++ region timer (``native/regiontimer.py``, built with
  g++ at first use): call-tree paths (``train/train_step``), a text summary
  and a chrome-trace export. It falls back to ``timer`` only when the
  library cannot be built, as in the JAX package.

``HYDRAGNN_TRACE_LEVEL=1`` synchronises the run's device
(``torch.cuda.synchronize``; :func:`set_device`) at every region boundary,
so that a region's seconds hold the device work it queued; at any other
level the regions time the host and add no sync.
"""

import os
import time
from collections import defaultdict
from functools import wraps
from typing import Dict

_tracers: Dict[str, object] = {}
_enabled = True
_device = None  # the run's device: what trace level 1 synchronises


class TimerTracer:
    def __init__(self):
        self.acc = defaultdict(float)
        self.count = defaultdict(int)
        self._start = {}

    def start(self, name):
        self._start[name] = time.perf_counter()

    def stop(self, name):
        if name in self._start:
            self.acc[name] += time.perf_counter() - self._start.pop(name)
            self.count[name] += 1

    def reset(self):
        self.acc.clear()
        self.count.clear()
        self._start.clear()

    def pr_file(self, filename):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "w") as f:
            f.write(f"{'region':<30}{'calls':>10}{'total_s':>14}{'avg_ms':>12}\n")
            for name in sorted(self.acc):
                c = self.count[name]
                t = self.acc[name]
                f.write(f"{name:<30}{c:>10}{t:>14.4f}{(t / max(c, 1)) * 1e3:>12.3f}\n")


class TorchProfilerTracer:
    """Regions as ``torch.profiler.record_function`` ranges."""

    def __init__(self):
        self._spans = {}

    def start(self, name):
        from torch.profiler import record_function

        span = record_function(name)
        span.__enter__()
        self._spans.setdefault(name, []).append(span)

    def stop(self, name):
        spans = self._spans.get(name)
        if spans:
            spans.pop().__exit__(None, None, None)

    def reset(self):
        self._spans.clear()

    def pr_file(self, filename):
        pass


def initialize(trace_backends=("native",), verbosity: int = 0):
    for b in trace_backends:
        if b == "timer":
            _tracers["timer"] = TimerTracer()
        elif b in ("torch", "jax"):
            _tracers["torch"] = TorchProfilerTracer()
        elif b == "native":
            try:
                from hydragnn_tpu_torch.native.regiontimer import NativeRegionTimer

                _tracers["native"] = NativeRegionTimer()
            except Exception:  # no toolchain: the Python timer
                _tracers["timer"] = TimerTracer()
    return list(_tracers)


def set_device(device):
    """The device that ``HYDRAGNN_TRACE_LEVEL=1`` synchronises."""
    global _device
    _device = device


def has(name):
    return name in _tracers


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    for t in _tracers.values():
        t.reset()


def _sync():
    """Wait for the run's device to finish what was queued (trace level 1)."""
    if os.getenv("HYDRAGNN_TRACE_LEVEL", "0") == "1":
        import torch

        dev = _device
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)


def start(name):
    if not _enabled or not _tracers:
        return
    _sync()
    for t in _tracers.values():
        t.start(name)


def stop(name):
    if not _enabled or not _tracers:
        return
    _sync()
    for t in _tracers.values():
        t.stop(name)


def profile(name):
    """Decorator marking a traced region."""

    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            start(name)
            try:
                return fn(*args, **kwargs)
            finally:
                stop(name)

        return wrapper

    return deco


def totals() -> Dict[str, float]:
    """Accumulated seconds per region of one accumulating backend,
    ``native`` (call-tree paths) before ``timer`` (the ``torch`` backend
    only annotates traces; summing backends would count each region
    twice): the run's ``tracer_totals`` event and the
    ``tracer/<region>_seconds`` scalars."""
    for name in ("native", "timer"):
        t = _tracers.get(name)
        if t is None:
            continue
        if hasattr(t, "totals"):
            return {k: float(v) for k, v in t.totals().items()}
        return {k: float(v) for k, v in t.acc.items()}
    return {}


def save(prefix: str = "./logs/trace"):
    """Per-process region dump, ``<prefix>[.<backend>].<rank>``; the
    ``native`` backend also writes a chrome://tracing JSON,
    ``<prefix>[.native].<rank>.trace.json``."""
    from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

    _, rank = comm_size_and_rank()
    for name, t in _tracers.items():
        # with several file-writing backends each gets its own file
        tag = f".{name}" if len(_tracers) > 1 else ""
        t.pr_file(f"{prefix}{tag}.{rank}")
        if hasattr(t, "chrome_trace"):
            t.chrome_trace(f"{prefix}{tag}.{rank}.trace.json", pid=rank)
