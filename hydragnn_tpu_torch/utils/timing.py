"""Kernel timing on the card with CUDA events, two ways.

- :func:`time_ms`, the call: events around calls made back to back, so
  that the host's own work per call (checks, allocation, the launch) can set
  the pace, as it does for a caller. :func:`call_ms` takes it for several
  functions in turns, so that calls compared with each other meet the
  same host.
- :func:`device_ms`, the kernel alone: the same calls queued behind
  ``torch.cuda._sleep``, so that the device finds them all waiting and runs
  them back to back; repeated, to show the spread.

Both return ``None`` for a CPU device, which has no device time.
"""

import time

import numpy as np
import torch


def time_ms(fn, device, iters=20, warmup=3):
    """Call time: mean ms per call, CUDA events around ``iters`` calls
    after warm-up, so the host's own work per call can set the pace.
    ``None`` for a CPU device."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fns, device, repeats=5):
    """Call times of ``fns`` taken in turns: ``repeats`` rounds, each one
    :func:`time_ms` window of every function in order, and the median
    window of each. The host's speed drifts over a process's life, so
    calls to be compared are timed side by side. ``None`` for each on a
    CPU device."""
    rounds = [[time_ms(fn, device) for fn in fns] for _ in range(repeats)]
    if device.type != "cuda":
        return [None] * len(fns)
    return [float(np.median(col)) for col in zip(*rounds)]


SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's boost clock: sleeps run long, never short


def device_ms(fn, device, iters=20, repeats=5):
    """Device time: ``[min, median, max]`` over ``repeats`` of the mean ms
    per call, with the ``iters`` calls queued behind ``torch.cuda._sleep``
    so that the host cannot set the pace. The sleep is four times what the
    host took to enqueue the calls. A repeat in which the device reached
    the first call before the host had queued the last one runs again with
    half the calls (a function of many launches fills the card's launch
    queue, and the host then waits on the sleep); at one call, with a
    sleep four times longer. ``None`` for a CPU device."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(4 * host_s, 1e-3) * SLEEP_CYCLES_PER_S)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    while len(out) < repeats:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()  # the sleep outlasted the host's enqueue
        torch.cuda.synchronize()
        if queued:
            out.append(start.elapsed_time(end) / iters)
        elif iters > 1:
            iters //= 2
        elif cycles > 100 * SLEEP_CYCLES_PER_S:
            raise RuntimeError("device_ms: the host paces the calls even behind a 100 s sleep")
        else:
            cycles *= 4
    return [min(out), float(np.median(out)), max(out)]
