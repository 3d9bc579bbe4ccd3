"""Fault injection for the resilience tests (port of ``utils/faults.py``,
its training-side hooks).

Each hook is called unconditionally by the code it tests; with no
``HYDRAGNN_FAULT_*`` variable set it does nothing. The hooks:

- ``HYDRAGNN_FAULT_KILL_AT_STEP=N``: :func:`kill_at_step` exits the
  process at once (``os._exit(KILL_EXIT_CODE)``: no cleanup, as a
  preempted job gets none) when the trainer reaches optimizer step ``N``
  (0-based, counted per process).
- ``HYDRAGNN_FAULT_NAN_AT_STEP=SPEC``: :func:`nan_at_step` is true at the
  steps ``SPEC`` names (``"3"``, ``"3,5,9"`` or the half-open ``"4:9"``),
  where the trainer poisons the batch's ``x`` with NaN.
- ``HYDRAGNN_FAULT_SLOW_STEP=SPEC@SECONDS``: :func:`slow_step` sleeps
  ``SECONDS`` (default 0.25) before each step ``SPEC`` covers.
- ``HYDRAGNN_FAULT_CORRUPT_CHECKPOINT=K``: :func:`corrupt_checkpoint`
  flips one byte in the middle of this process's ``K``-th checkpoint file
  after it was written (1-based; ``all``: every one).
- ``HYDRAGNN_FAULT_FLAKY_READ=N``: :func:`flaky_read` raises ``OSError``
  for the first ``N`` reads that pass through it.

The JAX package's host-loss hook (``LOSE_HOST_AT_STEP``) and its rank
filter for slow steps (``SLOW_STEP_RANK``) wait for multi-process runs
(``ROADMAP.md``, queue 1, item 8), and its serving,
replica and candidate hooks for the fleet and the canary (item 5).

The counters are process-wide; :func:`reset` zeroes them for a test that
drives several scenarios in one process.
"""

import os
import threading
import time

_lock = threading.Lock()
_counters = {"ckpt_writes": 0, "flaky_reads": 0}

KILL_EXIT_CODE = 113  # what the kill-and-resume tests expect


def reset():
    """Zero the process-wide injection counters."""
    with _lock:
        for k in _counters:
            _counters[k] = 0


def _parse_step_spec(spec: str):
    """``"3"`` / ``"3,5"`` / ``"4:9"`` -> a membership predicate over ints."""
    spec = spec.strip()
    if not spec:
        return lambda step: False
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        lo = int(lo) if lo else 0
        hi = int(hi) if hi else None
        return lambda step: step >= lo and (hi is None or step < hi)
    members = {int(p) for p in spec.split(",") if p.strip()}
    return lambda step: step in members


def kill_at_step(step: int) -> None:
    """Exit at once (``os._exit``: no atexit, no ``finally``) when ``step``
    is the configured one: only checkpoints already on disk survive."""
    spec = os.getenv("HYDRAGNN_FAULT_KILL_AT_STEP")
    if spec is None:
        return
    if int(spec) == int(step):
        os._exit(KILL_EXIT_CODE)


def slow_step(step: int) -> None:
    """Sleep before a covered step: ``"SPEC@SECONDS"`` (``"12@0.3"``,
    ``"4:9@0.05"``), a bare ``"SPEC"`` for 0.25 s."""
    spec = os.getenv("HYDRAGNN_FAULT_SLOW_STEP")
    if spec is None:
        return
    member, _, secs = spec.partition("@")
    if _parse_step_spec(member)(int(step)):
        time.sleep(float(secs) if secs else 0.25)


def nan_at_step(step: int) -> bool:
    """True where the NaN injection covers ``step``."""
    spec = os.getenv("HYDRAGNN_FAULT_NAN_AT_STEP")
    if spec is None:
        return False
    return _parse_step_spec(spec)(int(step))


def corrupt_checkpoint(path: str) -> None:
    """Called by ``save_model`` with the final file after the atomic
    rename: flips the middle byte when this write's ordinal is selected."""
    spec = os.getenv("HYDRAGNN_FAULT_CORRUPT_CHECKPOINT")
    if spec is None:
        return
    with _lock:
        _counters["ckpt_writes"] += 1
        ordinal = _counters["ckpt_writes"]
    if spec != "all" and int(spec) != ordinal:
        return
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))


def flaky_read(what: str = "") -> None:
    """Raise ``OSError`` for the first ``N`` reads that reach a flaky-read
    point, then let them pass."""
    spec = os.getenv("HYDRAGNN_FAULT_FLAKY_READ")
    if spec is None:
        return
    with _lock:
        if _counters["flaky_reads"] >= int(spec):
            return
        _counters["flaky_reads"] += 1
    raise OSError(f"injected transient read failure ({what or 'read'})")
