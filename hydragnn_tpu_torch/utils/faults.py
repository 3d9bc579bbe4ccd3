"""Fault injection for the resilience tests (port of ``utils/faults.py``).

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

The serving fleet's hooks (``serve/fleet.py``'s replicas call them):

- ``HYDRAGNN_FAULT_KILL_REPLICA_AT_REQUEST=REPLICA:K``:
  :func:`kill_replica_at_request` exits this process
  (``os._exit(KILL_EXIT_CODE)``) when it is serving replica ``REPLICA``
  (``HYDRAGNN_FLEET_REPLICA``) and its ``K``-th accepted request arrives
  (1-based; a bare ``K`` targets replica 0).
- ``HYDRAGNN_FAULT_SLOW_REPLICA=REPLICA:SPEC@SECONDS``:
  :func:`slow_replica` sleeps ``SECONDS`` (default 0.25) before each
  request of replica ``REPLICA`` whose 0-based ordinal ``SPEC`` covers (a
  colon-free ``SPEC@SECONDS`` targets replica 0).
- ``HYDRAGNN_FAULT_CORRUPT_CANDIDATE=K``: :func:`corrupt_candidate` hands
  the ``K``-th hot-swap candidate this process loads (1-based; ``all``:
  every one) to the loader as a byte-flipped copy, so that the strict v2
  CRC check refuses it; the shared original stays intact.
- ``HYDRAGNN_FAULT_NAN_CANDIDATE=K``: :func:`nan_candidate` is true for a
  canary replica's ``K``-th request (1-based; ``all``: every one), which
  then answers NaN in every head. Only the canary role asks.
- ``HYDRAGNN_FAULT_SLOW_CANDIDATE=SPEC@SECONDS``: :func:`slow_candidate`
  sleeps before each canary request whose 0-based ordinal ``SPEC`` covers.
- ``HYDRAGNN_FAULT_SHIFT_INPUTS=SPEC@SCALE``: :func:`shift_inputs` scales
  the node features and positions of each decoded request whose 0-based
  ordinal ``SPEC`` covers by ``SCALE`` (default 3.0), on replica
  ``HYDRAGNN_FAULT_SHIFT_REPLICA`` only when that is set.

The JAX package's host-loss hook (``LOSE_HOST_AT_STEP``) and its rank
filter for slow steps (``SLOW_STEP_RANK``) wait for multi-process runs
(``ROADMAP.md``, queue 1, item 8).

The counters are process-wide; :func:`reset` zeroes them for a test that
drives several scenarios in one process.
"""

import os
import threading
import time

_lock = threading.Lock()
_counters = {"ckpt_writes": 0, "flaky_reads": 0, "replica_requests": 0,
             "candidate_loads": 0}

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


def _this_replica() -> int:
    """This process's serving replica id (``HYDRAGNN_FLEET_REPLICA``; 0
    when unset or malformed)."""
    try:
        return int(os.getenv("HYDRAGNN_FLEET_REPLICA", "0"))
    except ValueError:
        return 0


def kill_replica_at_request() -> None:
    """Exit at once when this replica's ``K``-th accepted request arrives
    (``"REPLICA:K"``; a bare ``"K"``: replica 0). The counter moves only
    while the knob names this replica, so the point it fires at is exact."""
    spec = os.getenv("HYDRAGNN_FAULT_KILL_REPLICA_AT_REQUEST")
    if spec is None:
        return
    replica_s, _, req_s = spec.rpartition(":")
    target = int(replica_s) if replica_s else 0
    if _this_replica() != target:
        return
    with _lock:
        _counters["replica_requests"] += 1
        ordinal = _counters["replica_requests"]
    if ordinal == int(req_s):
        os._exit(KILL_EXIT_CODE)


def slow_replica(request_ordinal: int) -> None:
    """Sleep before a covered request: ``"REPLICA:SPEC@SECONDS"``
    (``"1:0:50@0.2"``: replica 1's first 50 requests by 0.2 s); a
    colon-free ``"7@0.5"`` targets replica 0, so a range or list needs the
    replica prefix."""
    spec = os.getenv("HYDRAGNN_FAULT_SLOW_REPLICA")
    if spec is None:
        return
    member, _, secs = spec.partition("@")
    replica_s, sep, step_spec = member.partition(":")
    if not sep:
        target, step_spec = 0, member
    else:
        target = int(replica_s)
    if _this_replica() != target:
        return
    if _parse_step_spec(step_spec)(int(request_ordinal)):
        time.sleep(float(secs) if secs else 0.25)


def shift_inputs(graph, request_ordinal: int):
    """Scale a covered request's node features (and positions) in place:
    ``"SPEC@SCALE"`` (``"200:@3.0"``: every request from ordinal 200 on,
    three times). The caller passes its own decoded copy."""
    spec = os.getenv("HYDRAGNN_FAULT_SHIFT_INPUTS")
    if spec is None:
        return graph
    replica_s = os.getenv("HYDRAGNN_FAULT_SHIFT_REPLICA")
    if replica_s is not None and replica_s.strip() != "":
        if _this_replica() != int(replica_s):
            return graph
    member, _, scale_s = spec.partition("@")
    if not _parse_step_spec(member)(int(request_ordinal)):
        return graph
    scale = float(scale_s) if scale_s else 3.0
    if getattr(graph, "x", None) is not None:
        graph.x = graph.x * scale
    if getattr(graph, "pos", None) is not None:
        graph.pos = graph.pos * scale
    return graph


def nan_candidate(request_ordinal: int) -> bool:
    """True when the canary's request ``request_ordinal`` (1-based) should
    answer NaN heads (``"K"`` or ``"all"``). Only the canary asks, so a
    fleet-wide knob never poisons a live answer."""
    spec = os.getenv("HYDRAGNN_FAULT_NAN_CANDIDATE")
    if spec is None:
        return False
    if spec == "all":
        return True
    return int(spec) == int(request_ordinal)


def slow_candidate(request_ordinal: int) -> None:
    """Sleep before a covered canary request (``"SPEC@SECONDS"``, 0-based
    ordinals; 0.25 s by default)."""
    spec = os.getenv("HYDRAGNN_FAULT_SLOW_CANDIDATE")
    if spec is None:
        return
    member, _, secs = spec.partition("@")
    if _parse_step_spec(member)(int(request_ordinal)):
        time.sleep(float(secs) if secs else 0.25)


def corrupt_candidate(path: str) -> str:
    """The path the loader should read for this candidate load: ``path``
    itself, or, at the selected load (1-based ordinal, or ``"all"``), a
    copy beside it with its middle byte flipped."""
    spec = os.getenv("HYDRAGNN_FAULT_CORRUPT_CANDIDATE")
    if spec is None:
        return path
    with _lock:
        _counters["candidate_loads"] += 1
        ordinal = _counters["candidate_loads"]
    if spec != "all" and int(spec) != ordinal:
        return path
    corrupt = f"{path}.injected-corrupt"
    with open(path, "rb") as src:
        blob = bytearray(src.read())
    if blob:
        blob[len(blob) // 2] ^= 0xFF
    with open(corrupt, "wb") as dst:
        dst.write(bytes(blob))
    return corrupt
