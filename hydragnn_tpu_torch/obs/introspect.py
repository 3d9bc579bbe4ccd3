"""Eyes into the captured programs: cost and memory accounting per
(program, shape key) and trace capture (port of ``obs/introspect.py``).

- :func:`instrument` marks a ``train/capture.py`` ``Program`` so that each
  novel shape key gets one record: ``cost`` (``flops``: the
  ``torch.utils.flop_counter.FlopCounterMode`` count of the capture's eager
  warm-up), ``memory`` (``argument_bytes``, ``output_bytes`` and, on the
  card while introspection is live, ``peak_bytes``: the allocator's peak
  over the warm-up and the capture above what was allocated before them)
  and ``capture_s`` (the capture's seconds, warm-up included). The record is kept on the program
  (``Program.records``, by bucket label) and, with a telemetry run active,
  becomes a ``compile`` event and the
  ``hydragnn_train_flops_per_step{bucket=...}`` /
  ``hydragnn_train_hbm_peak_bytes{bucket=...}`` gauges. On the CPU a
  program captures nothing, so there is no warm-up to count: the record of
  a key's first call holds its bytes (``capture_s`` 0, no ``peak_bytes``,
  ``cost`` ``{}``, as the JAX package's on a backend without a cost
  model), but for a program that bills its FLOPs (``always=True``), whose
  first call is counted.
- :class:`TraceCapture` runs ``torch.profiler`` over the next N step
  dispatches of a live run, driven by ``/profile?steps=N`` or
  ``HYDRAGNN_PROFILE_AT_STEP=<epoch>:<step>``; each capture leaves a
  Chrome trace under the run's ``profile/`` directory.
- :class:`Profiler`: the wait/warmup/active step schedule
  (``torch.profiler.schedule``'s shape), with a no-op object when disabled.

What the FLOP count sees: ``FlopCounterMode`` counts aten operations only
(the matrix products). The hand-written kernels K1-K7, reached through
``ctypes`` (``ops/_build.py``), add nothing to it, as the Pallas calls add
nothing to XLA's cost model in the JAX package (they carry no
``cost_estimate``): the two counts are of the same kind, the dense
products of a step.

Cost: accounting runs once per novel key, inside the capture that happens
then anyway; a replay pays nothing. It is live when a telemetry run is
active (``HYDRAGNN_INTROSPECT=0`` turns it off even then, ``=1`` on
without one), and always for a program instrumented with
``always=True`` (the server's forward when a cost ledger bills FLOPs).

The peak's side effect: on the card, while introspection is live, each
capture it measures resets the allocator's peak statistic
(``torch.cuda.reset_peak_memory_stats``), so ``max_memory_allocated``
read across a telemetry run's captures starts at the last of them.
:func:`max_memory_allocated` undoes those resets (the run's
``device_peak_bytes_in_use`` gauge reads it). A program accounted only
because it bills its FLOPs (``always=True`` outside a live run: the
server's forward) takes no peak and resets nothing.
"""

import contextlib
import hashlib
import os
import threading
import time
import warnings
from typing import Dict, Optional, Tuple

_FALSY = ("", "0", "false", "no", "off")


def enabled() -> bool:
    """Introspection live? By default exactly when a telemetry run is
    active; ``HYDRAGNN_INTROSPECT`` forces it off (``0``) or on (``1``)."""
    env = os.getenv("HYDRAGNN_INTROSPECT")
    if env is not None:
        return env.strip().lower() not in _FALSY
    from hydragnn_tpu_torch.obs import runtime as _rt

    return _rt.active() is not None


def signature_key(args) -> Tuple:
    """Every input tensor's name, shape and dtype: the program's shape key
    without the addresses a bound program also keys on."""
    from hydragnn_tpu_torch.train.capture import shape_key

    return shape_key(args)


def bucket_label(name: str, key: Tuple) -> str:
    """Stable short id for one (program, shape signature): the gauges'
    ``bucket`` label and the budget ratchet's key (hashlib: the same across
    processes and runs)."""
    digest = hashlib.sha1(repr(key).encode()).hexdigest()[:8]
    return f"{name}/{digest}"


def instrument(program, always: bool = False):
    """Mark ``program`` (a ``train.capture.Program``) for accounting: its
    novel shape keys are recorded while :func:`enabled` (or always, with
    ``always``). Returns the program."""
    program.instrumented = "always" if always else True
    return program


def wants(program) -> bool:
    """Whether ``program``'s next novel key is to be accounted."""
    mode = getattr(program, "instrumented", False)
    return mode == "always" or (bool(mode) and enabled())


_peaks_reset: Dict[int, int] = {}  # card index: the allocator's peak when accounting last reset it


def _index(device) -> int:
    import torch

    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def max_memory_allocated(device) -> int:
    """``torch.cuda.max_memory_allocated(device)`` with the resets that
    accounting makes (:meth:`Probe.measure`) undone."""
    import torch

    return max(torch.cuda.max_memory_allocated(device), _peaks_reset.get(_index(device), 0))


def _nbytes(tree) -> float:
    import torch
    from torch.utils._pytree import tree_leaves

    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if torch.is_tensor(t)))


class Probe:
    """One accounted capture of ``program`` on ``leaves`` (its input
    tensors): :meth:`counting` wraps the warm-up (or the CPU's one run),
    :meth:`measure` the warm-up and the capture, :meth:`finish` records."""

    def __init__(self, program, key, leaves, device):
        self.program, self.key, self.device = program, key, device
        self.flops = None
        self.memory = {"argument_bytes": _nbytes(list(leaves))}
        self.capture_s = 0.0

    @contextlib.contextmanager
    def counting(self):
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            yield
        self.flops = float(counter.get_total_flops())

    @contextlib.contextmanager
    def measure(self):
        import torch

        # the peak only while introspection is live (the module's doc: the
        # reset's side effect); a program that only bills FLOPs takes none
        cuda = self.device.type == "cuda" and enabled()
        if cuda:
            before = torch.cuda.memory_allocated(self.device)
            _peaks_reset[_index(self.device)] = max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        yield
        self.capture_s = time.perf_counter() - t0
        if cuda:
            self.memory["peak_bytes"] = float(
                max(torch.cuda.max_memory_allocated(self.device) - before, 0))

    def finish(self, out) -> Optional[Dict]:
        """Record the capture (never raises into the caller)."""
        prog = self.program
        try:
            self.memory["output_bytes"] = _nbytes(out)
            rec = {
                "name": prog.name,
                "bucket": bucket_label(prog.name, self.key),
                "cost": {} if self.flops is None else {"flops": self.flops},
                "memory": dict(self.memory),
                "capture_s": round(self.capture_s, 6),
            }
            prog.records[rec["bucket"]] = rec
            from hydragnn_tpu_torch.obs import runtime

            t = runtime.active()
            if t is not None:
                t.record_compile(rec)
            return rec
        except Exception as e:
            if not getattr(prog, "_warned", False):
                prog._warned = True
                warnings.warn(f"introspection record failed for {prog.name!r}: {e} "
                              "(further failures for this program are silent)", stacklevel=2)
            return None


# ---- on-demand trace capture ---------------------------------------------


def _start_device_trace(trace_dir: str):
    """Start ``torch.profiler`` (CPU and, with a card, CUDA activities);
    returns the session. One start for both capture styles, resolved at
    call time so that test fakes apply."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    session = profile(activities=activities)
    session.start()
    return session


def _stop_device_trace(session, trace_dir: str) -> str:
    """Stop ``session`` and write its Chrome trace; returns its absolute
    path."""
    session.stop()
    path = os.path.abspath(os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    session.export_chrome_trace(path)
    return path


class TraceCapture:
    """Trace the next N step dispatches of a live run. ``arm()`` is called
    from any thread (the ``/profile`` handler); ``tick()`` once per
    dispatch from the training thread, which owns every profiler start and
    stop (the profiler is process-wide)."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._lock = threading.Lock()
        self._armed_steps = 0
        self._remaining = 0
        self._tracing = False
        self._session = None

    def arm(self, steps: int) -> Dict:
        """Request a capture of the next ``steps`` dispatches; returns the
        ``/profile`` response payload."""
        steps = int(steps)
        if steps <= 0:
            return {"status": "error", "error": "steps must be >= 1"}
        with self._lock:
            if self._tracing or self._armed_steps:
                return {"status": "busy",
                        "remaining_steps": self._remaining or self._armed_steps,
                        "trace_dir": self.trace_dir}
            self._armed_steps = steps
        return {"status": "armed", "steps": steps, "trace_dir": self.trace_dir}

    def tick(self) -> Optional[Dict]:
        """Advance one dispatch; returns a ``profile`` event payload on the
        started/done transitions, else None. A profiler failure is an
        ``error`` payload, never an exception into the training loop."""
        with self._lock:
            if self._armed_steps:
                steps, self._armed_steps = self._armed_steps, 0
                try:
                    self._start()
                except Exception as e:
                    return {"status": "error", "error": str(e), "trace_dir": self.trace_dir}
                self._remaining = steps
                self._tracing = True
                return {"status": "started", "steps": steps, "trace_dir": self.trace_dir}
            if self._tracing:
                self._remaining -= 1
                if self._remaining <= 0:
                    self._tracing = False
                    return self._finish()
        return None

    def close(self) -> Optional[Dict]:
        """Stop an open trace (run teardown), so that a run ending mid
        capture still leaves a loadable trace."""
        with self._lock:
            if not self._tracing:
                return None
            self._tracing = False
            self._remaining = 0
            return self._finish()

    def _finish(self) -> Dict:
        try:
            path = self._stop()
        except Exception as e:
            return {"status": "error", "error": str(e), "trace_dir": self.trace_dir}
        out = {"status": "done", "trace_dir": self.trace_dir}
        if path:
            out["trace"] = path
        return out

    def _start(self):
        self._session = _start_device_trace(self.trace_dir)

    def _stop(self):
        session, self._session = self._session, None
        return _stop_device_trace(session, self.trace_dir)


def parse_profile_at_step(value: Optional[str]) -> Optional[Tuple[int, int]]:
    """``HYDRAGNN_PROFILE_AT_STEP`` -> (epoch, step): ``"<epoch>:<step>"``
    or a bare ``"<step>"`` (epoch 0). None or malformed -> None (malformed
    warns: an arm target that never fires is the worst outcome)."""
    if value is None or not value.strip():
        return None
    try:
        parts = value.split(":")
        if len(parts) == 1:
            return (0, int(parts[0]))
        if len(parts) == 2:
            return (int(parts[0]), int(parts[1]))
    except ValueError:
        pass
    warnings.warn(
        f"HYDRAGNN_PROFILE_AT_STEP={value!r} is not '<epoch>:<step>' or "
        "'<step>' — profiling will not arm",
        stacklevel=2,
    )
    return None


# ---- the step schedule ------------------------------------------------------


class Profiler:
    """Step-scheduled tracing: a wait/warmup/active schedule (the shape of
    ``torch.profiler.schedule``), a target-epoch gate, a Chrome trace under
    ``trace_dir``, and a no-op object when disabled, so that call sites
    stay unconditional. For a live run without a planned schedule use
    ``/profile?steps=N`` (:class:`TraceCapture`)."""

    def __init__(self, trace_dir: str = "./logs/profile", wait: int = 5, warmup: int = 3,
                 active: int = 3, target_epoch: Optional[int] = 1):
        self.trace_dir = trace_dir
        self.wait = wait
        self.warmup = warmup
        self.active = active
        self.target_epoch = target_epoch
        self.enabled = False
        self._epoch = None
        self._step = 0
        self._session = None

    def setup(self, config: dict):
        """Config section ``{"Profile": {"enable": 1, "trace_dir": ...}}``."""
        if not config:
            return
        self.enabled = bool(config.get("enable", 0))
        self.trace_dir = config.get("trace_dir", self.trace_dir)
        self.wait = int(config.get("wait", self.wait))
        self.warmup = int(config.get("warmup", self.warmup))
        self.active = int(config.get("active", self.active))
        self.target_epoch = config.get("target_epoch", self.target_epoch)

    def set_current_epoch(self, epoch: int):
        self._epoch = epoch

    def _armed(self) -> bool:
        if not self.enabled:
            return False
        return self.target_epoch is None or self._epoch == self.target_epoch

    def __enter__(self):
        self._step = 0
        return self

    def __exit__(self, *exc):
        self._stop_trace()
        return False

    def step(self):
        """Advance the schedule: the trace starts after ``wait`` steps and
        stops after ``warmup + active`` more (the warm-up part is in it)."""
        if not self._armed():
            return
        self._step += 1
        if self._step == self.wait + 1:
            self._start_trace()
        elif self._step == self.wait + self.warmup + self.active + 1:
            self._stop_trace()

    def _start_trace(self):
        if self._session is None:
            self._session = _start_device_trace(self.trace_dir)

    def _stop_trace(self):
        if self._session is not None:
            session, self._session = self._session, None
            _stop_device_trace(session, self.trace_dir)


def record_function(name: str):
    """A named range in the profiler's timeline."""
    from torch.profiler import record_function as _rf

    return _rf(name)
