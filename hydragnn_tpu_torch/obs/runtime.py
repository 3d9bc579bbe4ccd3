"""Run-scoped telemetry: the glue between the training code and the obs
primitives (port of ``obs/runtime.py``).

One :class:`RunTelemetry` per training run bundles the event stream
(``events.jsonl``), the live ``/metrics`` + ``/healthz`` + ``/profile``
endpoint, the training metrics, the goodput ledger, the flight recorder
and the trace capture, behind module-level hooks (:func:`emit`,
:func:`epoch_complete`, :func:`guard_skip`, ...) that the epoch driver,
the trainer, the divergence guard and the checkpoint layer call
unconditionally. With no active run each hook is one global read and a
return. The trainer's per-step path resolves :func:`active` once per
pass.

Step time on the card. A captured step's replay returns to the host long
before the card has run it, so a step timed on the host would read the
enqueue, not the step. :class:`StepTimer` times each training replay with a
pair of CUDA events recorded around its input copy and the replay, and
resolves them at the pass's own readback (:meth:`StepTimer.flush`): no host
sync is added, and the host's packing of a batch (which a step that syncs,
as a guarded one does, would otherwise show as the card's idle time) stays
out. On the CPU the
host's clock is the step's. The per-dispatch half of the hook
(:meth:`RunTelemetry.on_dispatch`: the step counter, the trace capture's
tick, ``HYDRAGNN_PROFILE_AT_STEP``) runs at the dispatch; the timed half
(:meth:`RunTelemetry.on_step_time`: the step-time histogram, the goodput
ledger, the flight recorder's stall check) at the flush.

The compile signal. The JAX package counts XLA compiles through a
``jax.monitoring`` listener; here a compile is a program's capture
(``train/capture.py``: its warm-up, with the first-launch ``nvcc`` build
of a kernel source it launches, ``ops/_build.py``, and the graph's
capture, seconds measured on the host), which calls :func:`note_compile`:
the process-wide :func:`compile_events` and :func:`compile_seconds`, the
run's ``compiles_total`` and the ledger's ``compile`` category. A step whose
dispatch captured is compile time, not a stall.

Enablement (one process per run in the port):

- events + metrics: on by default for driver runs; ``HYDRAGNN_TELEMETRY=0``
  or ``config["Telemetry"]["enable"] = false`` turns them off.
- the HTTP endpoint: opt-in, ``run_training(telemetry_port=...)`` >
  ``HYDRAGNN_OBS_PORT`` > ``config["Telemetry"]["port"]`` (0: an
  ephemeral port, :attr:`RunTelemetry.address`).
- ``HYDRAGNN_PROFILE_AT_STEP=<epoch>:<step>`` (and ``_STEPS``, 3) arms a
  trace; ``HYDRAGNN_FLIGHT_STEPS`` (64) and ``HYDRAGNN_STALL_FACTOR`` (8)
  size the flight recorder.
"""

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from hydragnn_tpu_torch.obs.events import SCHEMA_VERSION, RunEventLog
from hydragnn_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BOUNDS,
    EPOCH_LATENCY_BOUNDS,
    MetricsRegistry,
)

_active: Optional["RunTelemetry"] = None

# what the port's FLOP counts hold: the manifest says so, and the report
# prints it in its header (obs/report.py)
FLOPS_COUNTER = ("torch.utils.flop_counter.FlopCounterMode over each capture's warm-up: "
                 "aten operations only, the hand-written kernels K1-K7 not counted")


class FlightRecorder:
    """Ring buffer of the last K step times, with stall detection.

    A step is a STALL when its time strictly exceeds ``stall_factor`` x
    the rolling median of the buffered window (median, not mean: an
    earlier stall must not drag the threshold up). No stall fires before
    ``min_fill`` steps are buffered; the caller leaves out the steps that
    captured a program (their time is compile time). One training thread
    owns it; ``snapshot()`` from other threads reads a copy."""

    def __init__(self, capacity: int = 64, stall_factor: float = 8.0, min_fill: int = 8):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.stall_factor = float(stall_factor)
        # clamped into [1, capacity]: a window smaller than min_fill could
        # otherwise never satisfy the fill gate
        self.min_fill = max(min(int(min_fill), self.capacity), 1)
        self._buf: List[float] = [0.0] * self.capacity
        self._count = 0  # total steps ever recorded

    def record(self, seconds: float) -> Optional[Dict]:
        """Add one step time; returns the stall payload (step/seconds/
        median/factor) when the step stalled, else None. The step is judged
        by the window before it, then buffered (a regime change
        re-baselines within a window)."""
        stall = None
        filled = min(self._count, self.capacity)
        if filled >= self.min_fill:
            window = sorted(self._buf[:filled] if self._count < self.capacity else self._buf)
            mid = filled // 2
            median = window[mid] if filled % 2 else 0.5 * (window[mid - 1] + window[mid])
            if seconds > self.stall_factor * median:
                stall = {"step": self._count, "seconds": seconds, "median": median,
                         "factor": self.stall_factor}
        self._buf[self._count % self.capacity] = float(seconds)
        self._count += 1
        return stall

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> List[float]:
        """Buffered step times, oldest first."""
        if self._count < self.capacity:
            return self._buf[: self._count]
        i = self._count % self.capacity
        return self._buf[i:] + self._buf[:i]


class TrainingMetrics:
    """The training run's live series: everything ``/metrics`` reports (the
    JAX package's families, in its order, but for those of paths not ported
    yet: elastic worlds and their fleet view, the autotuner's choice and
    mesh collectives)."""

    def __init__(self, device=None):
        self.device = device
        r = MetricsRegistry("hydragnn_train")
        r.counter("epochs_total", "Completed epochs")
        r.counter("steps_total", "Dispatched optimizer steps")
        r.counter("guard_skips_total", "Non-finite steps/epochs skipped")
        r.counter("guard_restores_total", "Last-good restores (halved LR)")
        r.counter("checkpoints_saved_total", "Checkpoint files written")
        r.counter("compiles_total", "Program captures observed")
        r.gauge("epoch", "Current epoch index")
        r.gauge("train_loss", "Last epoch training loss")
        r.gauge("val_loss", "Last epoch validation loss")
        r.gauge("test_loss", "Last epoch test loss")
        r.gauge("graphs_per_second", "Last epoch training throughput")
        r.gauge("nodes_per_second", "Last epoch real-node-row throughput")
        r.gauge("padding_waste_ratio", "Padded node rows carrying no real node (training batches)")
        r.gauge("heartbeat_age_seconds", "Seconds since the training loop last reported progress")
        r.counter("stalls_total", "Steps exceeding the stall threshold")
        r.gauge("world_size", "Processes in the current training world")
        r.labeled_gauge("flops_per_step",
                        "Captured-program FLOPs (FlopCounterMode over the warm-up)")
        r.labeled_gauge("hbm_peak_bytes", "Captured-program peak device memory (warm-up and capture)")
        # the streaming data plane (data/stream/): per-epoch pipeline health
        r.gauge("stream_queue_depth", "Collated batches ready ahead of the consumer")
        r.gauge("stream_stall_seconds",
                "Seconds the consumer waited on the stream pipeline last epoch")
        r.gauge("stream_bytes_per_second", "Streamed sample bytes/sec last epoch")
        r.gauge("stream_open_shards_peak", "Most shards any source held resident at once")
        r.gauge("stream_resident_bytes_peak", "Peak host bytes pinned by stream window buffers")
        r.counter("stream_samples_total", "Samples drawn from the stream mix")
        r.counter("stream_oversize_dropped_total",
                  "Samples dropped because no bucket of the plan could hold them")
        r.labeled_gauge("stream_source_fraction", "Fraction of last epoch's draws per mix source")
        r.labeled_gauge("goodput_fraction", "Last epoch's wall-time fraction per goodput category")
        r.labeled_gauge("mfu", "Model FLOPs utilization per train bucket (vs device peak)")
        r.gauge("device_bytes_in_use", "Live device memory in use")
        r.gauge("device_peak_bytes_in_use", "Peak device memory since start")
        r.histogram("epoch_seconds", "Epoch wall time", bounds=EPOCH_LATENCY_BOUNDS)
        r.histogram("step_dispatch_seconds",
                    "Train-step time (device time on the card, from CUDA events)",
                    bounds=DEFAULT_LATENCY_BOUNDS)
        self.registry = r
        self.last_beat = time.time()

    def beat(self):
        self.last_beat = time.time()

    def on_dispatch(self, count: int = 1):
        self.registry.inc("steps_total", count)
        # steps are progress: heartbeat_age must not grow through an epoch
        self.last_beat = time.time()

    def on_step_time(self, seconds: float):
        self.registry.observe("step_dispatch_seconds", seconds)

    def on_epoch(self, epoch: int, train_loss: float, val_loss: float, test_loss: float,
                 seconds: Optional[float] = None, graphs_per_sec: Optional[float] = None,
                 nodes_per_sec: Optional[float] = None, padding_waste: Optional[float] = None):
        r = self.registry
        r.inc("epochs_total")
        r.set("epoch", float(epoch))
        r.set("train_loss", float(train_loss))
        r.set("val_loss", float(val_loss))
        r.set("test_loss", float(test_loss))
        if seconds is not None:
            r.observe("epoch_seconds", seconds)
        if graphs_per_sec is not None:
            r.set("graphs_per_second", float(graphs_per_sec))
        if nodes_per_sec is not None:
            r.set("nodes_per_second", float(nodes_per_sec))
        if padding_waste is not None:
            r.set("padding_waste_ratio", float(padding_waste))
        self.beat()

    def poll_device_memory(self):
        """Refresh the live-memory gauges from the run's card
        (``torch.cuda.memory_stats``; at scrape time, never in the step
        loop). Nothing on the CPU."""
        import torch

        from hydragnn_tpu_torch.obs import introspect

        dev = self.device
        if dev is None or torch.device(dev).type != "cuda":
            return
        try:
            stats = torch.cuda.memory_stats(dev)
        except Exception:
            return
        self.registry.set("device_bytes_in_use", float(stats.get("allocated_bytes.all.current", 0)))
        self.registry.set("device_peak_bytes_in_use",
                          float(introspect.max_memory_allocated(dev)))

    def render_prometheus(self) -> str:
        self.registry.set("heartbeat_age_seconds", max(time.time() - self.last_beat, 0.0))
        self.poll_device_memory()
        return self.registry.render_prometheus()

    def snapshot(self) -> Dict:
        return self.registry.snapshot()


# process-wide compile signal (note_compile): the captures, kernel builds
# in their warm-ups included, whether or not a run is active
_compile_lock = threading.Lock()
_compile_events = 0
_compile_seconds = 0.0


def note_compile(seconds: float):
    """A program was captured, taking ``seconds`` on the host
    (``train/capture.py``)."""
    global _compile_events, _compile_seconds
    with _compile_lock:
        _compile_events += 1
        _compile_seconds += max(float(seconds), 0.0)
    t = _active
    if t is not None:
        t.metrics.registry.inc("compiles_total")


def compile_events() -> int:
    """Captures observed in this process."""
    return _compile_events


def compile_seconds() -> float:
    """Their seconds: the goodput ledger's ``compile`` signal."""
    return _compile_seconds


def _config_hash(config: dict) -> str:
    try:
        blob = json.dumps(config, sort_keys=True, default=str)
    except (TypeError, ValueError):
        blob = repr(config)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


_GIT_REV: List[str] = []  # the checkout's revision, read once a process


def _git_rev() -> str:
    if not _GIT_REV:
        try:
            import subprocess

            out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                                 text=True, timeout=5,
                                 cwd=os.path.dirname(os.path.abspath(__file__)))
            _GIT_REV.append(out.stdout.strip() or "unknown")
        except Exception:
            _GIT_REV.append("unknown")
    return _GIT_REV[0]


class StepTimer:
    """Times a pass's training steps without a host sync (the module's
    docstring): the trainer sets it on its programs for the pass
    (``capture.ProgramSet.timer``), and each training program marks its
    replay, :meth:`start` just before the input copy and the replay (after
    the host's packing, and after a capture) and :meth:`stop` after them;
    :meth:`flush` after the pass's readback. On the card each mark is a
    pair of CUDA events on the current stream; on the CPU the host's clock
    around the body. Each mark carries the compile seconds inside it."""

    def __init__(self, telemetry: "RunTelemetry", device):
        import torch

        self.telemetry = telemetry
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._pending = []

    def start(self):
        compile_s = _compile_seconds
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev, compile_s
        return time.perf_counter(), compile_s

    def stop(self, mark, count: int = 1):
        begin, compile_s = mark
        if self.cuda:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
        else:
            end = time.perf_counter()
        self._pending.append((begin, end, int(count), _compile_seconds - compile_s))

    def flush(self, keep: Optional[int] = None):
        """Hand the marks' times to the run (after a readback: on the card
        every mark's events are complete). ``keep``: only the first
        ``keep`` marks count (a chunk's inert epochs ran no real step)."""
        pending, self._pending = self._pending, []
        if keep is not None:
            pending = pending[:keep]
        for begin, end, count, compile_s in pending:
            seconds = begin.elapsed_time(end) / 1e3 if self.cuda else end - begin
            self.telemetry.on_step_time(seconds, count, compile_s)


class RunTelemetry:
    """Everything observable about one training run, under one lifetime.

    The :class:`~hydragnn_tpu_torch.obs.http.ObservabilityServer` provider
    protocol: ``health()``, ``.metrics.render_prometheus()`` and
    ``profile(steps)``."""

    def __init__(self, run_name: str, log_dir: str, port: Optional[int] = None,
                 events: bool = True, events_file: str = "events.jsonl", device=None):
        from hydragnn_tpu_torch.obs.introspect import TraceCapture, parse_profile_at_step
        from hydragnn_tpu_torch.obs.ledger import GoodputLedger

        self.run_name = run_name
        self.log_dir = log_dir
        self.device = device
        self.metrics = TrainingMetrics(device)
        self.events: Optional[RunEventLog] = (
            RunEventLog(os.path.join(log_dir, events_file)) if events else None)
        self.server = None
        self._closed = False
        self.flight = FlightRecorder(
            capacity=int(os.getenv("HYDRAGNN_FLIGHT_STEPS", "64")),
            stall_factor=float(os.getenv("HYDRAGNN_STALL_FACTOR", "8.0")),
        )
        self.trace = TraceCapture(os.path.join(log_dir, "profile"))
        self._profile_at = parse_profile_at_step(os.getenv("HYDRAGNN_PROFILE_AT_STEP"))
        self._profile_steps = int(os.getenv("HYDRAGNN_PROFILE_STEPS", "3"))
        self.current_epoch = 0
        self._step_in_epoch = 0
        self._compile_seconds_at_step = _compile_seconds
        self.ledger = GoodputLedger(registry=self.metrics.registry, emit=self.emit,
                                    compile_seconds=compile_seconds)
        if port is not None:
            from hydragnn_tpu_torch.obs.http import ObservabilityServer

            self.server = ObservabilityServer(self, port=port).start()

    # ---- provider protocol ---------------------------------------------
    def health(self) -> Dict:
        s = self.metrics.snapshot()
        return {
            "status": "ok" if not self._closed else "stopped",
            "run": self.run_name,
            "epoch": int(s["epoch"]),
            "epochs_total": s["epochs_total"],
            "heartbeat_age_s": round(max(time.time() - self.metrics.last_beat, 0.0), 3),
        }

    @property
    def address(self):
        return None if self.server is None else self.server.address

    # ---- per-step instrumentation --------------------------------------
    def step_timer(self, device) -> StepTimer:
        return StepTimer(self, device)

    def on_dispatch(self, count: int = 1, tick: bool = True):
        """One dispatch of ``count`` steps was queued: the step counter,
        ``HYDRAGNN_PROFILE_AT_STEP`` and the trace capture's tick. Called
        from the training thread only. ``tick=False``: the steps of a
        staged epoch or a chunk, whose dispatch ticks at its boundary
        (:meth:`on_dispatch_boundary`)."""
        self.metrics.on_dispatch(count)
        self._step_in_epoch += count
        if not tick:
            return
        if (self._profile_at is not None and self.current_epoch == self._profile_at[0]
                and self._step_in_epoch >= self._profile_at[1]):
            self._profile_at = None
            self.profile(self._profile_steps)
        self._tick()

    def on_step_time(self, seconds: float, count: int = 1, compile_s: Optional[float] = None):
        """One dispatch's measured time: the histogram, the goodput ledger
        and the flight recorder. ``compile_s``: the compile seconds inside
        it (None: those since the last call)."""
        if compile_s is None:
            compile_s = _compile_seconds - self._compile_seconds_at_step
        self._compile_seconds_at_step = _compile_seconds
        compiled = compile_s > 0.0
        self.metrics.on_step_time(seconds)
        self.ledger.on_step(seconds, count, compile_s if compiled else 0.0)
        if not compiled:
            # per-step time: K-step dispatches compare with single ones
            stall = self.flight.record(seconds / max(int(count), 1))
            if stall is not None:
                self.metrics.registry.inc("stalls_total")
                self.emit("stall", step=int(stall["step"]),
                          seconds=round(float(stall["seconds"]), 6),
                          median=round(float(stall["median"]), 6),
                          factor=float(stall["factor"]), epoch=int(self.current_epoch))

    def on_epoch_start(self, epoch: int):
        self.current_epoch = int(epoch)
        self._step_in_epoch = 0
        # closes (and publishes) the previous goodput window: post-epoch
        # work such as the resumable save lands in its epoch
        self.ledger.epoch_begin(epoch)

    def on_dispatch_boundary(self):
        """A whole staged epoch or chunk was dispatched: the trace capture
        ticks here (a ``/profile`` step on this path is one such dispatch),
        and ``HYDRAGNN_PROFILE_AT_STEP`` resolves against the epoch."""
        if self._profile_at is not None and self.current_epoch >= self._profile_at[0]:
            self._profile_at = None
            self.profile(self._profile_steps)
        self._tick()

    def _tick(self):
        transition = self.trace.tick()
        if transition is not None:
            self.emit("profile", **transition)

    def record_compile(self, rec: Dict):
        """One novel (program, shape key) was captured: event and the
        per-bucket cost and memory gauges (obs/introspect.py)."""
        cost, mem, bucket = rec["cost"], rec["memory"], rec["bucket"]
        self.ledger.note_program(rec)  # training FLOPs feed the MFU
        if cost.get("flops"):
            self.metrics.registry.set_labeled("flops_per_step", float(cost["flops"]), bucket=bucket)
        if mem.get("peak_bytes"):
            self.metrics.registry.set_labeled("hbm_peak_bytes", float(mem["peak_bytes"]),
                                              bucket=bucket)
        self.emit("compile", name=rec["name"], bucket=bucket, cost=cost, memory=mem,
                  capture_s=rec["capture_s"])

    def profile(self, steps: int) -> Dict:
        """Arm a trace of the next ``steps`` dispatches: the
        ``/profile?steps=N`` hook (any thread)."""
        result = self.trace.arm(steps)
        if result.get("status") == "armed":
            self.emit("profile", **result)
        return result

    # ---- lifecycle -----------------------------------------------------
    def emit(self, event: str, **fields):
        if self.events is not None:
            self.events.emit(event, **fields)

    def emit_manifest(self, config: dict, run_name: str):
        import torch

        from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

        dev = torch.device(self.device) if self.device is not None else None
        on_card = dev is not None and dev.type == "cuda"
        world, _ = comm_size_and_rank()
        self.metrics.registry.set("world_size", float(world))
        self.emit(
            "run_manifest",
            schema_version=SCHEMA_VERSION,
            run=run_name,
            config_hash=_config_hash(config),
            git_rev=_git_rev(),
            world_size=world,
            device_kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
            device_count=torch.cuda.device_count() if on_card else 1,
            num_epoch=int(config.get("NeuralNetwork", {}).get("Training", {})
                          .get("num_epoch", 0)),
            flops_counter=FLOPS_COUNTER,
        )

    def close(self, status: str = "complete"):
        if self._closed:
            return
        self._closed = True
        try:
            self.ledger.finalize()  # the last epoch's goodput window
        except Exception:
            pass
        flushed = self.trace.close()  # a run ending mid capture still flushes
        if flushed is not None:
            self.emit("profile", **flushed)
        self.emit("run_end", status=status)
        if self.events is not None:
            self.events.close()
        if self.server is not None:
            self.server.stop()
            self.server = None


# ---- module-level hooks (one global read when no run is active) ---------


def active() -> Optional[RunTelemetry]:
    return _active


def activate(telemetry: RunTelemetry):
    global _active
    prev = _active
    _active = telemetry
    if prev is not None and prev is not telemetry:
        # a run that never deactivated (crashed between init and cleanup)
        # must not leak its stream into this one
        prev.close(status="abandoned")
    return telemetry


def deactivate(status: str = "complete"):
    global _active
    t = _active
    _active = None
    if t is not None:
        t.close(status)


def emit(event: str, **fields):
    t = _active
    if t is not None:
        t.emit(event, **fields)


def epoch_start(epoch: int):
    """The epoch driver announces each epoch (or chunk)."""
    t = _active
    if t is not None:
        t.on_epoch_start(epoch)


def dispatch_boundary():
    """A staged epoch or a chunk was dispatched whole."""
    t = _active
    if t is not None:
        t.on_dispatch_boundary()


def epoch_complete(epoch: int, train_loss, val_loss, test_loss, seconds=None,
                   graphs_per_sec=None, nodes_per_sec=None, padding_waste=None,
                   mode: str = "stream"):
    t = _active
    if t is None:
        return
    t.metrics.on_epoch(int(epoch), float(train_loss), float(val_loss), float(test_loss),
                       seconds=seconds, graphs_per_sec=graphs_per_sec,
                       nodes_per_sec=nodes_per_sec, padding_waste=padding_waste)
    if seconds is not None:
        # a whole-dispatch epoch without step times: the driver's train
        # wall is its compute signal
        t.ledger.note_train_wall(seconds)
    t.emit(
        "epoch",
        epoch=int(epoch),
        train_loss=float(train_loss),
        val_loss=float(val_loss),
        test_loss=float(test_loss),
        mode=mode,
        **({} if seconds is None else {
            "wall_time_s": round(float(seconds), 6),
            "graphs_per_sec": None if graphs_per_sec is None else round(float(graphs_per_sec), 3),
            "nodes_per_sec": None if nodes_per_sec is None else round(float(nodes_per_sec), 3),
        }),
        **({} if padding_waste is None else {"padding_waste": round(float(padding_waste), 6)}),
    )


def guard_skip(scope: str, skipped: int, streak: int = 0):
    t = _active
    if t is None:
        return
    t.metrics.registry.inc("guard_skips_total")
    t.emit("guard_skip", scope=scope, skipped=int(skipped), streak=int(streak))


def guard_restore(restores: int, lr: float, seconds: float = 0.0):
    t = _active
    if t is None:
        return
    t.metrics.registry.inc("guard_restores_total")
    t.ledger.guard_cost(seconds)
    t.emit("guard_restore", restores=int(restores), lr=float(lr),
           **({} if not seconds else {"seconds": round(float(seconds), 6)}))


def checkpoint_saved(name: str, kind: str, **fields):
    t = _active
    if t is None:
        return
    t.metrics.registry.inc("checkpoints_saved_total")
    # goodput: a sync save costs the loop the snapshot and the write; an
    # async one only the snapshot (the write overlaps)
    cost = float(fields.get("snapshot_s") or 0.0)
    if not fields.get("async"):
        cost += float(fields.get("write_s") or 0.0)
    t.ledger.checkpoint_cost(cost)
    t.emit("checkpoint_saved", name=name, kind=kind, **fields)


def checkpoint_restored(name: str, source: str):
    t = _active
    if t is None:
        return
    t.emit("checkpoint_restored", name=name, source=source)


def stream_epoch_stats(queue_depth: int = 0, stall_s: float = 0.0, bytes_per_sec: float = 0.0,
                       open_shards_peak: int = 0, resident_bytes_peak: int = 0, samples: int = 0,
                       oversize_dropped: int = 0,
                       source_counts: Optional[Dict[str, int]] = None):
    """One epoch of the streaming data plane completed (``data/stream/``):
    the ``stream_*`` gauges, and its stall seconds as the goodput ledger's
    data stall (the trainer does not time a loader that reports its own
    waits). No event: the epoch event carries the epoch's story."""
    t = _active
    if t is None:
        return
    t.ledger.data_wait(stall_s)
    r = t.metrics.registry
    r.set("stream_queue_depth", float(queue_depth))
    r.set("stream_stall_seconds", float(stall_s))
    r.set("stream_bytes_per_second", float(bytes_per_sec))
    r.set("stream_open_shards_peak", float(open_shards_peak))
    r.set("stream_resident_bytes_peak", float(resident_bytes_peak))
    if samples:
        r.inc("stream_samples_total", int(samples))
    if oversize_dropped:
        r.inc("stream_oversize_dropped_total", int(oversize_dropped))
    if source_counts:
        total = max(sum(source_counts.values()), 1)
        for name, n in source_counts.items():
            r.set_labeled("stream_source_fraction", n / total, source=name)


def data_wait(seconds: float):
    """The step loop waited ``seconds`` on the data path (collation, the
    copy to the card): the goodput ledger's data_stall."""
    t = _active
    if t is not None:
        t.ledger.data_wait(seconds)


def eval_start():
    """The epoch driver enters its evaluation: a goodput eval span (the
    compile and data waits inside it stay in their own categories)."""
    t = _active
    if t is not None:
        t.ledger.eval_begin()


def eval_complete():
    t = _active
    if t is not None:
        t.ledger.eval_end()


# ---- run construction ----------------------------------------------------


def telemetry_enabled(config: dict) -> bool:
    """``HYDRAGNN_TELEMETRY`` > ``config["Telemetry"]["enable"]`` (on)."""
    env = os.getenv("HYDRAGNN_TELEMETRY")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no", "off")
    return bool((config.get("Telemetry", {}) or {}).get("enable", True))


def init_run_telemetry(config: dict, log_name: str, path: str = "./logs/", port=None,
                       device=None) -> Optional[RunTelemetry]:
    """Build and activate the telemetry of a driver run under the knobs
    (the module's docstring); None (the hooks stay no-ops) when disabled
    or on a rank other than 0. ``port``: ``run_training(telemetry_port=)``,
    which beats ``HYDRAGNN_OBS_PORT`` and the config."""
    from hydragnn_tpu_torch.obs import ledger
    from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

    if not telemetry_enabled(config):
        return None
    if comm_size_and_rank()[1] != 0:
        return None
    if port is None:
        port_env = os.getenv("HYDRAGNN_OBS_PORT")
        if port_env is not None and port_env.strip() != "":
            port = int(port_env)
        elif (config.get("Telemetry", {}) or {}).get("port") is not None:
            port = int(config["Telemetry"]["port"])
    if device is not None:
        ledger.note_device(device)
    telemetry = RunTelemetry(log_name, os.path.join(path, log_name), port=port, device=device)
    telemetry.emit_manifest(config, log_name)
    return activate(telemetry)
