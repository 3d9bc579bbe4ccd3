"""The port's training telemetry (``hydragnn_tpu_torch/obs/runtime.py``,
``ledger.py``, ``introspect.py``, ``scalars.py``, ``utils/tracer.py``)
against the JAX package's, on the CPU.

- The goodput ledger: the JAX package's scenarios (``tests/test_goodput.py``:
  a streaming window with compile inside a step, data waits, checkpoint and
  guard costs, a window whose parts exceed its wall; a staged window with
  compile in and out of an eval span; a window with only a train wall; MFU
  by hand) driven through both ledgers under one fake clock: equal
  ``goodput`` events. The peak table: the H100's row by precision,
  ``HYDRAGNN_PEAK_FLOPS``, an unknown card warned once; ``bench_model``
  reads the same table.
- The flight recorder and ``parse_profile_at_step`` as the JAX package's
  on the same inputs; ``TraceCapture``'s lifecycle with a fake profiler (a
  failed start does not wedge it), and its ticks at dispatch boundaries
  (staged epochs, chunks) through a ``RunTelemetry``.
- Scalars: ``ScalarWriter.for_run``'s JSONL and CSV rows equal the JAX
  package's for the same calls and clock; the tracer's region file equals
  the JAX package's.
- The hooks are no-ops without an active run; ``init_run_telemetry``'s
  knobs (``HYDRAGNN_TELEMETRY``, ``Telemetry.enable``, the port's
  precedence ``telemetry_port`` > ``HYDRAGNN_OBS_PORT`` > ``Telemetry.port``)
  and ``/profile`` through the listener; the CPU's ``StepTimer``.
- Introspection: an instrumented program records one ``compile`` a novel
  shape key, its argument and output bytes, and, for a program that bills
  FLOPs, ``FlopCounterMode``'s count of the body (on the CPU nothing else
  is counted: there is no capture's warm-up).
- A tiny ``run_training`` on the CPU (PNA, ``ci.json``'s data: 16 training
  samples in batches of 4, 3 epochs, the guard with one poisoned step, the
  endpoint on an ephemeral port scraped at epoch 1's first scalar): the
  assertions of ``tests/test_observability.py``'s telemetry test; its
  stream passes both packages' ``validate_events``, and the JAX package's
  report of it is the port's, but for the port's two lines on its FLOP
  counter.
"""

import copy
import csv
import json
import os
import sys
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hydragnn_tpu.obs import introspect as jax_introspect
from hydragnn_tpu.obs import ledger as jax_ledger
from hydragnn_tpu.obs import report as jax_report
from hydragnn_tpu.obs import runtime as jax_runtime
from hydragnn_tpu.obs import scalars as jax_scalars
from hydragnn_tpu.obs.events import validate_events as jax_validate_events
from hydragnn_tpu.utils import tracer as jax_tracer

import hydragnn_tpu_torch
from hydragnn_tpu_torch.obs import introspect, ledger, report, runtime, scalars
from hydragnn_tpu_torch.obs.events import validate_events
from hydragnn_tpu_torch.obs.http import ObservabilityServer
from hydragnn_tpu_torch.train.capture import ProgramSet
from hydragnn_tpu_torch.utils import tracer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from synthetic import deterministic_graph_data  # noqa: E402

CI_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inputs", "ci.json")


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _ledger(mod, clock, compile_box):
    events = []
    led = mod.GoodputLedger(emit=lambda event, **f: events.append({"event": event, **f}),
                            compile_seconds=lambda: compile_box["s"], clock=clock)
    return led, events


def _streaming(led, clock, box, perf):
    led.epoch_begin(0)
    box["s"] += 0.3
    led.on_step(0.5, 1, compile_s=0.3)
    for _ in range(3):
        led.on_step(0.5, 1)
    led.data_wait(0.4)
    led.checkpoint_cost(0.2)
    led.guard_cost(0.1)
    clock.t += 10.0
    led.epoch_begin(1)
    led.on_step(5.0, 1)  # the parts exceed the wall: other 0, fractions still 1
    led.checkpoint_cost(5.0)
    clock.t += 1.0
    led.finalize()


def _staged(led, clock, box, perf):
    led.epoch_begin(0)
    box["s"] += 2.0
    led.note_train_wall(10.0)
    led.eval_begin()
    perf.t += 4.0
    box["s"] += 3.0  # the eval programs' captures, inside the span
    led.eval_end()
    clock.t += 15.0
    led.finalize()


def _train_wall(led, clock, box, perf):
    led.epoch_begin(0)
    led.note_train_wall(3.0)
    clock.t += 4.0
    led.finalize()


def _mfu(led, clock, box, perf):
    led.note_program({"name": "train_step", "bucket": "train_step/abc", "cost": {"flops": 1e6}})
    led.note_program({"name": "eval_step", "bucket": "eval_step/def", "cost": {"flops": 5e5}})
    led.note_program({"name": "train_multi", "bucket": "train_multi/0f", "cost": {"flops": 3e6}})
    led.epoch_begin(0)
    for _ in range(10):
        led.on_step(0.01, 1)
    clock.t += 1.0
    led.finalize()


SCENARIOS = {"streaming": _streaming, "staged": _staged, "train_wall": _train_wall, "mfu": _mfu}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def pytest_goodput_ledger_as_jax(monkeypatch, scenario):
    monkeypatch.setenv("HYDRAGNN_PEAK_FLOPS", "2e9")
    perf = _Clock(50.0)
    monkeypatch.setattr(time, "perf_counter", perf)  # the eval span's clock, both modules
    runs = []
    for mod in (ledger, jax_ledger):
        clock, box = _Clock(), {"s": 0.0}
        led, events = _ledger(mod, clock, box)
        SCENARIOS[scenario](led, clock, box, perf)
        runs.append(events)
    got, want = runs
    assert got == want and got
    for g in got:
        assert abs(sum(g["fractions"].values()) - 1.0) < 1e-6
    if scenario == "mfu":
        m = got[-1]["mfu"]
        assert set(m) == {"train_step/abc", "train_multi/0f"}
        assert abs(m["train_step/abc"]["mfu"] - 1e6 * 100.0 / 2e9) < 1e-9


def pytest_peak_table_env_and_unknown_card(monkeypatch):
    from hydragnn_tpu_torch.benchmarks.model_bench import PEAK_TFLOPS

    h100 = "NVIDIA H100 80GB HBM3"
    assert ledger.resolve_peak_flops(h100, mixed=True) == 989e12
    assert ledger.resolve_peak_flops(h100, mixed=False) == 67e12
    assert PEAK_TFLOPS[h100] == {"bf16": 989.0, "f32": 67.0}  # the bench reads this table
    ledger.note_precision(True, source="test")
    try:
        assert ledger.resolve_peak_flops(h100) == 989e12
    finally:
        ledger.note_precision(False, source="test")
    monkeypatch.setenv("HYDRAGNN_PEAK_FLOPS", "1.5e12")
    assert ledger.resolve_peak_flops("anything") == 1.5e12
    monkeypatch.delenv("HYDRAGNN_PEAK_FLOPS")
    monkeypatch.setattr(ledger, "_peak_warned", set())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert ledger.resolve_peak_flops("cpu") is None
        assert ledger.resolve_peak_flops("cpu") is None
    assert len([c for c in caught if "'cpu'" in str(c.message)]) == 1
    assert ledger.TRAIN_PROGRAMS == {"train_step", "train_multi", "epoch_scan"}


def pytest_flight_recorder_as_jax():
    times = list(np.random.default_rng(3).lognormal(-4.0, 0.2, 80))
    times[30] *= 20.0
    times[55] *= 9.0
    for capacity, min_fill in ((64, 8), (8, 20), (1, 1)):
        port = runtime.FlightRecorder(capacity, 8.0, min_fill)
        ref = jax_runtime.FlightRecorder(capacity, 8.0, min_fill)
        assert [port.record(t) for t in times] == [ref.record(t) for t in times]
        assert port.snapshot() == ref.snapshot() and port.count == ref.count


@pytest.mark.parametrize("value", [None, "", "  ", "7", "2:5", "x", "1:2:3", "a:b"])
def pytest_parse_profile_at_step_as_jax(value):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = introspect.parse_profile_at_step(value)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jax_introspect.parse_profile_at_step(value)
    assert got == want
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]


class _FakeProfiler:
    def __init__(self, monkeypatch, fail_first=False):
        self.calls = []
        self.fail_first = fail_first
        monkeypatch.setattr(introspect, "_start_device_trace", self.start)
        monkeypatch.setattr(introspect, "_stop_device_trace", self.stop)

    def start(self, trace_dir):
        if self.fail_first:
            self.fail_first = False
            raise RuntimeError("profiler already active")
        self.calls.append(("start", trace_dir))
        return "session"

    def stop(self, session, trace_dir):
        self.calls.append(("stop", session))
        return os.path.join(trace_dir, "trace.json")


def pytest_trace_capture_lifecycle(monkeypatch, tmp_path):
    fake = _FakeProfiler(monkeypatch)
    tc = introspect.TraceCapture(str(tmp_path / "tr"))
    assert tc.arm(0)["status"] == "error"
    assert tc.tick() is None  # idle
    assert tc.arm(2)["status"] == "armed"
    assert tc.arm(1)["status"] == "busy"  # one capture at a time
    started = tc.tick()
    assert started["status"] == "started" and started["steps"] == 2
    assert fake.calls == [("start", str(tmp_path / "tr"))]
    assert tc.tick() is None
    done = tc.tick()
    assert done == {"status": "done", "trace_dir": str(tmp_path / "tr"),
                    "trace": str(tmp_path / "tr" / "trace.json")}
    assert fake.calls[-1] == ("stop", "session")
    assert tc.tick() is None and tc.close() is None
    # a run ending mid capture still stops the profiler
    assert tc.arm(5)["status"] == "armed" and tc.tick()["status"] == "started"
    assert tc.close()["status"] == "done"


def pytest_trace_capture_start_failure_does_not_wedge(monkeypatch, tmp_path):
    _FakeProfiler(monkeypatch, fail_first=True)
    tc = introspect.TraceCapture(str(tmp_path / "tr"))
    assert tc.arm(1)["status"] == "armed"
    err = tc.tick()
    assert err["status"] == "error" and "already active" in err["error"]
    assert tc.arm(1)["status"] == "armed"
    assert tc.tick()["status"] == "started"
    assert tc.tick()["status"] == "done"


def pytest_profile_ticks_at_dispatch_boundaries(monkeypatch, tmp_path):
    """Staged epochs and chunks tick the capture once a dispatch; a step of
    such a dispatch does not (``on_dispatch(tick=False)``)."""
    fake = _FakeProfiler(monkeypatch)
    t = runtime.activate(runtime.RunTelemetry("fitp", str(tmp_path / "fitp")))
    try:
        assert t.profile(1)["status"] == "armed"
        runtime.epoch_start(0)
        t.on_dispatch(7, tick=False)
        assert fake.calls == []
        runtime.dispatch_boundary()  # chunk 1: the trace starts
        assert fake.calls == [("start", t.trace.trace_dir)]
        runtime.dispatch_boundary()  # chunk 2: flushed
        assert fake.calls[-1][0] == "stop"
        assert t.profile(1)["status"] == "armed"  # not wedged
        assert t.metrics.snapshot()["steps_total"] == 7
    finally:
        runtime.deactivate()
    recs = validate_events(str(tmp_path / "fitp" / "events.jsonl"), require=["profile"])
    assert [r["status"] for r in recs if r["event"] == "profile"] == [
        "armed", "started", "done", "armed"]


def pytest_scalars_as_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    for fmt in ("jsonl", "csv"):
        monkeypatch.setenv("HYDRAGNN_SCALAR_FORMAT", fmt)
        for mod, root in ((scalars, tmp_path / "port"), (jax_scalars, tmp_path / "jax")):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                w = mod.ScalarWriter.for_run(f"run-{fmt}", path=str(root))
            w.add_scalar("train error", 0.5, 0)
            w.add_scalar("validate error", np.float32(0.25), 1)
            w.add_regions({"train": 1.5, "dataload": 0.5}, step=2)
            w.close()
        name = "scalars.jsonl" if fmt == "jsonl" else "scalars.csv"
        got = open(tmp_path / "port" / f"run-{fmt}" / name).read()
        assert got == open(tmp_path / "jax" / f"run-{fmt}" / name).read()
        assert got.count("\n") == 4 + (fmt == "csv")
    rows = list(csv.reader(open(tmp_path / "port" / "run-csv" / "scalars.csv")))
    assert rows[0] == ["tag", "value", "step", "ts"]


def pytest_scalars_warn_once_without_tensorboard(monkeypatch, tmp_path):
    monkeypatch.setattr(scalars, "_tb_warned", False)

    def _boom(self, log_dir):
        raise ImportError("no tensorboard here")

    monkeypatch.setattr(scalars.TensorBoardScalarBackend, "__init__", _boom)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        w1 = scalars.ScalarWriter.for_run("runA", path=str(tmp_path))
        w2 = scalars.ScalarWriter.for_run("runB", path=str(tmp_path))
    assert len([c for c in caught if "TensorBoard" in str(c.message)]) == 1
    w1.add_scalar("x", 1.0, 0)
    w1.close()
    w2.close()
    assert os.path.exists(tmp_path / "runA" / "scalars.jsonl")


def pytest_tracer_region_file_as_jax(monkeypatch, tmp_path):
    clock = _Clock(10.0)
    monkeypatch.setattr(time, "perf_counter", clock)
    files = []
    for mod in (tracer, jax_tracer):
        monkeypatch.setattr(mod, "_tracers", {})
        mod.initialize(("timer",))
        for name, dt in (("train", 1.25), ("dataload", 0.5), ("train", 0.25)):
            mod.start(name)
            clock.t += dt
            mod.stop(name)
        assert mod.totals() == {"train": 1.5, "dataload": 0.5}
        path = str(tmp_path / f"{mod.__name__}.txt")
        mod._tracers["timer"].pr_file(path)
        files.append(open(path).read())
    assert files[0] == files[1]
    # the C++ region timer registers in both packages (g++ is here)
    for mod in (tracer, jax_tracer):
        monkeypatch.setattr(mod, "_tracers", {})
    assert tracer.initialize(("native",)) == jax_tracer.initialize(("native",)) == ["native"]


def pytest_hooks_are_noops_when_inactive(tmp_path):
    runtime.deactivate()
    assert runtime.active() is None
    t0 = time.perf_counter()
    for _ in range(20000):
        runtime.emit("epoch", epoch=1)
        runtime.epoch_start(1)
        runtime.dispatch_boundary()
        runtime.epoch_complete(1, 0.5, 0.5, 0.5, seconds=1.0)
        runtime.guard_skip("step", 1)
        runtime.guard_restore(1, 0.1, seconds=0.1)
        runtime.checkpoint_saved("x", kind="primary", snapshot_s=0.1)
        runtime.checkpoint_restored("x", source="primary")
        runtime.data_wait(0.1)
        runtime.eval_start()
        runtime.eval_complete()
    assert time.perf_counter() - t0 < 2.5  # 220k calls: one global read each
    assert runtime.active() is None and not introspect.enabled()


def pytest_init_run_telemetry_knobs_and_profile(monkeypatch, tmp_path):
    cfg = {"NeuralNetwork": {"Training": {"num_epoch": 3}}}
    monkeypatch.setenv("HYDRAGNN_TELEMETRY", "0")
    assert runtime.init_run_telemetry(cfg, "off", path=str(tmp_path)) is None
    monkeypatch.delenv("HYDRAGNN_TELEMETRY")
    assert runtime.init_run_telemetry({"Telemetry": {"enable": False}}, "off",
                                      path=str(tmp_path)) is None
    assert runtime.active() is None
    _FakeProfiler(monkeypatch)
    monkeypatch.setenv("HYDRAGNN_OBS_PORT", "0")
    # telemetry_port beats HYDRAGNN_OBS_PORT, which beats Telemetry.port
    busy = ObservabilityServer(runtime.TrainingMetrics(), port=0).start()
    taken = busy.address[1]
    try:
        t = runtime.init_run_telemetry(dict(cfg, Telemetry={"port": taken}), "on",
                                       path=str(tmp_path), device="cpu")
        assert t is not None and runtime.active() is t and t.address[1] != taken
        host, port = t.address
        base = f"http://{host}:{port}"
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read())
        assert health["status"] == "ok" and health["run"] == "on"
        armed = json.loads(urllib.request.urlopen(base + "/profile?steps=2", timeout=10).read())
        assert armed["status"] == "armed" and armed["steps"] == 2
        busy_reply = json.loads(urllib.request.urlopen(base + "/profile", timeout=10).read())
        assert busy_reply["status"] == "busy"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/profile?steps=x", timeout=10)
        assert err.value.code == 400
        runtime.deactivate()
        t2 = runtime.init_run_telemetry(cfg, "arg", path=str(tmp_path), port=0)
        assert t2.address is not None
    finally:
        runtime.deactivate()
        busy.stop()
    recs = validate_events(str(tmp_path / "on" / "events.jsonl"),
                           require=["run_manifest", "profile", "run_end"])
    man = recs[0]
    assert (man["num_epoch"], man["device_kind"], man["world_size"]) == (3, "cpu", 1)
    assert len(man["config_hash"]) == 12 and "FlopCounterMode" in man["flops_counter"]
    jax_validate_events(str(tmp_path / "on" / "events.jsonl"))


def pytest_step_timer_on_the_cpu():
    seen = []

    class Sink:
        def on_step_time(self, seconds, count, compile_s):
            seen.append((seconds, count, compile_s))

    timer = runtime.StepTimer(Sink(), "cpu")
    for count in (1, 4, 2):
        mark = timer.start()
        runtime.note_compile(0.5 if count == 4 else 0.0)
        timer.stop(mark, count)
    timer.flush(keep=2)
    assert [(c, s) for _, c, s in seen] == [(1, 0.0), (4, 0.5)]
    assert all(sec >= 0 for sec, _, _ in seen)
    timer.flush()
    assert len(seen) == 2  # flushed marks are gone


def pytest_instrumented_program_records_each_key(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_INTROSPECT", "1")
    lin = torch.nn.Linear(8, 4)
    progs = ProgramSet("cpu")
    prog = introspect.instrument(progs.program("fwd", lambda x: lin(x)), always=True)
    x = torch.randn(5, 8)
    with FlopCounterMode(display=False) as counter:
        lin(x)
    prog(x)
    prog(x)
    prog.prepare(torch.randn(3, 8))  # a forward's key, accounted when prepared
    prog(torch.randn(3, 8))
    assert len(prog.records) == 2
    rec = prog.records[introspect.bucket_label("fwd", introspect.signature_key((x,)))]
    assert rec["cost"]["flops"] == float(counter.get_total_flops()) > 0
    assert rec["memory"] == {"argument_bytes": 5 * 8 * 4.0, "output_bytes": 5 * 4 * 4.0}
    assert rec["name"] == "fwd" and rec["capture_s"] == 0.0
    # a telemetry-instrumented program on the CPU: its bytes, no FLOPs (no
    # warm-up to count), recorded at its first call, not at a prepare
    step = introspect.instrument(progs.program("step", lambda x: lin(x), "step", mutates=True))
    step.prepare(x)
    assert step.records == {}
    step(x)
    (srec,) = step.records.values()
    assert srec["cost"] == {} and srec["memory"]["argument_bytes"] == 5 * 8 * 4.0
    monkeypatch.setenv("HYDRAGNN_INTROSPECT", "0")
    other = introspect.instrument(progs.program("off", lambda x: lin(x)))
    other(x)
    assert other.records == {}


# ---- a tiny run on the CPU ------------------------------------------------------

NUM_TRAIN, BATCH, EPOCHS = 16, 4, 3


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry_raw")
    with open(CI_JSON) as f:
        config = json.load(f)
    for name in config["Dataset"]["path"]:
        num = NUM_TRAIN if name == "train" else 4
        path = str(root / f"{name}_{num}")
        deterministic_graph_data(path, number_configurations=num)
        config["Dataset"]["path"][name] = path
    training = config["NeuralNetwork"]["Training"]
    training.update(num_epoch=EPOCHS, batch_size=BATCH, divergence_guard=True,
                    resume_every=1)
    return config


class _ScrapeAtEpochOne:
    """The run's scalar writer, wrapped: the first scalar of epoch 1 scrapes
    the live ``/metrics``."""

    scraped = None

    def __init__(self, inner):
        self.inner = inner

    def add_scalar(self, tag, value, step):
        self.inner.add_scalar(tag, value, step)
        if _ScrapeAtEpochOne.scraped is None and step >= 1:
            host, port = runtime.active().address
            _ScrapeAtEpochOne.scraped = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=10).read().decode()

    def add_regions(self, regions, step=0):
        self.inner.add_regions(regions, step)

    def close(self):
        self.inner.close()


def _without_port_lines(text):
    return text.replace(
        "captured programs (FlopCounterMode FLOPs, allocator bytes)",
        "compiled programs (XLA cost/memory)").replace(
        "Captured programs (FlopCounterMode FLOPs, allocator bytes)",
        "Compiled programs (XLA cost/memory)")


def pytest_run_training_telemetry_e2e(tiny_config, tmp_path, monkeypatch):
    from hydragnn_tpu_torch.train import driver

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SERIALIZED_DATA_PATH", str(tmp_path))
    monkeypatch.setenv("HYDRAGNN_FAULT_NAN_AT_STEP", "2")

    class Writer:
        for_run = staticmethod(lambda *a, **k: _ScrapeAtEpochOne(
            scalars.ScalarWriter.for_run(*a, **k)))

    monkeypatch.setattr(driver, "ScalarWriter", Writer)
    _ScrapeAtEpochOne.scraped = None
    state = hydragnn_tpu_torch.run_training(copy.deepcopy(tiny_config), device="cpu",
                                            telemetry_port=0)
    assert runtime.active() is None
    mid = _ScrapeAtEpochOne.scraped
    assert mid is not None, "the mid-run scrape never happened"
    for needle in ("hydragnn_train_epochs_total", "hydragnn_train_graphs_per_second",
                   "hydragnn_train_guard_skips_total 1", "hydragnn_train_heartbeat_age_seconds"):
        assert needle in mid, needle
    log_dir = tmp_path / "logs" / state.info["log_name"]
    path = str(log_dir / "events.jsonl")
    require = ["run_manifest", "epoch", "compile", "checkpoint_saved", "guard_skip", "goodput",
               "tracer_totals", "run_end"]
    recs = validate_events(path, require=require)
    assert [r["seq"] for r in jax_validate_events(path, require=require)] == [
        r["seq"] for r in recs]
    epochs = [r for r in recs if r["event"] == "epoch"]
    assert [e["epoch"] for e in epochs] == list(range(EPOCHS))
    assert all(e["wall_time_s"] > 0 and e["graphs_per_sec"] > 0 for e in epochs)
    assert all(0.0 <= e["padding_waste"] < 1.0 and e["mode"] == "stream" for e in epochs)
    ckpts = [r for r in recs if r["event"] == "checkpoint_saved"]
    assert len(ckpts) >= EPOCHS and all(c["kind"] == "primary" and c["resumable"]
                                        for c in ckpts)
    (guard,) = [r for r in recs if r["event"] == "guard_skip"]
    assert guard["scope"] == "step"
    goodput = [r for r in recs if r["event"] == "goodput"]
    assert [g["epoch"] for g in goodput] == list(range(EPOCHS))
    assert all(abs(sum(g["fractions"].values()) - 1.0) < 1e-6 for g in goodput)
    assert sum(g["steps"] for g in goodput) == EPOCHS * NUM_TRAIN // BATCH
    assert not any("mfu" in g for g in goodput)  # no FLOPs on the CPU: no capture to count
    compiles = {r["name"]: r for r in recs if r["event"] == "compile"}
    assert set(compiles) == {"train_step", "eval_step"}
    assert all(c["cost"] == {} and c["memory"]["argument_bytes"] > 0 for c in compiles.values())
    assert recs[-1]["event"] == "run_end" and recs[-1]["status"] == "complete"
    assert os.path.exists(log_dir / "scalars.jsonl") and os.path.exists(log_dir / "trace.0")
    # the JAX package's report of the port's stream
    got = report.build_report(report.load_events(path))
    want = jax_report.build_report(jax_report.load_events(path))
    assert got["run"].pop("flops_counter").startswith("torch.utils.flop_counter")
    assert got == want
    for fmt in ("text", "markdown", "json"):
        ours = report.RENDERERS[fmt](report.build_report(report.load_events(path)))
        theirs = jax_report.RENDERERS[fmt](want)
        lines = [ln for ln in ours.splitlines() if not ln.startswith("flops: ")
                 and '"flops_counter":' not in ln]
        assert _without_port_lines("\n".join(lines) + "\n") == theirs, fmt
