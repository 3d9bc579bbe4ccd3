"""Training telemetry on the card; marker ``cuda``, skipped inside the test
without one. Run on the card with
``python -m pytest tests/test_torch_telemetry_cuda.py -q -p no:randomly --noconftest``.

- A ``TraceCapture`` of two captured ``fused`` PNA steps (``torch.profiler``
  over two replays) leaves a Chrome trace whose kernel events name K3's
  kernel (``gather_reduce_kernel``, ``csrc/gather_reduce.cuh``) and K1's
  (``segment_sum_runs_kernel``, ``csrc/segment.cu``).
- The introspection record of a captured step and of a captured forward:
  ``argument_bytes`` equal to the inputs' bytes, ``output_bytes`` to the
  outputs', a ``peak_bytes`` above zero and at most what the allocator
  holds after the capture, FLOPs equal to ``FlopCounterMode``'s count of an
  eager step on a copy, and ``capture_s`` above zero; the run's compile
  signal grew by the capture.
- The ``StepTimer``'s CUDA-event time of a replay, read after the pass's
  sync, against the host's wall of the same replay up to that sync: above
  zero and not above it.
"""

import copy
import json
import os
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hydragnn_tpu_torch.obs import introspect, runtime
from hydragnn_tpu_torch.train import steps

from test_torch_capture_cuda import _setup

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured programs have no CPU mode")
    return torch.device("cuda")


def _kernel_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def pytest_trace_capture_names_k3_and_k1(card, tmp_path):
    trainer, state, batch = _setup("PNA", card, aggregation="fused")
    trainer.train_step(state, batch)  # the capture
    tc = introspect.TraceCapture(str(tmp_path / "profile"))
    assert tc.arm(2)["status"] == "armed"
    assert tc.tick()["status"] == "started"
    for _ in range(2):
        trainer.train_step(state, batch)
        out = tc.tick()
    assert out["status"] == "done" and os.path.isabs(out["trace"])
    names = _kernel_names(out["trace"])
    assert any("gather_reduce_kernel" in n for n in names), sorted(names)[:20]
    assert any("segment_sum_runs_kernel" in n for n in names), sorted(names)[:20]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pytest_capture_record_memory_and_flops(card, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_INTROSPECT", "1")
    trainer, state, batch = _setup("PNA", card, aggregation="fused")
    flop_model, flop_opt = copy.deepcopy((state.model, state.optimizer))
    with FlopCounterMode(display=False) as counter:
        steps.train_body(flop_model, flop_opt, trainer.put_batch(batch))
    compiles = runtime.compile_events()
    trainer.train_step(state, batch)
    assert runtime.compile_events() > compiles
    prog = trainer.programs(state).programs["train_step"]
    (rec,) = prog.records.values()
    wire = trainer.compact(batch)
    assert rec["memory"]["argument_bytes"] == _nbytes(wire.leaves()[1])
    out_bytes = rec["memory"]["output_bytes"]
    assert 0 < out_bytes < 1024  # the step's metrics: loss, tasks, graphs
    assert 0 < rec["memory"]["peak_bytes"] <= torch.cuda.max_memory_allocated(card)
    assert rec["cost"]["flops"] == float(counter.get_total_flops()) > 0
    assert rec["capture_s"] > 0
    # a forward: its outputs' bytes
    outputs = trainer.eval_step(state, batch)
    (erec,) = trainer.programs(state).programs["eval_step"].records.values()
    assert erec["memory"]["output_bytes"] == _nbytes(
        [t for t in [outputs["loss"], outputs["tasks"], outputs["num_graphs"],
                     *outputs["outputs"]]])


def pytest_step_timer_reads_device_time(card):
    trainer, state, batch = _setup("PNA", card, aggregation="fused", graphs=32, hidden=128)
    trainer.train_step(state, batch)  # the capture

    class Sink:
        def __init__(self):
            self.seen = []

        def on_step_time(self, seconds, count, compile_s):
            self.seen.append(seconds)

    sink = Sink()
    timer = runtime.StepTimer(sink, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark = timer.start()
    trainer.train_step(state, batch)
    timer.stop(mark)
    torch.cuda.synchronize()
    synced = time.perf_counter() - t0
    timer.flush()
    (seconds,) = sink.seen
    assert 0 < seconds <= synced
