"""The port's post-mortem reports, budget ratchet, fleet rollup and obs CLI
(``hydragnn_tpu_torch/obs/report.py``, ``ledger.py``, ``__main__.py``)
against the JAX package's, on the same streams.

- ``build_report`` and its three renderers, byte for byte, over the JAX
  package's own fixtures (``tests/test_xla_introspect.py``'s synthetic
  stream and torn stream) and over a stream with a training run's every
  kind (goodput windows with MFU, compiles, profiles, guard, checkpoints,
  resume, stops, chunks, a canary ladder): a stream without the port's
  ``flops_counter`` manifest field renders as the JAX package's.
- ``budget_from_report`` and ``check_budget`` as the JAX package's; a
  port record without ``bytes_accessed`` leaves that metric absent from
  the budget, never 0.
- ``build_fleet_report`` and its renderers over the JAX package's fleet
  fixture (``tests/test_goodput.py``), byte for byte.
- The CLI (``python -m hydragnn_tpu_torch.obs``) beside the JAX package's
  ``main`` on the same files: ``report`` (a missing stream 2, a budget
  written 0, checked 0, exceeded 1, malformed 2, a vacuous pass over a
  stream without compile events 2), ``fleet`` (0, and 2 on an empty or
  missing directory), ``trace`` and ``drift`` (0 on their streams, 2
  without): the same exit codes and the same standard output.
"""

import json

import numpy as np
import pytest

from hydragnn_tpu.obs import ledger as jax_ledger
from hydragnn_tpu.obs import report as jax_report
from hydragnn_tpu.obs.__main__ import main as jax_main

from hydragnn_tpu_torch.obs import ledger, report
from hydragnn_tpu_torch.obs.__main__ import main as port_main
from hydragnn_tpu_torch.obs.events import RunEventLog

from test_goodput import _fleet_fixture
from test_trace import _synthetic_trace
from test_xla_introspect import _MANIFEST, _synthetic_stream, _write_events

FORMATS = ("text", "markdown", "json")


def _torn_stream(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"event": "epoch", "ts": 1.0, "seq": 0, "epoch": 0, "train_loss": 0.1,
                            "val_loss": 0.1, "test_loss": 0.1, "mode": "stream"}) + "\n")
        f.write('{"event": "epoch", "ts": 2.0, "se')  # torn tail
    return path


def _training_stream(tmp_path):
    """Every kind a training run writes (and a canary ladder), as the
    port's runtime writes them."""
    path = str(tmp_path / "events.jsonl")
    fr = {"compute": 0.4, "data_stall": 0.1, "collective": 0.0, "checkpoint": 0.2,
          "compile": 0.25, "guard_recovery": 0.0, "eval": 0.05, "other": 0.0}
    _write_events(path, [
        _MANIFEST,
        {"event": "staged", "num_batches": 7},
        {"event": "compile", "name": "epoch_scan", "bucket": "epoch_scan/1234abcd",
         "cost": {"flops": 2.5e9}, "memory": {"argument_bytes": 4096.0, "output_bytes": 0.0,
                                              "peak_bytes": 1.5e8}, "capture_s": 0.8},
        {"event": "compile", "name": "eval_epoch", "bucket": "eval_epoch/99aa00ff",
         "cost": {"flops": 8e8}, "memory": {"argument_bytes": 2048.0}, "capture_s": 0.3},
        {"event": "resume", "start_epoch": 1, "lr": 0.001},
        {"event": "profile", "status": "armed", "steps": 2, "trace_dir": "logs/r/profile"},
        {"event": "guard_skip", "scope": "step", "skipped": 1, "streak": 1},
        {"event": "guard_restore", "restores": 1, "lr": 0.0005, "seconds": 0.01},
        {"event": "checkpoint_saved", "name": "r", "kind": "primary", "resumable": True,
         "bytes": 1000, "snapshot_s": 0.01, "write_s": 0.02},
        {"event": "checkpoint_restored", "name": "r", "source": "primary"},
        {"event": "epoch", "epoch": 1, "train_loss": 0.5, "val_loss": 0.6, "test_loss": 0.7,
         "mode": "staged", "wall_time_s": 0.05, "graphs_per_sec": 900.0,
         "nodes_per_sec": 80000.0, "padding_waste": 0.1},
        {"event": "profile", "status": "started", "steps": 2, "trace_dir": "logs/r/profile"},
        {"event": "fit_chunk", "epoch_start": 2, "epochs": 2, "wall_time_s": 0.2},
        {"event": "goodput", "epoch": 1, "wall_s": 0.3, "seconds": {k: 0.3 * v for k, v in
                                                                    fr.items()},
         "fractions": fr, "goodput_fraction": 0.4, "steps": 7, "step_s": 0.1,
         "mfu": {"epoch_scan/1234abcd": {"mfu": 0.0123, "flops": 2.5e9, "steps_per_sec": 70.0,
                                         "peak_flops": 67e12}}},
        {"event": "profile", "status": "done", "trace_dir": "logs/r/profile"},
        {"event": "stall", "step": 9, "seconds": 1.0, "median": 0.1, "factor": 8.0},
        {"event": "candidate_published", "candidate": 3, "checkpoint": "r", "epoch": 1},
        {"event": "early_stop", "epoch": 2},
        {"event": "wallclock_stop", "epoch": 2},
        {"event": "tracer_totals", "regions": {"train": 1.5, "dataload": 0.2}},
        {"event": "run_end", "status": "failed"},
    ])
    return path


STREAMS = {"synthetic": _synthetic_stream, "torn": _torn_stream, "training": _training_stream}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("stream", list(STREAMS))
def pytest_report_renders_as_jax(tmp_path, stream, fmt):
    path = STREAMS[stream](tmp_path)
    got = report.build_report(report.load_events(path))
    want = jax_report.build_report(jax_report.load_events(path))
    assert got == want
    assert report.RENDERERS[fmt](got) == jax_report.RENDERERS[fmt](want)


def pytest_port_manifest_names_its_flop_counter(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _write_events(path, [dict(_MANIFEST, flops_counter="FlopCounterMode: aten only"),
                         {"event": "compile", "name": "train_step", "bucket": "train_step/ab",
                          "cost": {"flops": 10.0}, "memory": {}},
                         {"event": "run_end", "status": "complete"}])
    got = report.build_report(report.load_events(path))
    assert got["run"]["flops_counter"] == "FlopCounterMode: aten only"
    text, md = report.render_text(got), report.render_markdown(got)
    assert "flops: FlopCounterMode: aten only" in text
    assert "-- captured programs (FlopCounterMode FLOPs, allocator bytes) --" in text
    assert "## Captured programs (FlopCounterMode FLOPs, allocator bytes)" in md
    want = jax_report.build_report(jax_report.load_events(path))
    # the JAX package reads the same stream, without the port's two lines
    assert {k: v for k, v in got["run"].items() if k != "flops_counter"} == want["run"]


@pytest.mark.parametrize("stream", ["synthetic", "training"])
def pytest_budget_and_check_as_jax(tmp_path, stream):
    path = STREAMS[stream](tmp_path)
    got = report.build_report(report.load_events(path))
    want = jax_report.build_report(jax_report.load_events(path))
    budget = report.budget_from_report(got, tolerance=0.1)
    assert budget == jax_report.budget_from_report(want, tolerance=0.1)
    tight = json.loads(json.dumps(budget))
    for entry in tight["programs"].values():
        entry["flops"] = entry["flops"] / 2.0
        if "mfu_floor" in entry:
            entry["mfu_floor"] *= 4.0
    assert report.check_budget(got, tight) == jax_report.check_budget(want, tight)
    assert report.check_budget(got, tight)[0]  # over budget
    if stream == "training":  # the port's records: no bytes_accessed, so none budgeted
        entry = budget["programs"]["epoch_scan/1234abcd"]
        assert "bytes_accessed" not in entry and entry["mfu_floor"] == 0.0123


@pytest.mark.parametrize("fmt", FORMATS)
def pytest_fleet_rollup_as_jax(tmp_path, fmt):
    _fleet_fixture(str(tmp_path))
    got = ledger.build_fleet_report(str(tmp_path), straggler_factor=2.0)
    want = jax_ledger.build_fleet_report(str(tmp_path), straggler_factor=2.0)
    assert got == want and got["stragglers"] == ["0"]
    assert ledger.FLEET_RENDERERS[fmt](got) == jax_ledger.FLEET_RENDERERS[fmt](want)


def _both(capsys, args):
    """``(port exit code, JAX exit code)``, their standard outputs and
    their standard errors equal."""
    rc = port_main(args)
    out, err = capsys.readouterr()
    jrc = jax_main(args)
    assert capsys.readouterr() == (out, err), args
    _both.err = err
    return rc, jrc


def pytest_report_cli_exit_codes_as_jax(tmp_path, capsys):
    path = _synthetic_stream(tmp_path)
    budget = str(tmp_path / "budget.json")
    assert _both(capsys, ["report", str(tmp_path / "nope")]) == (2, 2)
    for fmt in FORMATS:
        assert _both(capsys, ["report", path, "--format", fmt]) == (0, 0)
    assert _both(capsys, ["report", path, "--write-budget", budget]) == (0, 0)
    assert _both(capsys, ["report", path, "--check-budget", budget]) == (0, 0)
    over = json.load(open(budget))
    over["programs"]["train_step/aaaa1111"]["peak_bytes"] = 100.0
    json.dump(over, open(budget, "w"))
    assert _both(capsys, ["report", path, "--check-budget", budget]) == (1, 1)
    json.dump({"not": "a budget"}, open(budget, "w"))
    assert _both(capsys, ["report", path, "--check-budget", budget]) == (2, 2)
    # a stream without compile events cannot pass a non-empty budget
    bare = str(tmp_path / "bare.jsonl")
    _write_events(bare, [_MANIFEST, {"event": "run_end", "status": "complete"}])
    json.dump({"version": 1, "tolerance": 0.1,
               "programs": {"train_step/aaaa1111": {"flops": 1.0}}}, open(budget, "w"))
    assert _both(capsys, ["report", bare, "--check-budget", budget]) == (2, 2)
    assert "no compile events" in _both.err


def pytest_fleet_trace_drift_cli_as_jax(tmp_path, capsys):
    from hydragnn_tpu.obs.drift import DriftDetector

    fleet = tmp_path / "fleet"
    _fleet_fixture(str(fleet))
    assert _both(capsys, ["fleet", str(fleet)]) == (0, 0)
    assert _both(capsys, ["fleet", str(fleet), "--format", "json"]) == (0, 0)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _both(capsys, ["fleet", str(empty)]) == (2, 2)
    assert _both(capsys, ["fleet", str(tmp_path / "missing")]) == (2, 2)

    spans = tmp_path / "spans"
    log = RunEventLog(str(spans / "events.jsonl"))
    for rec in _synthetic_trace():
        log.emit("span", **{k: v for k, v in rec.items() if k != "event"})
    log.close()
    assert _both(capsys, ["trace", str(spans)]) == (0, 0)
    assert _both(capsys, ["trace", str(spans), "--format", "json", "--slow", "1"]) == (0, 0)
    assert _both(capsys, ["trace", str(empty)]) == (2, 2)

    drift = tmp_path / "drift"
    log = RunEventLog(str(drift / "events.jsonl"))
    det = DriftDetector(str(drift), window=32, raise_after=1, emit=log.emit)
    det.on_activate(1)
    base = np.random.default_rng(43).normal(0.0, 1.0, 32)
    for vals in (base, base + 9.0):  # a reference window, then one that raises
        for v in vals:
            det.observe("acme", heads=[np.asarray([v])], uncertainty=[abs(float(v)) * 0.01])
    log.close()
    assert _both(capsys, ["drift", str(drift)]) == (0, 0)
    assert _both(capsys, ["drift", str(drift), "--format", "json"]) == (0, 0)
    assert _both(capsys, ["drift", str(empty)]) == (2, 2)
    # no subcommand: the usage (under each package's own name), exit 2
    assert port_main([]) == jax_main([]) == 2
    assert "python -m hydragnn_tpu_torch.obs" in capsys.readouterr().err
