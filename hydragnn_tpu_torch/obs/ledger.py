"""Goodput & MFU ledger: where every second of a training run's wall clock
went (port of ``obs/ledger.py``).

- :class:`GoodputLedger`: per-epoch wall-time attribution. Every window
  (``epoch_start`` .. next ``epoch_start`` or the run's end) is split into
  :data:`CATEGORIES` from signals the run already has: the step times
  (``RunTelemetry.on_step_time``: on the card each dispatch's device
  time, from a pair of CUDA events), the compile signal (the programs'
  captures, the kernels' first-launch ``nvcc`` builds included,
  ``obs/runtime.note_compile``), the
  checkpoints' ``snapshot_s``/``write_s``, the data waits, the divergence
  guard's restore time and the epoch driver's eval spans. One
  ``goodput`` event per epoch and
  ``hydragnn_train_goodput_fraction{category=...}`` gauges whose fractions
  sum to 1 by construction.
- **MFU**: ``hydragnn_train_mfu{bucket=...}`` = ``flops_per_step x
  steps_per_sec / peak_flops``: ``flops_per_step`` from the introspection
  record of a training program (``FlopCounterMode`` over its capture's
  warm-up: the dense products; the hand-written kernels are not counted,
  ``obs/introspect.py``), ``steps_per_sec`` over the window's compile-free
  step time, ``peak_flops`` from the device table below at the run's
  precision (``HYDRAGNN_PEAK_FLOPS`` overrides; an unknown device warns
  once and has no MFU).
- **Fleet rollup**: ``python -m hydragnn_tpu_torch.obs fleet <dir>``
  merges the per-host event streams and the heartbeat leases' step-time
  digests under a directory into one cross-host view (pure file reading:
  it reads the JAX package's elastic layout too), flags stragglers and
  prices ``world_resize`` recovery as lost goodput.

Everything here is advisory accounting: no path may raise into the
training loop, and a category the run has no signal for reads 0.
"""

import glob
import json
import math
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

# wall-time categories, in exposition order. "other" is the residual —
# host-side bookkeeping, logging, loader setup — so fractions always sum
# to 1 regardless of which signals a run actually has.
CATEGORIES = (
    "compute",
    "data_stall",
    "collective",
    "checkpoint",
    "compile",
    "guard_recovery",
    "eval",
    "other",
)

# peak dense FLOP/s per card by torch.cuda.get_device_name() and precision:
# NVIDIA H100 SXM data sheet, bf16 on the tensor cores without sparsity and
# f32 outside them (the port runs f32 with TF32 off). The live gauge and
# benchmarks/model_bench.py read this one table, so that their MFU cannot
# drift apart.
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12},
}

# the programs whose buckets count as training compute for MFU (the
# trainer's, train/steps.py): eval and predict buckets also carry FLOPs
# gauges but run at another cadence. The chunk's fit_head and fit_tail run
# no step (bookkeeping between them); its steps are epoch_scan replays.
TRAIN_PROGRAMS = frozenset({"train_step", "train_multi", "epoch_scan"})

_peak_warned: set = set()

# the run's resolved compute precision (models/create.resolve_precision;
# the trainer records it when it resolves it)
_precision = {"mixed": False, "source": "default"}
# the kind of the run's device (note_device; None: the first card's name,
# or "cpu" without one)
_device_kind = {"kind": None}


def note_device(device):
    """The run's device: its name keys :data:`PEAK_FLOPS`."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        _device_kind["kind"] = torch.cuda.get_device_name(device)
    else:
        _device_kind["kind"] = device.type


def current_device_kind() -> str:
    kind = _device_kind["kind"]
    if kind is None:
        import torch

        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return kind


def note_precision(mixed: bool, source: str = "explicit"):
    """The training steps resolved the run's compute precision — recorded so
    the MFU denominator picks the matching peak column."""
    _precision["mixed"] = bool(mixed)
    _precision["source"] = str(source)


def current_precision() -> Dict:
    return dict(_precision)


def resolve_peak_flops(
    device_kind: Optional[str] = None, mixed: Optional[bool] = None
) -> Optional[float]:
    """Peak FLOP/s for MFU: ``HYDRAGNN_PEAK_FLOPS`` (absolute FLOP/s,
    operator override — also the only way to get an MFU on the CPU or an
    unknown card) > the :data:`PEAK_FLOPS` row of this device kind at the
    run's precision. Unknown kinds warn ONCE per kind and return None —
    an absent MFU is better than one against an invented denominator."""
    env = os.getenv("HYDRAGNN_PEAK_FLOPS")
    if env is not None and env.strip() != "":
        try:
            return float(env)
        except ValueError:
            if "env" not in _peak_warned:
                _peak_warned.add("env")
                warnings.warn(
                    f"HYDRAGNN_PEAK_FLOPS={env!r} is not a number — "
                    "ignored",
                    stacklevel=2,
                )
    if device_kind is None:
        try:
            device_kind = current_device_kind()
        except Exception:
            return None
    row = PEAK_FLOPS.get(device_kind)
    if row is None:
        if device_kind not in _peak_warned:
            _peak_warned.add(device_kind)
            warnings.warn(
                f"no peak-FLOPs entry for device kind {device_kind!r} — "
                "MFU unavailable (set HYDRAGNN_PEAK_FLOPS to override)",
                stacklevel=2,
            )
        return None
    if mixed is None:
        mixed = _precision["mixed"]
    return row["bf16"] if mixed else row["f32"]


class GoodputLedger:
    """Per-epoch wall-time attribution for one telemetry run.

    Owned by ``RunTelemetry``; every mutator is cheap (a lock + float
    adds) and tolerant of being called from the checkpoint writer thread.
    Windows open at ``epoch_begin`` and close at the NEXT ``epoch_begin``
    (or ``finalize``), so post-epoch work — the resumable checkpoint save,
    scalar flushes — lands in the epoch that caused it."""

    def __init__(
        self,
        registry=None,
        emit: Optional[Callable] = None,
        compile_seconds: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self._registry = registry
        self._emit = emit or (lambda *a, **k: None)
        self._compile_seconds = compile_seconds or (lambda: 0.0)
        self._clock = clock
        # reentrant: _reset_window guards its own writes while its only
        # caller (epoch_begin) already holds the lock
        self._lock = threading.RLock()
        # per-bucket flops + per-step collective bytes of captured TRAIN
        # programs (record_compile forwards every capture here;
        # run-scoped, unlike introspect.captured() which is
        # process-global)
        self._train_flops: Dict[str, float] = {}
        self._train_coll_bytes: Dict[str, float] = {}
        self._open = False
        self._epoch = 0

    # ---- window lifecycle ----------------------------------------------
    def _reset_window(self):
        with self._lock:
            self._t_open = self._clock()
            self._compile_at_open = self._compile_seconds()
            self._steps = 0
            self._step_s = 0.0
            self._compile_in_step_s = 0.0
            self._data_stall_s = 0.0
            self._checkpoint_s = 0.0
            self._guard_s = 0.0
            self._eval_s = 0.0
            self._compile_in_eval_s = 0.0
            self._train_wall_s = 0.0
            # open eval span bookkeeping (eval compile/data-wait time must
            # not double-count against the eval category)
            self._eval_t0 = None
            self._eval_compile_at = 0.0
            self._eval_stall_at = 0.0

    def epoch_begin(self, epoch: int):
        with self._lock:
            payload = self._close_window_locked() if self._open else None
            self._reset_window()
            self._open = True
            self._epoch = int(epoch)
        if payload is not None:
            self._publish(payload)

    def finalize(self):
        """Run teardown: close (and publish) the last open window."""
        with self._lock:
            payload = self._close_window_locked() if self._open else None
            self._open = False
        if payload is not None:
            self._publish(payload)

    # ---- recording hooks -----------------------------------------------
    def on_step(self, seconds: float, count: int = 1,
                compile_s: float = 0.0):
        """One train-step dispatch: ``compile_s`` is the backend-compile
        time that landed INSIDE this dispatch (0 for warm steps)."""
        with self._lock:
            if not self._open:
                return
            self._steps += int(count)
            self._step_s += float(seconds)
            self._compile_in_step_s += min(
                max(float(compile_s), 0.0), float(seconds)
            )

    def note_program(self, rec: Dict):
        """A compile capture landed (obs/introspect.py via
        ``record_compile``): remember train-program FLOPs (MFU) and
        per-step collective bytes (the collective-time estimate)."""
        if rec.get("name") not in TRAIN_PROGRAMS:
            return
        cost = rec.get("cost") or {}
        coll = rec.get("collectives") or {}
        with self._lock:
            if cost.get("flops"):
                self._train_flops[rec["bucket"]] = float(cost["flops"])
            if coll:
                self._train_coll_bytes[rec["bucket"]] = float(
                    sum(coll.values())
                )

    def data_wait(self, seconds: float):
        """The consumer waited on the data plane (host-side collate /
        H2D transfer / stream pipeline)."""
        with self._lock:
            if self._open:
                self._data_stall_s += max(float(seconds), 0.0)

    def checkpoint_cost(self, seconds: float):
        with self._lock:
            if self._open:
                self._checkpoint_s += max(float(seconds), 0.0)

    def guard_cost(self, seconds: float):
        with self._lock:
            if self._open:
                self._guard_s += max(float(seconds), 0.0)

    def _collective_estimate(self) -> float:
        """Estimated collective seconds for this window: per-step
        collective bytes (a record's ``collectives``) x steps / the
        operator-declared interconnect bandwidth
        ``HYDRAGNN_ICI_BYTES_PER_S``. 0 without that knob, and 0 on one
        card: the port's records carry no collectives until parallelism is
        ported (``ROADMAP.md``, queue 1, item 8)."""
        if not self._steps or not self._train_coll_bytes:
            return 0.0
        bw = os.getenv("HYDRAGNN_ICI_BYTES_PER_S")
        if not bw:
            return 0.0
        try:
            bw = float(bw)
        except ValueError:
            return 0.0
        if bw <= 0:
            return 0.0
        # the busiest train bucket bounds the estimate (one step runs one
        # bucket; which one each step ran is not tracked)
        return self._steps * max(self._train_coll_bytes.values()) / bw

    def note_train_wall(self, seconds: float):
        """The epoch driver's measured training wall (the whole-dispatch
        staged/fit paths have no per-step hook; this is their compute
        signal)."""
        with self._lock:
            if self._open and seconds is not None:
                self._train_wall_s += max(float(seconds), 0.0)

    def eval_begin(self):
        with self._lock:
            if not self._open:
                return
            self._eval_t0 = time.perf_counter()
            self._eval_compile_at = self._compile_seconds()
            self._eval_stall_at = self._data_stall_s

    def eval_end(self):
        """Close an eval span: the span's compile time and data waits stay
        in THEIR categories; only the remainder is eval."""
        with self._lock:
            if not self._open or self._eval_t0 is None:
                return
            wall = time.perf_counter() - self._eval_t0
            compile_in_eval = max(
                self._compile_seconds() - self._eval_compile_at, 0.0
            )
            stall_in_eval = max(
                self._data_stall_s - self._eval_stall_at, 0.0
            )
            self._eval_t0 = None
            self._eval_s += max(wall - compile_in_eval - stall_in_eval, 0.0)
            # remembered so the staged-path compute deduction below can
            # exclude it — eval compile must not be subtracted from the
            # TRAIN wall as well
            self._compile_in_eval_s += compile_in_eval

    # ---- window close ---------------------------------------------------
    def _close_window_locked(self) -> Optional[Dict]:
        """Fold the window's accumulators into the goodput payload
        (returned for publication OUTSIDE the lock). None when the window
        saw no attributable time at all (e.g. a predict-only run)."""
        wall = max(self._clock() - self._t_open, 0.0)
        compile_s = max(self._compile_seconds() - self._compile_at_open, 0.0)
        collective_s = self._collective_estimate()
        if self._steps:
            # streaming path: compute is the compile-free step dispatch
            compute_s = max(self._step_s - self._compile_in_step_s, 0.0)
        else:
            # whole-dispatch paths (staged epochs / fit chunks): the
            # driver's measured train wall IS device compute, minus the
            # window's TRAIN-side compile share (compile that happened
            # inside an eval span was already kept out of eval and must
            # not be deducted from the train wall too)
            compute_s = max(
                self._train_wall_s
                - max(compile_s - self._compile_in_eval_s, 0.0),
                0.0,
            )
        compute_s = max(compute_s - collective_s, 0.0)
        seconds = {
            "compute": compute_s,
            "data_stall": self._data_stall_s,
            "collective": collective_s,
            "checkpoint": self._checkpoint_s,
            "compile": compile_s,
            "guard_recovery": self._guard_s,
            "eval": self._eval_s,
        }
        known = sum(seconds.values())
        if known <= 0.0 and wall <= 0.0:
            return None
        seconds["other"] = max(wall - known, 0.0)
        denom = known + seconds["other"]  # == max(wall, known)
        fractions = {
            k: (seconds[k] / denom if denom > 0 else 0.0)
            for k in CATEGORIES
        }
        payload = {
            "epoch": self._epoch,
            "wall_s": round(wall, 6),
            "seconds": {k: round(v, 6) for k, v in seconds.items()},
            "fractions": fractions,
            "goodput_fraction": fractions["compute"],
            "steps": self._steps,
            "step_s": round(self._step_s, 6),
        }
        if collective_s > 0:
            # bandwidth-model figure, not a measurement — labeled so a
            # reader never mistakes it for one
            payload["collective_estimated"] = True
        mfu = self._mfu_locked()
        if mfu:
            payload["mfu"] = mfu
        return payload

    def _mfu_locked(self) -> Dict[str, Dict]:
        """Per-bucket MFU over this window's compile-free step time.

        Which bucket each step ran is not tracked, so ``steps_per_sec``
        is the window's BLENDED rate across all train buckets; with more
        than one bucket in play each entry carries ``rate: "blended"``
        (a mix shift moves the figure as much as a perf change — the
        budget-floor docs call this out)."""
        basis_s = self._step_s - self._compile_in_step_s
        if not self._train_flops or self._steps <= 0 or basis_s <= 0.0:
            return {}
        peak = resolve_peak_flops()
        if not peak:
            return {}
        steps_per_sec = self._steps / basis_s
        blended = len(self._train_flops) > 1
        out = {}
        for bucket, flops in sorted(self._train_flops.items()):
            out[bucket] = {
                "mfu": flops * steps_per_sec / peak,
                "flops": flops,
                "steps_per_sec": steps_per_sec,
                "peak_flops": peak,
                **({"rate": "blended"} if blended else {}),
            }
        return out

    def _publish(self, payload: Dict):
        try:
            self._emit("goodput", **payload)
            if self._registry is not None:
                for cat, frac in payload["fractions"].items():
                    self._registry.set_labeled(
                        "goodput_fraction", frac, category=cat
                    )
                for bucket, m in (payload.get("mfu") or {}).items():
                    self._registry.set_labeled(
                        "mfu", m["mfu"], bucket=bucket
                    )
        except Exception:
            pass  # accounting must never kill the run


# ---- fleet rollup ----------------------------------------------------------


def _median(values: List[float]) -> float:
    import statistics

    return float(statistics.median(values))


def flag_stragglers(
    per_host: Dict[str, Dict],
    factor: float = 2.0,
    min_steps: int = 3,
) -> List[str]:
    """Hosts whose step-time p50 exceeds ``factor`` x the leave-one-out
    median of the other qualified hosts' p50s. Leave-one-out (not the
    whole-fleet median) so a 2-host fleet can still flag its slow half;
    hosts with fewer than ``min_steps`` recorded steps neither flag nor
    count toward anyone's baseline (their p50 is noise)."""
    qualified = {
        h: s["p50"]
        for h, s in per_host.items()
        if s.get("p50") is not None and s.get("count", 0) >= min_steps
    }
    if len(qualified) < 2:
        return []
    flagged = []
    for host, p50 in qualified.items():
        others = [v for h, v in qualified.items() if h != host]
        baseline = _median(others)
        if baseline > 0 and p50 > factor * baseline:
            flagged.append(host)
    return sorted(flagged)


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def discover_fleet(root: str):
    """(event stream paths, worker lease paths) under a run/coordination
    directory — accepts the elastic smoke layout (``<dir>/logs/<run>/
    events*.jsonl`` + ``<dir>/elastic-coord/workers/host-*.json``), a bare
    run dir, or a coordination dir itself."""
    # '**' matches zero directories too, so one recursive glob per
    # pattern covers both the root-level and nested layouts
    streams = sorted(
        glob.glob(os.path.join(root, "**", "events*.jsonl"), recursive=True)
    )
    leases = sorted(
        glob.glob(os.path.join(root, "**", "workers", "host-*.json"),
                  recursive=True)
    )
    return streams, leases


def _host_of_stream(path: str) -> Optional[str]:
    """``events-host3.jsonl`` -> "3"; the shared ``events.jsonl`` has no
    fixed host (ranks 0 of successive generations append to it) — per-
    record attribution walks the manifests instead."""
    base = os.path.basename(path)
    if base.startswith("events-host") and base.endswith(".jsonl"):
        return base[len("events-host"):-len(".jsonl")]
    return None


def build_fleet_report(
    root: str,
    straggler_factor: float = 2.0,
    min_steps: int = 3,
) -> Dict:
    """Merge an elastic run's per-host observability into one report:
    cross-host timeline, per-host step-time distributions, straggler
    flags, and ``world_resize`` recovery priced as lost goodput."""
    from hydragnn_tpu_torch.obs.report import load_events

    stream_paths, lease_paths = discover_fleet(root)
    records = []
    for path in stream_paths:
        fixed_host = _host_of_stream(path)
        host = fixed_host
        for rec in load_events(path):
            if rec.get("event") == "run_manifest" and fixed_host is None:
                # rank 0's stream: successive generations' rank 0 may be
                # different hosts — the manifest marks each segment
                host = str(rec.get("host", rec.get("run", "rank0")))
            rec = dict(rec)
            rec["_host"] = host if host is not None else "rank0"
            rec["_stream"] = os.path.basename(path)
            records.append(rec)
    records.sort(key=lambda r: (r.get("ts") or 0.0, r.get("seq") or 0))

    # per-host step stats from BOTH sources, then keep whichever saw more
    # steps per host: the heartbeat digest carries real quantiles but can
    # be stale for a host that died between its last lease write and its
    # final steps (a hard kill skips the flush), while the per-host
    # goodput events record every completed epoch's step count/time (mean
    # only) as they happen.
    leases: Dict[str, Dict] = {}
    for path in lease_paths:
        lease = _read_json(path)
        if not lease:
            continue
        host = str(lease.get("host", os.path.basename(path)))
        digest = lease.get("step_digest") or {}
        entry = {
            "count": int(digest.get("count", 0)),
            "p50": digest.get("p50"),
            "p99": digest.get("p99"),
            "sum": digest.get("sum"),
            "step": lease.get("step"),
            "epoch": lease.get("epoch"),
            "done": bool(lease.get("done")),
            "source": "heartbeat",
        }
        if entry["count"] and entry.get("sum") is not None:
            entry["mean"] = float(entry["sum"]) / entry["count"]
        leases[host] = entry
    from_events: Dict[str, Dict] = {}
    for rec in records:
        if rec.get("event") != "goodput":
            continue
        host = rec["_host"]
        steps = rec.get("steps") or 0
        step_s = rec.get("step_s") or 0.0
        if not steps:
            continue
        if (rec.get("seconds") or {}).get("compile"):
            # warmup/recompile windows: their step time is compile, not
            # pace — including them would read every freshly (re)spawned
            # host as a straggler
            continue
        entry = from_events.setdefault(
            host, {"count": 0, "sum": 0.0, "p50": None, "source": "events"}
        )
        entry["count"] += int(steps)
        entry["sum"] = float(entry.get("sum") or 0.0) + float(step_s)
        entry["mean"] = entry["sum"] / max(entry["count"], 1)
        entry["p50"] = entry["mean"]  # events carry no quantiles
    per_host: Dict[str, Dict] = {}
    for host in set(leases) | set(from_events):
        lease = leases.get(host)
        ev = from_events.get(host)
        best = max(
            (e for e in (lease, ev) if e is not None),
            key=lambda e: e.get("count", 0),
        )
        if lease is not None and best is not lease:
            # keep the lease's liveness fields on the events-derived stats
            best = {**best, "step": lease.get("step"),
                    "epoch": lease.get("epoch"),
                    "done": lease.get("done", False)}
        per_host[host] = best

    stragglers = flag_stragglers(
        per_host, factor=straggler_factor, min_steps=min_steps
    )

    ts = [r["ts"] for r in records
          if isinstance(r.get("ts"), (int, float))]
    wall = (ts[-1] - ts[0]) if len(ts) > 1 else 0.0
    resizes = []
    lost_s = 0.0
    lost_host_s = 0.0
    for rec in records:
        if rec.get("event") != "world_resize":
            continue
        recovery = float(rec.get("recovery_s") or 0.0)
        lost_s += recovery
        lost_host_s += recovery * int(rec.get("new_world") or 1)
        resizes.append(
            {
                "gen": rec.get("gen"),
                "old_world": rec.get("old_world"),
                "new_world": rec.get("new_world"),
                "recovery_s": recovery,
                "t": round(float(rec.get("ts", 0.0)) - (ts[0] if ts else 0.0), 3),
            }
        )

    goodputs = [
        r.get("goodput_fraction")
        for r in records
        if r.get("event") == "goodput"
        and isinstance(r.get("goodput_fraction"), (int, float))
    ]

    timeline = [
        {
            "t": round(float(r.get("ts", 0.0)) - (ts[0] if ts else 0.0), 3),
            "host": r["_host"],
            "event": r["event"],
            "stream": r["_stream"],
        }
        for r in records
        if r.get("event")
        in ("run_manifest", "host_lost", "world_resize", "stall",
            "guard_restore", "checkpoint_restored", "resume", "run_end",
            "early_stop", "wallclock_stop", "drift_alert")
    ]

    # model-quality rollup: merge drift/sink events from every stream
    # (old streams carry none — the section stays None and renderers
    # omit it, so pre-observatory fleets keep rendering unchanged)
    quality = None
    from hydragnn_tpu_torch.obs.drift import QUALITY_EVENTS, build_drift_report

    quality_records = [
        r for r in records if r.get("event") in QUALITY_EVENTS
    ]
    if quality_records:
        quality = build_drift_report(quality_records)

    return {
        "root": root,
        "streams": [os.path.basename(p) for p in stream_paths],
        "hosts": per_host,
        "stragglers": stragglers,
        "straggler_factor": straggler_factor,
        "events": len(records),
        "wall_s": round(wall, 3),
        "resizes": resizes,
        "lost_goodput_s": round(lost_s, 3),
        "lost_goodput_host_s": round(lost_host_s, 3),
        "lost_goodput_fraction": (
            round(lost_s / wall, 6) if wall > 0 else 0.0
        ),
        "mean_goodput_fraction": (
            round(sum(goodputs) / len(goodputs), 6) if goodputs else None
        ),
        "quality": quality,
        "timeline": timeline,
    }


def _fmt_s(v) -> str:
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-"
    return f"{float(v):.6g}"


def render_fleet_text(report: Dict) -> str:
    lines = [
        "== fleet rollup ==",
        f"root: {report['root']}",
        f"streams: {', '.join(report['streams']) or '(none)'}",
        f"events: {report['events']}  wall: {report['wall_s']}s  "
        f"mean goodput: {_fmt_s(report['mean_goodput_fraction'])}",
        f"resizes: {len(report['resizes'])}  lost goodput: "
        f"{report['lost_goodput_s']}s wall "
        f"({report['lost_goodput_host_s']}s host-seconds, "
        f"{report['lost_goodput_fraction']:.2%} of fleet wall)",
        "",
        "-- hosts (step-time digests) --",
    ]
    for host in sorted(report["hosts"]):
        s = report["hosts"][host]
        tag = " STRAGGLER" if host in report["stragglers"] else ""
        done = " done" if s.get("done") else ""
        lines.append(
            f"host {host}: steps={s.get('count', 0)} "
            f"p50={_fmt_s(s.get('p50'))}s p99={_fmt_s(s.get('p99'))}s "
            f"mean={_fmt_s(s.get('mean'))}s "
            f"[{s.get('source', '?')}]{done}{tag}"
        )
    if report["stragglers"]:
        lines.append(
            f"stragglers (p50 > {report['straggler_factor']}x fleet "
            f"median): {', '.join(report['stragglers'])}"
        )
    else:
        lines.append("stragglers: none")
    if report["resizes"]:
        lines += ["", "-- world resizes --"]
        for r in report["resizes"]:
            lines.append(
                f"{r['t']:>10.3f}s  gen {r['gen']}: {r['old_world']} -> "
                f"{r['new_world']} hosts, recovery {r['recovery_s']}s"
            )
    q = report.get("quality")
    if q:
        lines += ["", "-- model quality (fleet-merged drift events) --"]
        lines.append(
            f"windows: {q.get('windows', 0)}  alert events: "
            f"{len(q.get('alerts') or [])}  active: "
            f"{len(q.get('alerts_active') or [])}"
        )
        for key in q.get("alerts_active") or []:
            lines.append(f"ACTIVE ALERT: {key}")
        sink = q.get("sink")
        if sink:
            lines.append(
                f"feedback sink: accepted={sink.get('accepted')} "
                f"deduped={sink.get('deduped')} "
                f"graphs={sink.get('graphs')} packs={sink.get('packs')}"
            )
    if report["timeline"]:
        lines += ["", "-- cross-host timeline (s after first event) --"]
        for item in report["timeline"]:
            lines.append(
                f"{item['t']:>10.3f}  host {item['host']:<8} "
                f"{item['event']:<20} [{item['stream']}]"
            )
    return "\n".join(lines) + "\n"


def render_fleet_markdown(report: Dict) -> str:
    lines = [
        f"# Fleet rollup: {report['root']}",
        "",
        f"streams: {', '.join(report['streams']) or '(none)'}  ",
        f"events: {report['events']}  wall: {report['wall_s']}s  "
        f"mean goodput: {_fmt_s(report['mean_goodput_fraction'])}  ",
        f"lost goodput: {report['lost_goodput_s']}s wall / "
        f"{report['lost_goodput_host_s']}s host-seconds "
        f"({report['lost_goodput_fraction']:.2%})",
        "",
        "## Hosts",
        "",
        "| host | steps | p50 (s) | p99 (s) | mean (s) | source | straggler |",
        "| --- | --- | --- | --- | --- | --- | --- |",
    ]
    for host in sorted(report["hosts"]):
        s = report["hosts"][host]
        lines.append(
            f"| {host} | {s.get('count', 0)} | {_fmt_s(s.get('p50'))} | "
            f"{_fmt_s(s.get('p99'))} | {_fmt_s(s.get('mean'))} | "
            f"{s.get('source', '?')} | "
            f"{'YES' if host in report['stragglers'] else ''} |"
        )
    if report["resizes"]:
        lines += ["", "## World resizes", ""]
        for r in report["resizes"]:
            lines.append(
                f"- t={r['t']}s gen {r['gen']}: {r['old_world']} -> "
                f"{r['new_world']} hosts, recovery {r['recovery_s']}s"
            )
    q = report.get("quality")
    if q:
        lines += ["", "## Model quality (fleet-merged drift events)", ""]
        lines.append(
            f"windows: {q.get('windows', 0)}  alert events: "
            f"{len(q.get('alerts') or [])}  active: "
            f"{len(q.get('alerts_active') or [])}  "
        )
        for key in q.get("alerts_active") or []:
            lines.append(f"- ACTIVE ALERT: `{key}`")
    return "\n".join(lines) + "\n"


def render_fleet_json(report: Dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


FLEET_RENDERERS = {
    "text": render_fleet_text,
    "markdown": render_fleet_markdown,
    "json": render_fleet_json,
}


def poll_fleet_gauges(
    coord_dir: str,
    registry,
    straggler_factor: float = 2.0,
    min_steps: int = 3,
    stale_s: Optional[float] = None,
    now: Optional[float] = None,
):
    """Scrape-time fleet poll on the leader: read every LIVE worker
    lease's step-time digest into ``fleet_step_p50_seconds{host=...}``
    and count stragglers into ``fleet_straggler_hosts``. Lease files are
    never deleted, so liveness is judged the same way the elastic
    watchdog judges it: ``done=True`` (clean finish), a tombstone under
    ``dead/``, or a lease older than ``stale_s`` (default 4x
    HYDRAGNN_ELASTIC_LEASE_S, floor 30 s — well past detection, so a
    merely-slow host still shows) all drop the host from the live view;
    without this a dead straggler would pin ``fleet_straggler_hosts``
    >= 1 forever AFTER the resize that healed it. One readdir + one
    small JSON read per host, at scrape cadence only — never in the
    step loop."""
    try:
        if stale_s is None:
            try:
                lease = float(os.getenv("HYDRAGNN_ELASTIC_LEASE_S", "6.0"))
            except ValueError:
                lease = 6.0
            stale_s = max(lease * 4.0, 30.0)
        now = time.time() if now is None else now
        per_host: Dict[str, Dict] = {}
        # membership is a LIVE view: a host that died/finished since the
        # last scrape must drop out of the exposition, not freeze
        registry.clear_labeled("fleet_step_p50_seconds")
        for path in sorted(
            glob.glob(os.path.join(coord_dir, "workers", "host-*.json"))
        ):
            lease = _read_json(path)
            if not lease or lease.get("done"):
                continue
            host = str(lease.get("host", os.path.basename(path)))
            ts = lease.get("ts")
            if ts is not None and now - float(ts) > stale_s:
                continue
            if _read_json(
                os.path.join(coord_dir, "dead", f"host-{host}.json")
            ) is not None:
                continue
            digest = lease.get("step_digest") or {}
            if digest.get("p50") is not None:
                registry.set_labeled(
                    "fleet_step_p50_seconds",
                    float(digest["p50"]),
                    host=host,
                )
            per_host[host] = {
                "p50": digest.get("p50"),
                "count": digest.get("count", 0),
            }
        registry.set(
            "fleet_straggler_hosts",
            float(
                len(
                    flag_stragglers(
                        per_host, factor=straggler_factor,
                        min_steps=min_steps,
                    )
                )
            ),
        )
    except Exception:
        pass  # a flaky shared FS must not break /metrics
