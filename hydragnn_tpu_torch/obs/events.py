"""Structured run events: one append-only JSONL stream (a copy of the JAX
package's ``obs/events.py``, which the port does not import).

Every line is one JSON object with a fixed envelope::

    {"event": <type>, "ts": <unix seconds>, "seq": <per-stream monotonic int>, ...}

plus the payload fields of the event's type in :data:`EVENT_FIELDS`. The
port keeps the schema of the kinds it emits: a training run's (the run
manifest, epochs, chunks, checkpoints, the guard, compiles, stalls,
profiles, goodput; ``obs/runtime.py``), ``span`` (request tracing,
``obs/trace.py``), ``quota_adjusted`` (the cost ledger's feedback,
``serve/costs.py``), ``tenant_cost``, ``cache_stats``, and the serving
fleet's (``serve/fleet.py``, ``router.py``, ``canary.py``,
``autoscale.py``, ``obs/drift.py``); the JAX package's ``validate_events``
reads the streams the port writes, and the port's reads the JAX package's.
Unknown event types are allowed (a newer writer must not break an older
validator); a known type missing a required field is a schema violation.

Lines are written strictly (a non-finite float becomes ``null``), a torn
last line is cut off before appending, and ``seq`` carries on across
appends to the same file.
"""

import json
import math
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

SCHEMA_VERSION = 1

# event type -> required payload fields (on top of the envelope)
EVENT_FIELDS: Dict[str, tuple] = {
    "run_manifest": (
        "schema_version", "run", "config_hash", "git_rev", "world_size",
        "device_kind", "device_count", "num_epoch",
    ),
    # ---- a training run (obs/runtime.py and the train/ modules) ----
    "epoch": (
        "epoch", "train_loss", "val_loss", "test_loss", "mode",
    ),
    "fit_chunk": ("epoch_start", "epochs", "wall_time_s"),
    "staged": ("num_batches",),
    "checkpoint_saved": ("name", "kind"),
    "checkpoint_restored": ("name", "source"),
    "guard_skip": ("scope", "skipped"),
    "guard_restore": ("restores", "lr"),
    "resume": ("start_epoch",),
    "early_stop": ("epoch",),
    "wallclock_stop": ("epoch",),
    "tracer_totals": ("regions",),
    "run_end": ("status",),
    # introspection (obs/introspect.py): one per novel (captured program,
    # shape key); cost holds the FlopCounterMode FLOPs of the capture's
    # eager warm-up (aten operations only: the hand-written kernels, reached
    # through ctypes, are not counted), memory the argument, output and
    # peak bytes ({} where the device reports none)
    "compile": ("name", "bucket", "cost", "memory"),
    # flight recorder: a step exceeded stall_factor x the rolling median
    # of the last K steps
    "stall": ("step", "seconds", "median", "factor"),
    # on-demand trace capture lifecycle (armed -> started -> done)
    "profile": ("status",),
    # device memory report
    "device_memory": ("devices",),
    # a bucket plan built from a scanned size histogram: the inclusive
    # node-count boundaries and the simulated padding-waste ratio
    "bucket_plan": ("num_buckets", "bounds", "samples_scanned", "est_waste"),
    # goodput ledger (obs/ledger.py): one per epoch window; seconds and
    # fractions map every CATEGORIES entry to its wall time / fraction
    # (the fractions sum to 1); optional mfu per train bucket
    "goodput": ("epoch", "wall_s", "seconds", "fractions",
                "goodput_fraction"),
    # response cache (serve/cache.py): a measured traffic window's cache
    # counters
    "cache_stats": ("hits", "misses", "evictions", "bytes"),
    # request tracing (obs/trace.py): one span of one request's tree —
    # trace/span/parent are the tree ids (parent "" on the root), name the
    # segment (queue_wait/batch_form/dispatch/readback on the replica,
    # cache_lookup at a hit), start wall-clock unix seconds, dur_s the
    # span's duration, attrs its labels (tenant, bucket, batch_seq, ...)
    "span": ("trace", "span", "parent", "name", "start", "dur_s", "attrs"),
    # cost->quota feedback (serve/costs.py, HYDRAGNN_TENANT_COST_QUOTAS): a
    # tenant's admission quota shaved (over_cost) or restored (restored);
    # cost_share its share of the window's device time, fair_share its
    # weight-proportional entitlement
    "quota_adjusted": ("tenant", "old_quota", "new_quota", "reason",
                       "cost_share", "fair_share"),
    # tenant cost ledger (serve/costs.py): one bill row of a measured
    # window — device_s attributed device wall-time, replica_s the
    # integrated replica-seconds the rows (plus idle) sum to
    "tenant_cost": ("tenant", "device_s", "flops", "requests", "replica_s"),
    # serving fleet (serve/fleet.py): a replica's process exited or its
    # lease went stale (reason exit_<rc>, lease_expired, boot_timeout)
    "replica_lost": ("replica", "reason"),
    # the supervisor respawned a lost replica and its new incarnation
    # reported serving; downtime_s spans detection to the serving lease
    "replica_respawned": ("replica", "downtime_s"),
    # hot-swap: a candidate warmed on every live replica (per bucket,
    # compile-counter verified) was published as the active version
    "model_promoted": ("name", "version"),
    # hot-swap: a candidate was refused (strict load, warm-up, ack
    # timeout) or the operator rolled back; the old version kept serving
    "model_rollback": ("name", "reason"),
    # live replicas dropped below the target (the router's shed trigger)
    "fleet_degraded": ("live", "target"),
    # a load generator's measured traffic window: availability is
    # succeeded / submitted logical requests
    "fleet_report": ("submitted", "succeeded", "availability"),
    # the training side published a candidate snapshot into the channel
    # (serve/registry.py CandidateChannel); candidate is the channel seq
    "candidate_published": ("candidate", "checkpoint"),
    # canary controller (serve/canary.py): a candidate booted on a canary
    # replica and entered shadow evaluation
    "canary_started": ("candidate", "checkpoint"),
    # every gate passed over the sample floor and the all-acked hot-swap
    # promoted the candidate
    "canary_promoted": ("candidate", "checkpoint", "samples"),
    # the candidate was rejected before serving a live request; reason
    # names the gate (nan_outputs, head_mae, latency, shadow_errors,
    # crash_loop, insufficient_samples, superseded, hot_swap_rolled_back)
    "canary_rejected": ("candidate", "checkpoint", "reason"),
    # one per spec'd tenant at fleet start: who is packed with what quota
    "tenant_admitted": ("tenant", "model", "quota"),
    # the supervised replica target moved (reason slo_pressure, forecast,
    # scale_down, manual)
    "fleet_scaled": ("old_target", "new_target", "reason"),
    # drift detector (obs/drift.py): one per tumbling window; scores maps
    # "tenant|feature|head" to {psi, ks} against the version's reference
    "drift_window": ("version", "window", "scores"),
    # a feature's score crossed the hysteresis threshold (raised) or came
    # back under it for clear_after windows (cleared)
    "drift_alert": ("tenant", "feature", "head", "kind", "score", "status", "version"),
    # a non-finite answer (a canary's NaN veto): scope the region, origin
    # the first non-finite tensor, subtree its group, leaves/total counts
    "nan_origin": ("scope", "origin", "subtree", "leaves", "total"),
}

_ENVELOPE = ("event", "ts", "seq")


def _jsonable(obj):
    """json.dump default hook: numpy scalars/arrays -> plain python."""
    import numpy as np

    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


def _nullify_nonfinite(obj):
    """Strict JSON has no NaN/Infinity tokens; a diverged epoch's losses
    map to null instead of producing a line jq/JS/Go consumers reject."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _nullify_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_nullify_nonfinite(v) for v in obj]
    return obj


def _repair_torn_tail(path: str):
    """A hard kill mid-write can leave a final line with no terminating
    newline; appending to it would merge the partial garbage with the
    resumed run's first event into one corrupt line. The partial line
    never completed — drop it (truncate to the last newline) so the
    stream stays a valid prefix."""
    try:
        size = os.path.getsize(path)
        if size == 0:
            return
        with open(path, "rb+") as f:
            f.seek(max(size - 65536, 0))
            tail = f.read()
            if tail.endswith(b"\n"):
                return
            cut = tail.rfind(b"\n")
            f.truncate(size - len(tail) + (cut + 1 if cut >= 0 else 0))
    except OSError:
        pass


def _next_seq(path: str) -> int:
    """seq the next event appended to ``path`` should carry: last line's
    seq + 1 (0 for a fresh/empty/unreadable stream). Reads only the tail."""
    try:
        size = os.path.getsize(path)
        if size == 0:
            return 0
        with open(path, "rb") as f:
            f.seek(max(size - 65536, 0))
            tail = f.read().decode(errors="replace").strip().splitlines()
        for line in reversed(tail):
            line = line.strip()
            if not line:
                continue
            try:
                return int(json.loads(line).get("seq", -1)) + 1
            except (ValueError, TypeError):
                continue  # unparseable line — walk back to a complete one
        return 0
    except OSError:
        return 0


class RunEventLog:
    """Append-only JSONL event stream for one run (thread-safe)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        # a rerun/resume of the same run name APPENDS to the existing
        # stream — seq must continue where the previous process left off,
        # or the stream reads as torn
        _repair_torn_tail(path)
        self._seq = _next_seq(path)
        self._f = open(path, "a", buffering=1)  # line-buffered: crash-safe

    def emit(self, event: str, **fields):
        """Append one event. Never raises into the caller — a full
        disk must not kill a run that would otherwise finish."""
        with self._lock:
            if self._f is None:
                return
            rec = {"event": event, "ts": round(time.time(), 6),
                   "seq": self._seq}
            rec.update(fields)
            try:
                try:
                    line = json.dumps(
                        rec, default=_jsonable, allow_nan=False
                    )
                except ValueError:
                    # non-finite floats (a diverged epoch's NaN losses —
                    # exactly what this stream must record): null them
                    # rather than emit a non-standard NaN token or drop
                    # the event
                    line = json.dumps(
                        _nullify_nonfinite(
                            json.loads(json.dumps(rec, default=_jsonable))
                        ),
                        allow_nan=False,
                    )
                # the write must stay in the critical section: seq order
                # ON DISK must match assignment order, and interleaved
                # writes from two emitters would tear the JSONL stream
                # threadlint: disable=blocking-under-lock
                self._f.write(line + "\n")
                self._seq += 1
            except (OSError, ValueError, TypeError):
                pass

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None


def iter_events(root: str) -> Iterator[Dict]:
    """Every complete record under ``root``: one stream file, or a
    directory searched recursively for ``events*.jsonl`` (the fleet's
    layout: a stream per process), the streams in path order. Tolerant: a
    blank, torn or unparseable line, a line that is not a record and an
    unreadable stream are skipped (a live stream is read mid-write)."""
    if os.path.isdir(root):
        paths = sorted(
            os.path.join(dirpath, fn)
            for dirpath, _dirnames, filenames in os.walk(root)
            for fn in filenames
            if fn.startswith("events") and fn.endswith(".jsonl")
        )
    else:
        paths = [root]
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "event" in rec:
                yield rec


def validate_events(
    path: str, require: Optional[List[str]] = None
) -> List[Dict]:
    """Parse + schema-check an ``events.jsonl`` stream.

    Checks every line parses, envelopes are complete, ``seq`` is strictly
    increasing from 0, known event types carry their required fields
    (:data:`EVENT_FIELDS`), and each type in ``require`` appears at least
    once. Returns the parsed records; raises ``ValueError`` on the first
    violation — this is the CI gate's validator as well as the tests'.
    """
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: unparseable event line ({e})"
                ) from e
            for k in _ENVELOPE:
                if k not in rec:
                    raise ValueError(
                        f"{path}:{lineno}: event missing envelope "
                        f"field {k!r}"
                    )
            if rec["seq"] != len(records):
                raise ValueError(
                    f"{path}:{lineno}: seq {rec['seq']} != expected "
                    f"{len(records)} (stream torn or interleaved)"
                )
            needed = EVENT_FIELDS.get(rec["event"], ())
            missing = [k for k in needed if k not in rec]
            if missing:
                raise ValueError(
                    f"{path}:{lineno}: event {rec['event']!r} missing "
                    f"required fields {missing}"
                )
            records.append(rec)
    if require:
        seen = {r["event"] for r in records}
        absent = [t for t in require if t not in seen]
        if absent:
            raise ValueError(
                f"{path}: required event types never emitted: {absent}"
            )
    return records
