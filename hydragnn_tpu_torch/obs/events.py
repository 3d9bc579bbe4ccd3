"""Structured run events: one append-only JSONL stream (a copy of the JAX
package's ``obs/events.py``, which the port does not import).

Every line is one JSON object with a fixed envelope::

    {"event": <type>, "ts": <unix seconds>, "seq": <per-stream monotonic int>, ...}

plus the payload fields of the event's type in :data:`EVENT_FIELDS`. The
port keeps the schema of the kinds it emits: ``span`` (request tracing,
``obs/trace.py``), ``quota_adjusted`` (the cost ledger's feedback,
``serve/costs.py``), ``tenant_cost``, ``cache_stats`` and the run manifest;
the JAX package's ``validate_events`` reads the streams the port writes.
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
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

# event type -> required payload fields (on top of the envelope)
EVENT_FIELDS: Dict[str, tuple] = {
    "run_manifest": (
        "schema_version", "run", "config_hash", "git_rev", "world_size",
        "device_kind", "device_count", "num_epoch",
    ),
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
