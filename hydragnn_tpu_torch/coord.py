"""Shared-directory coordination: leases, tombstones, watchdogs (a copy of
the JAX package's ``coord.py``, which the port does not import).

Every member of a group writes an atomic JSON **heartbeat lease** from a
background thread; anyone can read everyone's lease age; a member whose
lease is stale past the timeout (or that has been explicitly
**tombstoned**) is dead; a background :class:`PeerWatchdog` turns that
read into a callback off the owner's main thread, so that a wedged main
thread (a batcher stuck in a dispatch) still gets its peers declared lost.
The serving fleet (``serve/fleet.py``) layers respawn and hot-swap on top.

The files are the JAX package's, byte for byte, so either package reads
the other's coordination directory (``kind`` picks the lease family,
``prefix`` the member naming: the fleet's ``replica`` leases are named
``replica-<k>``)::

    <dir>/<kind>s/<prefix>-<k>.json    heartbeat leases
    <dir>/dead/<prefix>-<k>.json       tombstones (first write wins)
"""

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

DEFAULT_HEARTBEAT_S = 1.0
DEFAULT_LEASE_S = 6.0


# ---- atomic JSON files -----------------------------------------------------


def write_json(path: str, obj: Dict):
    """Atomic JSON write (tmp + rename): a reader never sees a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # mid-rename/missing — the caller polls again


# ---- lease / tombstone paths ----------------------------------------------


def hb_path(coord_dir: str, kind: str, member: int,
            prefix: str = "host") -> str:
    return os.path.join(coord_dir, f"{kind}s", f"{prefix}-{int(member)}.json")


def tomb_path(coord_dir: str, member: int, prefix: str = "host") -> str:
    return os.path.join(coord_dir, "dead", f"{prefix}-{int(member)}.json")


def write_tombstone(coord_dir: str, member: int, reason: str, by: int,
                    prefix: str = "host", **extra):
    """Idempotent: the FIRST detection timestamp is the one recoveries are
    measured from, so an existing tombstone is never overwritten."""
    path = tomb_path(coord_dir, member, prefix=prefix)
    if os.path.exists(path):
        return
    rec = {"ts": time.time(), "reason": reason, "by": int(by)}
    rec[prefix] = int(member)
    rec.update(extra)
    write_json(path, rec)


def read_tombstone(coord_dir: str, member: int,
                   prefix: str = "host") -> Optional[Dict]:
    return read_json(tomb_path(coord_dir, member, prefix=prefix))


def clear_tombstone(coord_dir: str, member: int, prefix: str = "host"):
    """Remove a member's tombstone — the respawn path: a supervisor that
    healed the loss must lift the death sentence before the replacement
    starts, or the replacement reads itself as already-evicted."""
    try:
        os.remove(tomb_path(coord_dir, member, prefix=prefix))
    except OSError:
        pass


def heartbeat_age(coord_dir: str, kind: str, member: int,
                  now: Optional[float] = None,
                  prefix: str = "host") -> Optional[float]:
    """Seconds since ``member`` last heartbeat as ``kind``; None = never."""
    hb = read_json(hb_path(coord_dir, kind, member, prefix=prefix))
    if hb is None or "ts" not in hb:
        return None
    return (now if now is not None else time.time()) - float(hb["ts"])


def dead_members(
    coord_dir: str,
    members: List[int],
    lease_s: float,
    kind: str = "agent",
    now: Optional[float] = None,
    current_gen: Optional[int] = None,
    prefix: str = "host",
) -> Dict[int, float]:
    """``{member: detect_ts}`` for every member that is tombstoned or whose
    ``kind`` heartbeat lease expired. A member that never heartbeat at all
    is NOT dead — it may still be bootstrapping; the lease only starts
    ticking once a first heartbeat exists. With ``current_gen``, a lease
    from an EARLIER generation (or incarnation) is treated the same way:
    leases persist at one path across respawns, so a respawned member
    that has not yet written its first new-gen lease must read as
    bootstrapping, not as stale (its old lease is necessarily older than
    the downtime)."""
    now = time.time() if now is None else now
    dead: Dict[int, float] = {}
    for m in members:
        tomb = read_tombstone(coord_dir, m, prefix=prefix)
        if tomb is not None:
            dead[m] = float(tomb.get("ts", now))
            continue
        hb = read_json(hb_path(coord_dir, kind, m, prefix=prefix))
        if hb is None or "ts" not in hb:
            continue  # never heartbeat: still bootstrapping, not dead
        if (
            current_gen is not None
            and int(hb.get("gen", current_gen)) < current_gen
        ):
            continue  # pre-respawn lease: the new member is booting
        if hb.get("done"):
            # a CLEANLY finished member stops heartbeating forever — end
            # of run, not a death. Without this, a finished peer's stale
            # lease would read as a loss and kill survivors' tails.
            continue
        if now - float(hb["ts"]) > lease_s:
            dead[m] = now
    return dead


# ---- heartbeat + watchdog threads -----------------------------------------


class Heartbeat:
    """Background lease writer: one atomic JSON write per interval.

    The thread is daemon (a crashed owner must not hang interpreter
    exit) with an explicit lifecycle: :meth:`stop` joins it bounded."""

    def __init__(self, path: str, payload: Callable[[], Dict],
                 interval_s: float):
        self.path = path
        self._payload = payload
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hydragnn-heartbeat", daemon=True
        )

    def start(self) -> "Heartbeat":
        self._write()  # the lease exists before start() returns
        self._thread.start()
        return self

    def _write(self):
        try:
            rec = dict(self._payload())
            rec["ts"] = time.time()
            rec["pid"] = os.getpid()
            write_json(self.path, rec)
        except OSError:
            pass  # a full/flaky shared FS must not kill the run

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self._write()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(self.interval_s * 4, 5.0))
        # final flush: the file must end on the TRUE last progress (a run
        # whose tail beat the next tick would otherwise read one interval
        # stale forever — e.g. an HPO trial's final step count)
        self._write()


class PeerWatchdog:
    """Declares peers lost when their lease expires.

    Runs off the owner's main thread so a wedged main thread (a
    collective hung on a dead peer; a dispatch stuck on a wedged
    accelerator) still gets losses detected. ``on_loss`` receives
    ``{member: detect_ts}`` once and the watchdog returns; ``on_evicted``
    fires when THIS member finds its own tombstone — a partitioned
    straggler must evict itself rather than split-brain the group. The
    default callbacks do nothing but record; a supervision plane installs
    the teeth."""

    def __init__(
        self,
        coord_dir: str,
        host: int,
        members: List[int],
        lease_s: float,
        interval_s: float,
        on_loss: Optional[Callable[[Dict[int, float]], None]] = None,
        on_evicted: Optional[Callable[[], None]] = None,
        gen: int = 0,
        kind: str = "worker",
        prefix: str = "host",
    ):
        self.coord_dir = coord_dir
        self.host = int(host)
        self.peers = [int(m) for m in members if int(m) != int(host)]
        self.lease_s = float(lease_s)
        self.interval_s = float(interval_s)
        self.gen = int(gen)
        self.kind = kind
        self.prefix = prefix
        self.last_loss: Optional[Dict[int, float]] = None
        self.evicted = False
        self._on_loss = on_loss or self._default_on_loss
        self._on_evicted = on_evicted or self._default_on_evicted
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hydragnn-peer-watchdog", daemon=True
        )

    def start(self) -> "PeerWatchdog":
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            if read_tombstone(
                self.coord_dir, self.host, prefix=self.prefix
            ) is not None:
                self.evicted = True
                self._on_evicted()
                return
            dead = dead_members(
                self.coord_dir, self.peers, self.lease_s, kind=self.kind,
                current_gen=self.gen, prefix=self.prefix,
            )
            if dead:
                self.last_loss = dead
                self._on_loss(dead)
                return

    def _default_on_loss(self, dead: Dict[int, float]):
        pass  # recorded in last_loss; the owner polls

    def _default_on_evicted(self):
        pass  # recorded in evicted; the owner polls

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(self.interval_s * 4, 5.0))
