"""Checkpoint save and load (port of ``train/checkpoint.py``), in the JAX
package's file format, so that each package reads the other's files.

A checkpoint is ``./logs/<name>/<name>.pk``: the 8-byte magic
``HGTPCKPT``, then ``<II`` format version 2 and the CRC32 of the payload,
then the payload, msgpack of the state dict (``train/msgpack_codec.py``,
the subset flax's ``msgpack_serialize`` writes). The state dict is the
tree the JAX package writes for its ``TrainState``: ``{"params",
"batch_stats", "opt_state", "step"}`` in flax's names and layouts
(``models/bridge.py`` maps the port's module and optimizer onto it and
back), and in format 2 an optional ``train_meta`` section, the training
loop's state (``train/epoch_driver.py``).

Writes are atomic (a ``.tmp`` file, fsync, rename), so a killed job never
leaves a half-written file that parses. With ``keep_last`` K, each save
also writes its bytes as an independent ``<name>.roll-<seq>.pk`` and
keeps the newest K. :func:`load_state_dict` checks the CRC and refuses a
format version from the future; on a corrupt, truncated or missing
primary it walks back to the newest intact rolling file, unless
``fallback=False`` (prediction and serving, which must never answer from
older weights). :class:`AsyncCheckpointWriter` moves serialisation and
I/O to a background thread; the caller keeps only the snapshot, an owned
host copy of every tensor. After each write ``utils.faults.corrupt_checkpoint``
may flip a byte of the primary file (``HYDRAGNN_FAULT_CORRUPT_CHECKPOINT``),
which the load's CRC check and rolling fallback then meet. Each write and
each load is a ``checkpoint_saved`` / ``checkpoint_restored`` event of the
active run (``obs/runtime.py``).
"""

import binascii
import glob
import os
import re
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from hydragnn_tpu_torch.obs import runtime as obs
from hydragnn_tpu_torch.train import msgpack_codec
from hydragnn_tpu_torch.utils import faults

MAGIC = b"HGTPCKPT"
VERSION = 2  # 2 = 1 + the optional "train_meta" section
TRAIN_META_KEY = "train_meta"
_ROLL_RE = re.compile(r"\.roll-(\d+)\.pk$")


def _resolve_keep_last(keep_last: Optional[int]) -> int:
    """The explicit argument, else ``HYDRAGNN_CKPT_KEEP``, else 0 (no
    rolling copies)."""
    if keep_last is not None:
        return max(int(keep_last), 0)
    return max(int(os.getenv("HYDRAGNN_CKPT_KEEP", "0")), 0)


def _rolling_paths(out_dir: str, name: str) -> List[str]:
    """Rolling files of ``name``, newest (highest sequence) first."""
    with_seq = []
    for p in glob.glob(os.path.join(out_dir, name + ".roll-*.pk")):
        m = _ROLL_RE.search(p)
        if m:
            with_seq.append((int(m.group(1)), p))
    return [p for _, p in sorted(with_seq, reverse=True)]


def rolling_checkpoints(name: str, path: str = "./logs/") -> List[str]:
    """The retained rolling checkpoints of ``name``, newest first."""
    return _rolling_paths(os.path.join(path, name), name)


def checkpoint_exists(name: str, path: str = "./logs/") -> bool:
    return os.path.exists(os.path.join(path, name, name + ".pk"))


def _write_durably(target: str, payload: bytes):
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)


def _retain_rolling(out_dir: str, name: str, payload: bytes, keep: int):
    """Write the save's bytes as an independent rolling file (a copy, not
    a link: corruption of the primary must not reach its fallback) and
    delete the ones past the newest ``keep``."""
    rolls = _rolling_paths(out_dir, name)
    seq = int(_ROLL_RE.search(rolls[0]).group(1)) + 1 if rolls else 0
    _write_durably(os.path.join(out_dir, f"{name}.roll-{seq:06d}.pk"), payload)
    for old in _rolling_paths(out_dir, name)[keep:]:
        try:
            os.remove(old)
        except OSError:
            pass


def encode(state_dict: Dict[str, Any]) -> bytes:
    """Header and payload of one checkpoint file."""
    blob = msgpack_codec.packb(state_dict)
    return MAGIC + struct.pack("<II", VERSION, binascii.crc32(blob) & 0xFFFFFFFF) + blob


def _to_host(tree, copy: bool):
    """``tree`` with every leaf a host numpy array, as the JAX package's
    ``np.asarray`` over its tree makes it (a Python int or float of the
    ``train_meta`` becomes a 0-d array; None stays; a bf16 tensor stays a
    tensor, on the host). With ``copy`` each leaf is an owned copy: a
    background writer serialises the snapshot while the state keeps
    training, and a view of a buffer that the next step updates in place
    would give a checkpoint whose CRC is valid and whose contents are
    torn."""
    if isinstance(tree, dict):
        return {k: _to_host(v, copy) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.clone() if copy else t
        return np.array(t.numpy(), copy=True) if copy else t.numpy()
    return np.array(tree, copy=True) if copy else np.asarray(tree)


def save_model(state_or_dict, name: str, path: str = "./logs/",
               train_meta: Optional[Dict[str, Any]] = None,
               keep_last: Optional[int] = None,
               writer: Optional["AsyncCheckpointWriter"] = None) -> Dict[str, float]:
    """Write ``<path>/<name>/<name>.pk`` atomically from a ``TrainState``
    (through ``models.bridge.state_dict_of``) or a state dict, with
    ``train_meta`` embedded when given and ``keep_last`` rolling copies.
    Returns ``{"bytes", "snapshot_s", "write_s"}`` of a synchronous save;
    with a ``writer`` only the snapshot is taken here and the rest runs on
    its thread (``bytes`` and ``write_s`` are then None)."""
    t0 = time.perf_counter()
    if isinstance(state_or_dict, dict):
        sd = dict(state_or_dict)
    else:
        from hydragnn_tpu_torch.models.bridge import state_dict_of

        sd = state_dict_of(state_or_dict)
    if train_meta is not None:
        sd[TRAIN_META_KEY] = train_meta
    sd = _to_host(sd, copy=writer is not None)
    snapshot_s = time.perf_counter() - t0
    keep = _resolve_keep_last(keep_last)
    resumable = train_meta is not None
    if writer is None:
        nbytes, write_s = _serialize_and_write(sd, path, name, keep, resumable, snapshot_s)
        return {"bytes": nbytes, "snapshot_s": snapshot_s, "write_s": write_s}
    queued = time.perf_counter()
    writer.submit(lambda: _serialize_and_write(sd, path, name, keep, resumable, snapshot_s,
                                               queued))
    return {"bytes": None, "snapshot_s": snapshot_s, "write_s": None}


def _serialize_and_write(sd, path: str, name: str, keep: int, resumable: bool = False,
                         snapshot_s: float = 0.0, queued: Optional[float] = None):
    """Encode, write durably, keep the rolling copies; inline for a sync
    save, on the writer's thread for an async one. The ``checkpoint_saved``
    event carries the snapshot and write seconds (and, async, the queue
    wait): the goodput ledger's checkpoint category."""
    t0 = time.perf_counter()
    out_dir = os.path.join(path, name)
    os.makedirs(out_dir, exist_ok=True)
    payload = encode(sd)
    final = os.path.join(out_dir, name + ".pk")
    _write_durably(final, payload)
    if keep > 0:
        _retain_rolling(out_dir, name, payload, keep)
    faults.corrupt_checkpoint(final)  # HYDRAGNN_FAULT_CORRUPT_CHECKPOINT; else nothing
    write_s = time.perf_counter() - t0
    obs.checkpoint_saved(
        name, kind="best" if name.endswith("-best") else "primary", resumable=resumable,
        bytes=len(payload), snapshot_s=round(snapshot_s, 6), write_s=round(write_s, 6),
        **({} if queued is None else {"async": True, "queued_s": round(t0 - queued, 6)}))
    return len(payload), write_s


class AsyncCheckpointWriter:
    """Checkpoint serialisation and I/O on one background thread.

    :meth:`submit` queues one write of an already-taken snapshot, and
    blocks while ``max_pending`` writes are in flight (a slow filesystem
    throttles the run instead of buying host memory). Writes run in the
    order submitted, so the rolling sequence stays monotonic. A failed
    write raises on the next :meth:`submit` or :meth:`drain`.
    :meth:`drain` returns once every queued write is fsynced and renamed.
    """

    def __init__(self, max_pending: int = 2):
        import queue

        self.max_pending = max(int(max_pending), 1)
        self._q = queue.Queue(maxsize=self.max_pending)
        self._thread = threading.Thread(target=self._run, name="hydragnn-async-ckpt",
                                        daemon=True)
        self._state_lock = threading.Lock()
        self._started = False
        self._closed = False
        self._pending = 0
        self._errors: List[BaseException] = []

    def submit(self, job: Callable[[], Any]):
        # an earlier failure surfaces before this job is counted: counting
        # first would leave a pending write no worker ever finishes
        self._raise_pending()
        while True:
            with self._state_lock:
                if self._closed:
                    raise RuntimeError("AsyncCheckpointWriter is closed")
                if self._pending < self.max_pending:
                    if not self._started:
                        self._started = True
                        self._thread.start()
                    self._pending += 1
                    break
            time.sleep(0.005)
        self._q.put(job)

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            except BaseException as e:
                with self._state_lock:
                    self._errors.append(e)
            finally:
                with self._state_lock:
                    self._pending -= 1

    def _raise_pending(self):
        with self._state_lock:
            if not self._errors:
                return
            err = self._errors.pop(0)
        raise RuntimeError(
            "background checkpoint write failed: the run has no newer durable "
            "checkpoint than the last successful save"
        ) from err

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted write finished (False when
        ``timeout`` seconds pass first). Raises if a write failed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._state_lock:
                pending = self._pending
            if pending == 0:
                self._raise_pending()
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)

    def close(self, timeout: float = 60.0):
        """Drain, stop the thread and refuse further writes; returns within
        about ``timeout`` even when a write hangs."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started and self.drain(timeout=timeout):
            self._q.put(None)
            self._thread.join(timeout=timeout)
        self._raise_pending()


_ASYNC_WRITER: Optional[AsyncCheckpointWriter] = None
_ASYNC_WRITER_LOCK = threading.Lock()


def resolve_async_writer(training_config: dict) -> Optional[AsyncCheckpointWriter]:
    """The process's writer when ``HYDRAGNN_ASYNC_CKPT`` or
    ``Training.async_checkpoint`` asks for one (default off), else None."""
    from hydragnn_tpu_torch.train.common import _env_flag

    if not _env_flag("HYDRAGNN_ASYNC_CKPT", training_config, "async_checkpoint"):
        return None
    global _ASYNC_WRITER
    with _ASYNC_WRITER_LOCK:
        if _ASYNC_WRITER is None:
            _ASYNC_WRITER = AsyncCheckpointWriter(
                max_pending=int(os.getenv("HYDRAGNN_ASYNC_CKPT_PENDING", "2")))
        return _ASYNC_WRITER


def drain_async(timeout: Optional[float] = None) -> bool:
    """Wait for the process's writer (True when none was started)."""
    with _ASYNC_WRITER_LOCK:
        writer = _ASYNC_WRITER
    return True if writer is None else writer.drain(timeout=timeout)


def parse_checkpoint_bytes(raw: bytes, fname: str) -> Dict[str, Any]:
    """The state dict of one file's bytes. Raises ``ValueError`` on a
    truncated header, a CRC mismatch, an unreadable payload and a format
    version above :data:`VERSION`; a file without the header is read as
    the headerless msgpack of the JAX package's first rounds."""
    if raw[: len(MAGIC)] == MAGIC:
        if len(raw) < len(MAGIC) + 8:
            raise ValueError(f"checkpoint {fname} is corrupt (truncated inside the header)")
        version, crc = struct.unpack_from("<II", raw, len(MAGIC))
        if version > VERSION:
            raise ValueError(
                f"checkpoint {fname} has format version {version}; this build reads "
                f"up to {VERSION}"
            )
        blob = raw[len(MAGIC) + 8 :]
        if (binascii.crc32(blob) & 0xFFFFFFFF) != crc:
            raise ValueError(
                f"checkpoint {fname} is corrupt (CRC mismatch): refusing to restore "
                "bad weights"
            )
    else:
        blob = raw
    try:
        restored = msgpack_codec.unpackb(blob)
    except Exception as e:
        raise ValueError(f"checkpoint {fname} is corrupt (unreadable payload: {e})") from e
    if not isinstance(restored, dict):
        raise ValueError(f"checkpoint {fname} is corrupt (its payload is not a map)")
    return restored


def load_state_dict(name: str, path: str = "./logs/", fallback: bool = True) -> Dict[str, Any]:
    """The state dict of ``<path>/<name>/<name>.pk``. With ``fallback``, a
    corrupt, truncated or missing primary gives way to the newest intact
    rolling file (with a warning); the primary's error is raised when none
    is intact. A format version from the future is refused either way."""
    fname = os.path.join(path, name, name + ".pk")
    try:
        with open(fname, "rb") as f:
            raw = f.read()
        restored = parse_checkpoint_bytes(raw, fname)
        obs.checkpoint_restored(name, source="primary")
        return restored
    except (ValueError, OSError) as primary_err:
        refused = isinstance(primary_err, ValueError) and "format version" in str(primary_err)
        if not fallback or refused:
            raise
        for roll in _rolling_paths(os.path.join(path, name), name):
            try:
                with open(roll, "rb") as f:
                    restored = parse_checkpoint_bytes(f.read(), roll)
            except (ValueError, OSError):
                continue
            import warnings

            warnings.warn(
                f"checkpoint {fname} unreadable ({primary_err}); restored the last good "
                f"rolling checkpoint {os.path.basename(roll)}"
            )
            obs.checkpoint_restored(name, source=f"rolling:{os.path.basename(roll)}")
            return restored
        raise


def pop_train_meta(restored: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Detach the format-2 training-loop state from a loaded state dict
    (None for a file without one)."""
    if isinstance(restored, dict):
        return restored.pop(TRAIN_META_KEY, None)
    return None
