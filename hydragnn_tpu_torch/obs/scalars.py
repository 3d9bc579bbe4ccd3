"""ScalarWriter: backend-agnostic per-epoch scalar fan-out (port of
``obs/scalars.py``).

Every run gets an always-on plain-file backend (JSONL by default, CSV via
``HYDRAGNN_SCALAR_FORMAT=csv``) with no optional dependency, and the
TensorBoard backend (``torch.utils.tensorboard``) rides along when it
imports; when it does not, that is warned once per process, on rank 0.

The writer implements the subset of the ``SummaryWriter`` protocol the
epoch driver uses (``add_scalar(tag, value, step)``, ``close()``), so it
drops into the existing ``writer=`` plumbing unchanged. Tracer region
totals are forwarded through the same fan-out at end of run
(:meth:`ScalarWriter.add_regions`).
"""

import csv
import json
import os
import time
import warnings
from typing import Dict, List, Optional

_tb_warned = False  # TensorBoard-unavailable warning fires once per process


class JsonlScalarBackend:
    """Always-on backend: one JSON object per scalar, append-only."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step):
        try:
            self._f.write(
                json.dumps(
                    {
                        "tag": tag,
                        "value": float(value),
                        "step": int(step),
                        "ts": round(time.time(), 6),
                    }
                )
                + "\n"
            )
        except (OSError, ValueError, TypeError):
            pass

    def close(self):
        try:
            self._f.close()
        except OSError:
            pass


class CsvScalarBackend:
    """Plain-file alternative for spreadsheet-side consumers."""

    _HEADER = ("tag", "value", "step", "ts")

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_header = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "a", newline="", buffering=1)
        self._w = csv.writer(self._f)
        if write_header:
            self._w.writerow(self._HEADER)

    def add_scalar(self, tag: str, value, step):
        try:
            self._w.writerow(
                [tag, float(value), int(step), round(time.time(), 6)]
            )
        except (OSError, ValueError, TypeError):
            pass

    def close(self):
        try:
            self._f.close()
        except OSError:
            pass


class TensorBoardScalarBackend:
    """``torch.utils.tensorboard``'s writer, where it imports (it needs the
    ``tensorboard`` package)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step):
        self._writer.add_scalar(tag, value, step)

    def close(self):
        self._writer.close()


class ScalarWriter:
    """Fan one ``add_scalar`` call out to every configured backend.

    Backend failures are isolated: a TensorBoard event file hitting a full
    disk mid-run must not kill a training run that would otherwise finish
    (the file backends swallow their own OSErrors for the same reason)."""

    def __init__(self, backends: List):
        self.backends = list(backends)

    def add_scalar(self, tag: str, value, step):
        for b in self.backends:
            try:
                b.add_scalar(tag, value, step)
            except Exception:
                pass

    def add_regions(self, regions: Dict[str, float], step: int = 0):
        """Forward tracer region totals (``tracer.totals()``) as
        ``tracer/<region>_seconds`` scalars."""
        for name, seconds in sorted(regions.items()):
            self.add_scalar(f"tracer/{name}_seconds", seconds, step)

    def close(self):
        for b in self.backends:
            try:
                b.close()
            except Exception:
                pass  # one backend's close failure must not skip the rest

    @classmethod
    def for_run(
        cls, log_name: str, path: str = "./logs/"
    ) -> Optional["ScalarWriter"]:
        """The run-scoped writer: rank 0 only (None elsewhere, same
        contract as the old ``_get_summary_writer``), file backend always,
        TensorBoard when available."""
        global _tb_warned
        from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

        _, rank = comm_size_and_rank()
        if rank != 0:
            return None
        log_dir = os.path.join(path, log_name)
        fmt = os.getenv("HYDRAGNN_SCALAR_FORMAT", "jsonl").strip().lower()
        if fmt == "csv":
            backends = [CsvScalarBackend(os.path.join(log_dir, "scalars.csv"))]
        else:
            backends = [
                JsonlScalarBackend(os.path.join(log_dir, "scalars.jsonl"))
            ]
        try:
            backends.append(TensorBoardScalarBackend(log_dir))
        except Exception as e:
            if not _tb_warned:
                _tb_warned = True
                warnings.warn(
                    "TensorBoard scalar backend unavailable "
                    f"({type(e).__name__}: {e}); scalars still recorded by "
                    f"the {fmt} backend under {log_dir}",
                    stacklevel=2,
                )
        return cls(backends)
