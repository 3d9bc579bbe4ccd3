"""Versioned model registry for the predict server (port of the
``ModelRegistry`` core of ``serve/registry.py``).

An entry is a model module in eval mode plus its head schema. Several
models serve side by side, one entry per name; re-registering a name adds
its next version. :meth:`ModelRegistry.promote` pins which version answers
version-less :meth:`ModelRegistry.get` calls; until the first promote the
latest registered version serves. In-flight batches keep the entry they
were packed with, so a swap lands at a batch boundary.

Checkpoint loading, rollback and the candidate channel are not ported
(see ``ROADMAP.md``).
"""

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One serveable model version."""

    name: str
    version: int
    model: nn.Module  # HydraBase subclass, in eval mode
    output_type: Tuple[str, ...]  # per head: "graph" | "node"
    output_dim: Tuple[int, ...]

    @property
    def key(self) -> Tuple[str, int]:
        return (self.name, self.version)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


class ModelRegistry:
    """Name -> latest :class:`ModelEntry`, with version history."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, List[ModelEntry]] = {}
        # the promoted version per name; absent = never promoted -> the
        # latest registered version serves
        self._active: Dict[str, int] = {}

    def register(self, name: str, model: nn.Module) -> ModelEntry:
        """Freeze ``model`` (eval mode) as the next version of ``name``."""
        model.eval()
        with self._lock:
            version = len(self._entries.get(name, ())) + 1
            entry = ModelEntry(
                name=name,
                version=version,
                model=model,
                output_type=tuple(model.output_type),
                output_dim=tuple(model.output_dim),
            )
            self._entries.setdefault(name, []).append(entry)
            return entry

    def load_checkpoint(self, *args, **kwargs) -> ModelEntry:
        raise NotImplementedError(
            "checkpoint loading needs the port of train/checkpoint.py: see ROADMAP.md"
        )

    def get(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """The explicit ``version`` when given, else the active one (last
        promote; latest registered when nothing was ever promoted)."""
        with self._lock:
            history = self._entries.get(name)
            if not history:
                raise KeyError(f"no model registered under {name!r}")
            if version is None:
                version = self._active.get(name, history[-1].version)
            for entry in history:
                if entry.version == version:
                    return entry
            raise KeyError(f"model {name!r} has no version {version}")

    def promote(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """Activate ``version`` of ``name`` (default: latest registered) for
        version-less :meth:`get` calls. Promoting the active version again
        changes nothing. Raises ``KeyError`` for unknown names/versions."""
        with self._lock:
            history = self._entries.get(name)
            if not history:
                raise KeyError(f"no model registered under {name!r}")
            if version is None:
                version = history[-1].version
            entry = next((e for e in history if e.version == version), None)
            if entry is None:
                raise KeyError(f"model {name!r} has no version {version}")
            self._active[name] = version
            return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)
