"""Versioned model registry for the predict server (port of
``serve/registry.py``'s ``ModelRegistry``).

An entry is a model module in eval mode plus its head schema and where it
came from. Several models serve side by side, one entry per name;
re-registering a name adds its next version. In-flight batches keep the
entry they were packed with, so a swap lands at a batch boundary.

:meth:`ModelRegistry.load_checkpoint` builds an entry from a checkpoint
(the port's or the JAX package's ``./logs/<name>/<name>.pk``): the model
of the ``config.json`` saved beside it (or of ``arch_config``), its
weights through the strict loader (no rolling fallback: serving never
answers from older weights), the ``train_meta`` dropped.

Activation: :meth:`ModelRegistry.promote` pins which version answers
version-less :meth:`ModelRegistry.get` calls (until the first promote,
the latest registered); each effective promote pushes onto a per-name
activation stack, and :meth:`ModelRegistry.rollback` pops back to the
version that served before it. Promoting the active version again
changes nothing. :meth:`ModelRegistry.promote_checkpoint` pins the active
version, loads the candidate strictly, and only then registers and
promotes it: a corrupt candidate raises with the registry as it was.
:meth:`ModelRegistry.describe` summarises the entries. The candidate
channel and activation listeners wait for the canary (``ROADMAP.md``,
queue 1, item 5).
"""

import dataclasses
import json
import os
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
    source: str = "memory"  # the checkpoint's directory, or "memory"

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
        # the activation stack per name: [..., previous, active]; empty
        # (never promoted): the latest registered version serves
        self._active: Dict[str, List[int]] = {}

    def register(self, name: str, model: nn.Module, source: str = "memory") -> ModelEntry:
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
                source=source,
            )
            self._entries.setdefault(name, []).append(entry)
            return entry

    def load_checkpoint(self, checkpoint_name: str, arch_config: Optional[dict] = None,
                        path: str = "./logs/", name: Optional[str] = None,
                        device=None) -> ModelEntry:
        """Register ``<path>/<checkpoint_name>/<checkpoint_name>.pk`` as the
        next version of ``name`` (default: the checkpoint's name).
        ``arch_config`` is the derived Architecture section; by default the
        one of the ``config.json`` beside the checkpoint. The model is
        built on ``device`` (the card unless ``"cpu"``) with the
        aggregation ``run_training`` gives it. Raises for a corrupt file
        and for one without ``params``."""
        from hydragnn_tpu_torch.models.bridge import load_flax_variables
        from hydragnn_tpu_torch.models.create import create_model_config
        from hydragnn_tpu_torch.train.checkpoint import load_state_dict, pop_train_meta
        from hydragnn_tpu_torch.utils.config import model_aggregation

        if arch_config is None:
            with open(os.path.join(path, checkpoint_name, "config.json"), "r") as f:
                config = json.load(f)
            arch_config = dict(config["NeuralNetwork"]["Architecture"])
            arch_config.setdefault("loss_function_type", config["NeuralNetwork"].get(
                "Training", {}).get("loss_function_type", "mse"))
        restored = load_state_dict(checkpoint_name, path=path, fallback=False)
        pop_train_meta(restored)
        if "params" not in restored:
            raise ValueError(
                f"checkpoint {checkpoint_name} has no 'params' section: not a model checkpoint")
        model = create_model_config(dict(arch_config), device=device,
                                    aggregation=model_aggregation())
        load_flax_variables(model, {"params": restored["params"],
                                    "batch_stats": restored.get("batch_stats", {})})
        return self.register(name or checkpoint_name, model,
                             source=os.path.join(path, checkpoint_name))

    def get(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """The explicit ``version`` when given, else the active one (last
        promote; latest registered when nothing was ever promoted)."""
        with self._lock:
            history = self._entries.get(name)
            if not history:
                raise KeyError(f"no model registered under {name!r}")
            if version is None:
                stack = self._active.get(name)
                version = stack[-1] if stack else history[-1].version
            for entry in history:
                if entry.version == version:
                    return entry
            raise KeyError(f"model {name!r} has no version {version}")

    def active_version(self, name: str) -> int:
        """The version a version-less :meth:`get` serves now."""
        return self.get(name).version

    def promote(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """Activate ``version`` of ``name`` (default: latest registered) for
        version-less :meth:`get` calls. Promoting the active version again
        leaves the activation stack as it is. Raises ``KeyError`` for
        unknown names/versions, with the registry unchanged."""
        with self._lock:
            history = self._entries.get(name)
            if not history:
                raise KeyError(f"no model registered under {name!r}")
            if version is None:
                version = history[-1].version
            entry = next((e for e in history if e.version == version), None)
            if entry is None:
                raise KeyError(f"model {name!r} has no version {version}")
            stack = self._active.setdefault(name, [])
            if not stack:
                # the implicit active version first, so that the first
                # rollback has a version to return to
                stack.append(history[-1].version)
            if stack[-1] != version:
                stack.append(version)
            return entry

    def rollback(self, name: str) -> ModelEntry:
        """Re-activate the version that served before the last effective
        promote. Raises ``ValueError`` when there is none."""
        with self._lock:
            stack = self._active.get(name)
            if not stack or len(stack) < 2:
                raise ValueError(f"model {name!r} has no previous promoted version to roll back to")
            stack.pop()
            version = stack[-1]
            return next(e for e in self._entries[name] if e.version == version)

    def promote_checkpoint(self, checkpoint_name: str, arch_config: Optional[dict] = None,
                           path: str = "./logs/", name: Optional[str] = None,
                           device=None) -> ModelEntry:
        """Load, register and promote a candidate checkpoint as one step:
        the active version is pinned first (registering must not flip
        serving onto the candidate, and a later rollback returns to it),
        then the strict load runs; a corrupt candidate raises there, and
        nothing is registered or promoted."""
        serving_name = name or checkpoint_name
        try:
            self.promote(serving_name, self.active_version(serving_name))
        except KeyError:
            pass  # the name's first version: nothing to pin
        entry = self.load_checkpoint(checkpoint_name, arch_config=arch_config, path=path,
                                     name=name, device=device)
        return self.promote(entry.name, entry.version)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def describe(self) -> Dict[str, Dict]:
        """Per name: the active ``version``, the ``latest`` registered, the
        number of ``versions``, and the active entry's head schema and
        ``source``."""
        with self._lock:
            out = {}
            for name, history in self._entries.items():
                stack = self._active.get(name)
                active = stack[-1] if stack else history[-1].version
                serving = next(e for e in history if e.version == active)
                out[name] = {
                    "version": active,
                    "latest": history[-1].version,
                    "versions": len(history),
                    "output_type": list(serving.output_type),
                    "output_dim": list(serving.output_dim),
                    "source": serving.source,
                }
            return out
