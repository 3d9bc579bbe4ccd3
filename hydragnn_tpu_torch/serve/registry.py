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
:meth:`ModelRegistry.describe` summarises the entries.
:meth:`ModelRegistry.add_activation_listener` hangs a callback on every
effective promote or rollback (the response cache's invalidation): it runs
after the change, outside the registry's lock, and its exceptions are
swallowed.

Publication channel: :class:`CandidateChannel` is a file-backed queue of
candidate checkpoint snapshots under one root directory, laid out as the
JAX package lays it out, so that either package reads what the other
published and pinned (:func:`publish_candidate`; a tenant spec with a
``channel`` loads the pinned version). ``serve/canary.py``'s
``CanaryController`` consumes it.
"""

import dataclasses
import glob
import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from hydragnn_tpu_torch import coord


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
        # fn(name, new active version) after every effective promote or
        # rollback; added at server construction, called outside the lock
        self._listeners: List = []

    def add_activation_listener(self, fn):
        """Run ``fn(name, version)`` after each effective promote or
        rollback, outside the registry's lock (a listener may call back
        into the registry); its exceptions are swallowed, so that an
        observer never fails an activation."""
        self._listeners.append(fn)

    def _notify_activation(self, name: str, version: int):
        for fn in list(self._listeners):
            try:
                fn(name, version)
            except Exception:
                pass

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
                                    aggregation=model_aggregation(arch_config.get("model_type")))
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
        changed = False
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
                changed = True
        if changed:
            self._notify_activation(name, version)
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
            entry = next(e for e in self._entries[name] if e.version == version)
        self._notify_activation(name, version)
        return entry

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


    def __len__(self):
        """The number of registered names."""
        with self._lock:
            return len(self._entries)


# ---- candidate publication channel -------------------------------------------


class CandidateChannel:
    """File-backed train -> serve candidate queue under one root (the JAX
    package's layout)::

        <root>/candidates/cand-<seq:06d>.json   # manifest (commit point)
        <root>/versions/v<seq:06d>/<ck>/<ck>.pk # checkpoint snapshot
        <root>/promoted.json                    # {active_seq, base_seq}

    :meth:`publish` copies the checkpoint (and its ``config.json``) into
    the sequence's version directory, the ``<path>/<name>/<name>.pk``
    layout the strict loader reads, before it writes the manifest: the
    atomic manifest write is the commit point, so a consumer never sees a
    manifest whose snapshot is incomplete. One publisher, any number of
    consumers."""

    def __init__(self, root: str):
        self.root = root
        self._cand_dir = os.path.join(root, "candidates")
        self._ver_dir = os.path.join(root, "versions")

    def manifest_path(self, seq: int) -> str:
        return os.path.join(self._cand_dir, f"cand-{int(seq):06d}.json")

    def version_dir(self, seq: int) -> str:
        """The snapshot directory of ``seq``: the ``path`` of a strict
        checkpoint load."""
        return os.path.join(self._ver_dir, f"v{int(seq):06d}")

    def publish(self, checkpoint: str, path: str, **meta) -> Dict:
        """Snapshot ``<path>/<checkpoint>/<checkpoint>.pk`` (and its
        ``config.json`` when present) as the next candidate and commit its
        manifest; ``meta`` (epoch, val_loss, ...) rides along."""
        seq = self.latest_seq() + 1
        src = os.path.join(path, checkpoint)
        src_pk = os.path.join(src, f"{checkpoint}.pk")
        if not os.path.exists(src_pk):
            raise FileNotFoundError(f"cannot publish {checkpoint!r}: {src_pk} does not exist")
        dst = os.path.join(self.version_dir(seq), checkpoint)
        # a crashed publish may have left a manifest-less directory under
        # this seq: nothing can be reading it
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.makedirs(dst, exist_ok=True)
        tmp = os.path.join(dst, f".{checkpoint}.pk.tmp")
        shutil.copyfile(src_pk, tmp)
        os.replace(tmp, os.path.join(dst, f"{checkpoint}.pk"))
        cfg = os.path.join(src, "config.json")
        if os.path.exists(cfg):
            shutil.copyfile(cfg, os.path.join(dst, "config.json"))
        manifest = {
            "seq": seq,
            "checkpoint": checkpoint,
            "path": os.path.abspath(self.version_dir(seq)),
            "source_path": os.path.abspath(path),
            "ts": time.time(),
        }
        manifest.update(meta)
        coord.write_json(self.manifest_path(seq), manifest)
        return manifest

    def _seqs(self) -> List[int]:
        out = []
        for p in glob.glob(os.path.join(self._cand_dir, "cand-*.json")):
            m = re.search(r"cand-(\d+)\.json$", p)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_seq(self) -> int:
        seqs = self._seqs()
        return seqs[-1] if seqs else 0

    def read(self, seq: int) -> Optional[Dict]:
        return coord.read_json(self.manifest_path(seq))

    def pending(self, after_seq: int = 0) -> List[Dict]:
        """Committed manifests with ``seq > after_seq``, oldest first."""
        out = []
        for seq in self._seqs():
            if seq <= after_seq:
                continue
            man = self.read(seq)
            if man is not None:
                out.append(man)
        return out

    def record_promotion(self, seq: int):
        """Pin ``seq`` as the active published version; the previously
        active one becomes the rollback base. Both survive :meth:`gc`."""
        pins = coord.read_json(os.path.join(self.root, "promoted.json")) or {}
        coord.write_json(os.path.join(self.root, "promoted.json"),
                    {"active_seq": int(seq), "base_seq": pins.get("active_seq"),
                     "ts": time.time()})

    def pinned(self) -> set:
        pins = coord.read_json(os.path.join(self.root, "promoted.json")) or {}
        return {int(s) for s in (pins.get("active_seq"), pins.get("base_seq"))
                if s is not None}

    def gc(self, keep_last: int) -> List[int]:
        """Remove the published versions outside the newest ``keep_last``,
        never the pinned active and base versions: the manifest first
        (consumers discover through it), then the snapshot. Returns the
        removed seqs."""
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        seqs = self._seqs()
        keep = set(seqs[-keep_last:]) | self.pinned()
        removed = []
        for seq in seqs:
            if seq in keep:
                continue
            try:
                os.remove(self.manifest_path(seq))
            except OSError:
                continue  # already removed by a racing gc
            shutil.rmtree(self.version_dir(seq), ignore_errors=True)
            removed.append(seq)
        return removed


def publish_candidate(root: str, checkpoint: str, path: str,
                      keep_last: Optional[int] = None, **meta) -> Dict:
    """Publish into the channel at ``root`` (snapshot + manifest), then
    collect old versions when ``keep_last`` is given. Returns the
    manifest."""
    channel = CandidateChannel(root)
    manifest = channel.publish(checkpoint, path, **meta)
    if keep_last is not None:
        channel.gc(keep_last)
    return manifest
