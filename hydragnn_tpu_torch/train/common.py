"""Training state and the config knobs the step reads (port of
``train/common.py`` and ``train/guard.py::guard_enabled``)."""

import dataclasses
import os

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """The model (its parameters, and its BatchNorm statistics as
    buffers), its optimizer and the number of steps taken. PyTorch updates
    both in place, so a step returns the same object with ``step``
    advanced."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # what ``run_training`` records of the run: ``log_name``, ``history``
    # (per epoch: losses, walls, host collation seconds, lr), ``last_save``
    # (the last checkpoint's bytes and seconds) and ``wall_s``
    info: dict = dataclasses.field(default_factory=dict)


def _env_int(env_name: str, default: int) -> int:
    """An integer knob: the environment variable, when set, over
    ``default`` (the config's value), with the variable named on a bad
    value."""
    raw = os.getenv(env_name)
    if raw is None or raw.strip() == "":
        return int(default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{env_name} must be an integer, got {raw!r}") from None


def _nbatch(loader) -> int:
    """The batches a pass takes: the loader's, capped by
    ``HYDRAGNN_MAX_NUM_BATCH``."""
    n = len(loader)
    cap = os.getenv("HYDRAGNN_MAX_NUM_BATCH")
    return n if cap is None else min(n, int(cap))


def _is_oom(exc: BaseException) -> bool:
    """Memory exhaustion, host or device (``MemoryError``, or the
    allocator's out-of-memory error): what the staging fallbacks catch."""
    return isinstance(exc, MemoryError) or "out of memory" in str(exc).lower()


def _env_flag(env_name: str, config: dict, config_key: str, default=False) -> bool:
    """A boolean knob: the environment variable over the config key."""
    return bool(int(os.getenv(env_name, str(int(config.get(config_key, default))))))


def guard_enabled(training_config: dict) -> bool:
    """``Training.divergence_guard`` or ``HYDRAGNN_DIVERGENCE_GUARD=1``: the
    step then reports ``finite`` (the loss and every gradient finite). The
    host-side guard that acts on it is not ported yet (``ROADMAP.md``)."""
    return _env_flag("HYDRAGNN_DIVERGENCE_GUARD", training_config, "divergence_guard")
