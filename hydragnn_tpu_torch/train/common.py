"""Training state, the chunk's scheduler state, and the config knobs the
step reads (port of ``train/common.py`` and ``train/guard.py::guard_enabled``)."""

import dataclasses
import math
import os

import numpy as np

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
    # (per epoch: losses, walls, host collation seconds, lr; a chunked
    # run's epochs also their chunk's first epoch), ``last_save`` (the
    # last checkpoint's bytes and seconds), ``wall_s``, ``fit_readbacks``
    # (the chunks read back) and ``guard`` (the guard's counters, or None)
    info: dict = dataclasses.field(default_factory=dict)


# the JAX package's field order (``epoch_driver._FIT_SCHED_FIELDS``): the
# ``fit_sched`` section of a checkpoint's ``train_meta``
FIT_SCHED_FIELDS = ("plateau_best", "plateau_bad", "early_best", "early_count", "stopped",
                    "epoch", "best_val")
_SCHED_DTYPES = {"plateau_best": torch.float32, "plateau_bad": torch.int32,
                 "early_best": torch.float32, "early_count": torch.int32,
                 "stopped": torch.bool, "epoch": torch.int32, "best_val": torch.float32}


@dataclasses.dataclass
class SchedState:
    """The schedulers' state of a chunk of epochs (``Trainer.fit_staged``),
    as 0-d tensors on the device, JAX's ``SchedState``: the plateau's best
    and bad epochs, early stopping's best, count and flag, the epochs run
    and the best validation loss that the best state holds. A chunk's
    captured tail updates these tensors in place."""

    plateau_best: torch.Tensor  # f32
    plateau_bad: torch.Tensor  # i32
    early_best: torch.Tensor  # f32
    early_count: torch.Tensor  # i32
    stopped: torch.Tensor  # bool
    epoch: torch.Tensor  # i32
    best_val: torch.Tensor  # f32

    @classmethod
    def init(cls, device="cpu") -> "SchedState":
        """inf / 0 / inf / 0 / False / 0 / inf."""
        start = {"plateau_best": math.inf, "plateau_bad": 0, "early_best": math.inf,
                 "early_count": 0, "stopped": False, "epoch": 0, "best_val": math.inf}
        return cls(**{k: torch.tensor(start[k], dtype=_SCHED_DTYPES[k], device=device)
                      for k in FIT_SCHED_FIELDS})

    def tensors(self):
        return [getattr(self, k) for k in FIT_SCHED_FIELDS]

    def reset_(self) -> "SchedState":
        """Back to :meth:`init`'s values, in place (fills: no copy from
        the host)."""
        with torch.no_grad():
            for k in FIT_SCHED_FIELDS:
                t = getattr(self, k)
                t.fill_(math.inf if t.dtype == torch.float32 else 0)
        return self

    def load_(self, other: "SchedState") -> "SchedState":
        """``other``'s values into these tensors, in place."""
        with torch.no_grad():
            for k in FIT_SCHED_FIELDS:
                getattr(self, k).copy_(getattr(other, k))
        return self

    def to_host(self) -> dict:
        """The ``fit_sched`` section: numpy 0-d arrays of JAX's dtypes,
        by JAX's field names (a readback per field)."""
        return {k: np.asarray(getattr(self, k).cpu().numpy()) for k in FIT_SCHED_FIELDS}

    @classmethod
    def from_host(cls, section: dict, device="cpu") -> "SchedState":
        """A ``fit_sched`` section (either package's) on ``device``."""
        return cls(**{k: torch.tensor(np.asarray(section[k]).item(), dtype=_SCHED_DTYPES[k],
                                      device=device) for k in FIT_SCHED_FIELDS})


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
    step then reports ``finite`` (the loss and every gradient finite), and
    the trainer's ``DivergenceGuard`` (``train/guard.py``) acts on it."""
    return _env_flag("HYDRAGNN_DIVERGENCE_GUARD", training_config, "divergence_guard")
