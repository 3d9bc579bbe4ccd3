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


def _env_flag(env_name: str, config: dict, config_key: str, default=False) -> bool:
    """A boolean knob: the environment variable over the config key."""
    return bool(int(os.getenv(env_name, str(int(config.get(config_key, default))))))


def guard_enabled(training_config: dict) -> bool:
    """``Training.divergence_guard`` or ``HYDRAGNN_DIVERGENCE_GUARD=1``: the
    step then reports ``finite`` (the loss and every gradient finite). The
    host-side guard that acts on it is not ported yet (``ROADMAP.md``)."""
    return _env_flag("HYDRAGNN_DIVERGENCE_GUARD", training_config, "divergence_guard")
