"""Training (port of ``hydragnn_tpu/train``).

``Trainer(model, training_config)`` -> ``init_state`` -> ``put_batch`` ->
``train_step`` (forward in training mode, loss, backward through the
kernels' backward rules, AdamW or Adam, BatchNorm running statistics; in
bf16 mixed precision where the JAX package's rule says so) ->
``eval_step``; ``train_epoch`` and ``evaluate`` (with
``steps_per_dispatch`` and ``device_prefetch``, and the divergence guard,
``guard.py``), the staged epochs (``stage_batches``,
``train_epoch_staged``, ``evaluate_staged``), whole-run chunks
(``fit_staged``, with ``SchedState`` on the device) and ``predict``.
Every step and forward is a program of ``steps.CapturedSteps``: on the
card a CUDA graph per shape key (``capture.py``), on the CPU the body
itself. ``epoch_driver.train_validate_test`` runs the epochs, or chunks
of them, with the schedulers (``scheduler.py``) and checkpoints
(``checkpoint.py``, the JAX package's v2 format); ``driver.py`` is behind
``run_training`` and ``run_prediction``. Meshes are not ported yet
(``ROADMAP.md``, queue 1).
"""

from hydragnn_tpu_torch.train.capture import capture_counts, reset_capture_counts
from hydragnn_tpu_torch.train.common import SchedState, TrainState, guard_enabled
from hydragnn_tpu_torch.train.guard import DivergenceGuard
from hydragnn_tpu_torch.train.optimizer import (
    get_learning_rate,
    select_optimizer,
    set_learning_rate,
)
from hydragnn_tpu_torch.train.steps import CapturedSteps, eval_step, train_step
from hydragnn_tpu_torch.train.trainer import Trainer

__all__ = [
    "CapturedSteps",
    "DivergenceGuard",
    "SchedState",
    "capture_counts",
    "reset_capture_counts",
    "TrainState",
    "Trainer",
    "eval_step",
    "get_learning_rate",
    "guard_enabled",
    "select_optimizer",
    "set_learning_rate",
    "train_step",
]
