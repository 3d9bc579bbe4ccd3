"""Training (port of ``hydragnn_tpu/train``).

``Trainer(model, training_config)`` -> ``init_state`` -> ``put_batch`` ->
``train_step`` (forward in training mode, loss, backward through the
kernels' backward rules, AdamW or Adam, BatchNorm running statistics; in
bf16 mixed precision where the JAX package's rule says so) ->
``eval_step``; ``train_epoch``, ``evaluate`` and ``predict`` on the host
loop. ``epoch_driver.train_validate_test`` runs the epochs with the
schedulers (``scheduler.py``) and checkpoints (``checkpoint.py``, the JAX
package's v2 format); ``driver.py`` is behind ``run_training`` and
``run_prediction``. Staging, scan paths and meshes are not ported yet
(``ROADMAP.md``, queue 1).
"""

from hydragnn_tpu_torch.train.common import TrainState, guard_enabled
from hydragnn_tpu_torch.train.optimizer import (
    get_learning_rate,
    select_optimizer,
    set_learning_rate,
)
from hydragnn_tpu_torch.train.steps import eval_step, train_step
from hydragnn_tpu_torch.train.trainer import Trainer

__all__ = [
    "TrainState",
    "Trainer",
    "eval_step",
    "get_learning_rate",
    "guard_enabled",
    "select_optimizer",
    "set_learning_rate",
    "train_step",
]
