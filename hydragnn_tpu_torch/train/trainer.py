"""The ``Trainer`` (port of the part of ``train/trainer.py`` one step
needs): ``__init__``, ``init_state``, ``put_batch``, ``train_step`` and
``eval_step``, on the model's device.

The compute precision is the JAX package's decision
(``models.create.resolve_precision``), kept in ``precision``; where it
resolves to bf16 the training step runs in bf16 mixed precision
(``steps.train_step(mixed=True)``), and evaluation stays float32. The
trainer owns the ``torch.Generator`` (on the model's device, seeded 0)
that each training step's stochastic layers draw from (GAT's attention
dropout), as the JAX trainer threads its ``rng``. Not
ported yet (``ROADMAP.md``, queue 1): epochs and ``train_validate_test``,
staging and scan paths, prefetch, the divergence guard's host side,
checkpoints, ``freeze_conv`` and meshes.
"""

import torch

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.create import resolve_precision
from hydragnn_tpu_torch.train import steps
from hydragnn_tpu_torch.train.common import TrainState, guard_enabled
from hydragnn_tpu_torch.train.optimizer import select_optimizer


class Trainer:
    def __init__(self, model, training_config: dict, mesh=None, freeze_conv: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet: see ROADMAP.md, queue 1, item 8"
            )
        self.model = model
        self.training_config = training_config
        self.freeze_conv = freeze_conv
        self.precision = resolve_precision(model, training_config)
        self.guarded = guard_enabled(training_config)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def init_state(self, example_batch: GraphBatch) -> TrainState:
        """The state to train from: the model as built (its weights drawn
        from ``create_model_config``'s seed) and a fresh optimizer.
        ``example_batch`` must carry one target per head."""
        if len(example_batch.targets) != self.model.num_heads:
            raise ValueError(
                f"the batch carries {len(example_batch.targets)} targets for "
                f"{self.model.num_heads} heads (collate with head_types/head_dims)"
            )
        optimizer = select_optimizer(
            self.training_config, self.model, freeze_conv=self.freeze_conv
        )
        return TrainState(model=self.model, optimizer=optimizer, step=0)

    def put_batch(self, batch: GraphBatch) -> GraphBatch:
        """The host batch on the model's device, in one transfer."""
        return batch.to(self.device)

    def train_step(self, state: TrainState, batch: GraphBatch):
        return steps.train_step(state, self.put_batch(batch), guarded=self.guarded,
                                mixed=self.precision["mixed"], generator=self.generator)

    def eval_step(self, state: TrainState, batch: GraphBatch):
        return steps.eval_step(state, self.put_batch(batch))
