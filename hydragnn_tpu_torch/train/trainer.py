"""The ``Trainer`` (port of ``train/trainer.py``'s host loop): ``__init__``,
``init_state``, ``place_state``, ``put_batch``, ``train_step``,
``eval_step``, ``train_epoch``, ``evaluate`` and, from
``train/predict.py``, ``predict``, on the model's device.

The compute precision is the JAX package's decision
(``models.create.resolve_precision``), kept in ``precision``; where it
resolves to bf16 the training step runs in bf16 mixed precision
(``steps.train_step(mixed=True)``), and evaluation stays float32. The
trainer owns the ``torch.Generator`` (on the model's device, seeded 0)
that each training step's stochastic layers draw from (GAT's attention
dropout), as the JAX trainer threads its ``rng``.

An epoch walks the loader on the host: each batch goes to the card in one
copy (``GraphBatch.to``) and takes one step; its metrics stay on the card
as one packed vector (``[loss * graphs, graphs, tasks * graphs]``,
:meth:`Trainer._acc_add`), and the epoch reads them back once at its end
and sums them in float64 (:meth:`Trainer._acc_read`), so that no step
waits for the host. ``predict`` keeps each batch's outputs on the card the
same way and reads them back once a pass.

Not ported yet, and refused where a config or the environment asks for
them: the staged (device-resident) epochs, ``fit_staged``,
``steps_per_dispatch > 1`` and device prefetch (``ROADMAP.md``, queue 1,
item 5); the divergence guard's host side; ``freeze_conv`` and the
optimizers other than Adam and AdamW (item 7); meshes (item 8).
"""

import os
import time

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.create import resolve_precision
from hydragnn_tpu_torch.train import steps
from hydragnn_tpu_torch.train.common import TrainState, guard_enabled
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.predict import PredictMixin


class Trainer(PredictMixin):
    def __init__(self, model, training_config: dict, mesh=None, freeze_conv: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet: see ROADMAP.md, queue 1, item 8"
            )
        for env, key in (("HYDRAGNN_STEPS_PER_DISPATCH", "steps_per_dispatch"),
                         ("HYDRAGNN_DEVICE_PREFETCH", "device_prefetch")):
            default = 1 if key == "steps_per_dispatch" else 0
            if int(os.getenv(env, str(training_config.get(key, default)))) > default:
                raise NotImplementedError(
                    f"{key} is not ported yet: see ROADMAP.md, queue 1, item 5")
        self.model = model
        self.training_config = training_config
        self.freeze_conv = freeze_conv
        self.precision = resolve_precision(model, training_config)
        self.guarded = guard_enabled(training_config)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.collate_s = 0.0  # host seconds making batches, summed over passes

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

    def place_state(self, state: TrainState) -> TrainState:
        """``state`` on the model's device: the module, and the
        optimizer's moments (a restored checkpoint may have put them
        elsewhere; Adam's step counts stay on the host)."""
        state.model.to(self.device)
        for per_param in state.optimizer.state.values():
            for key, value in per_param.items():
                if torch.is_tensor(value) and key != "step":
                    per_param[key] = value.to(self.device)
        return state

    def put_batch(self, batch: GraphBatch) -> GraphBatch:
        """The host batch on the model's device, in one transfer."""
        return batch.to(self.device)

    def train_step(self, state: TrainState, batch: GraphBatch):
        return steps.train_step(state, self.put_batch(batch), guarded=self.guarded,
                                mixed=self.precision["mixed"], generator=self.generator)

    def eval_step(self, state: TrainState, batch: GraphBatch):
        return steps.eval_step(state, self.put_batch(batch))

    # ---- epochs on the host loop ----------------------------------------

    @staticmethod
    def _acc_add(acc, metrics):
        """Append one batch's ``[loss * graphs, graphs, tasks * graphs]``,
        on the device: no readback."""
        g = metrics["num_graphs"].to(torch.float32)
        part = torch.cat([(metrics["loss"].float() * g).reshape(1), g.reshape(1),
                          metrics["tasks"].float() * g])
        acc = [] if acc is None else acc
        acc.append(part)
        return acc

    @staticmethod
    def _acc_read(acc):
        """``(mean loss, per-task means)``: the pass's one readback, summed
        in float64 on the host."""
        if not acc:
            return 0.0, np.zeros(0)
        a = torch.stack(acc).cpu().numpy().astype(np.float64).sum(axis=0)
        n = max(a[1], 1.0)
        return float(a[0] / n), a[2:] / n

    def _batches(self, loader):
        """The loader's batches, with the host seconds spent making them
        (sample fetch and collation) added to ``self.collate_s``."""
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.collate_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def train_epoch(self, state: TrainState, loader):
        """One pass of training steps over ``loader``; returns ``(state,
        mean loss, per-task mean losses)``, weighted by graphs."""
        if self.guarded:
            raise NotImplementedError(
                "the divergence guard's host side (skip and restore) is not ported yet: "
                "see ROADMAP.md, queue 1, item 7")
        acc = None
        for batch in self._batches(loader):
            state, metrics = self.train_step(state, batch)
            acc = self._acc_add(acc, metrics)
        loss, tasks = self._acc_read(acc)
        return state, loss, tasks

    def evaluate(self, state: TrainState, loader):
        """``(mean loss, per-task mean losses)`` of the model in eval mode
        over ``loader``."""
        acc = None
        for batch in self._batches(loader):
            acc = self._acc_add(acc, self.eval_step(state, batch))
        return self._acc_read(acc)
