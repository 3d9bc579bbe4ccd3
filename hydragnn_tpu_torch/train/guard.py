"""The divergence guard (port of ``train/guard.py``): survive NaN and Inf
steps instead of training on them.

- A guarded step reports ``finite`` (the loss and every gradient finite,
  ``steps.train_body``); the trainer reads that one scalar back after
  each step, the guard's documented cost.
- A non-finite step is skipped: the state copied before it is put back,
  so the poisoned update never lands, and its metrics stay out of the
  epoch's mean.
- After ``max_bad_steps`` bad steps in a row the guard restores the
  last-good state (committed at each finite epoch, or chunk, boundary)
  with the learning rate halved, and keeps halving on each later restore.
- Restores are bounded (``max_restores``); past the bound it raises
  ``RuntimeError`` with the history.

Every copy is in place, into buffers the guard allocates once: the
trainer's captured programs read the state's own tensors
(``capture.state_tensors``), so a restore that rebound them would leave
the graphs stepping stale memory. A streaming guarded run takes one step
a dispatch (``steps_per_dispatch`` 1), so that a bad step can be isolated.

Knobs (the environment over the config): ``HYDRAGNN_GUARD_MAX_BAD_STEPS``
/ ``guard_max_bad_steps`` (3), ``HYDRAGNN_GUARD_MAX_RESTORES`` /
``guard_max_restores`` (2), and ``guard_lr_factor`` (0.5). Each skip is a
``guard_skip`` event and each restore a ``guard_restore`` event with its
seconds, the goodput ledger's guard recovery (``obs/runtime.py``); the
JAX guard's elastic lease counter waits for elastic runs (``ROADMAP.md``,
queue 1, item 8). The counters stay on the guard (``skipped``,
``restores``).
"""

import os
import time

from hydragnn_tpu_torch.obs import runtime as obs

from hydragnn_tpu_torch.train.capture import copy_state, state_tensors
from hydragnn_tpu_torch.train.optimizer import (
    ensure_optimizer_state,
    get_learning_rate,
    set_learning_rate,
)


class _Copy:
    """A fixed copy of a state's tensors and its host step count."""

    def __init__(self, tensors):
        self.tensors = [t.detach().clone() for t in tensors]
        self.step = 0

    def take(self, state):
        copy_state(self.tensors, _tensors(state))
        self.step = state.step
        return self

    def put(self, state):
        copy_state(_tensors(state), self.tensors)
        state.step = self.step
        return state


def _tensors(state):
    ensure_optimizer_state(state.optimizer)
    return state_tensors(state.model, state.optimizer)


class DivergenceGuard:
    """The host-side guard of a training run (see the module's docstring)."""

    def __init__(self, training_config: dict):
        self.max_bad_steps = int(os.getenv(
            "HYDRAGNN_GUARD_MAX_BAD_STEPS", str(training_config.get("guard_max_bad_steps", 3))))
        self.max_restores = int(os.getenv(
            "HYDRAGNN_GUARD_MAX_RESTORES", str(training_config.get("guard_max_restores", 2))))
        self.lr_factor = float(training_config.get("guard_lr_factor", 0.5))
        self.bad_streak = 0
        self.skipped = 0
        self.restores = 0
        self.last_good = None
        self._prev = None

    def snapshot(self, state):
        """Copy ``state`` before a step, into the guard's pre-step buffers:
        what :meth:`on_bad_step` puts back when this step goes bad."""
        if self._prev is None:
            self._prev = _Copy(_tensors(state))
        return self._prev.take(state)

    def commit(self, state):
        """Mark ``state`` last-good (at a finite epoch or chunk boundary)
        and reset the bad streak: surviving an epoch means the earlier bad
        steps were transient."""
        if self.last_good is None:
            self.last_good = _Copy(_tensors(state))
        self.last_good.take(state)
        self.bad_streak = 0

    def on_bad_step(self, state, prev):
        """A step came back non-finite: put ``prev`` (:meth:`snapshot`'s
        copy) back into ``state``, or after ``max_bad_steps`` bad steps in
        a row the last-good state with the rate lowered. Returns
        ``state``; raises ``RuntimeError`` past the restore bound."""
        self.bad_streak += 1
        self.skipped += 1
        obs.guard_skip("step", self.skipped, streak=self.bad_streak)
        if self.bad_streak < self.max_bad_steps or self.last_good is None:
            return prev.put(state)
        return self._restore(state)

    def on_bad_epoch(self, state):
        """The guard of a staged epoch or a chunk (no view of single
        steps): a non-finite epoch loss restores last-good with the rate
        lowered. With nothing committed yet ``state`` stays, but the
        epoch still counts against the restore bound."""
        self.skipped += 1
        obs.guard_skip("epoch", self.skipped)
        if self.last_good is None:
            self.restores += 1
            if self.restores > self.max_restores:
                raise RuntimeError(
                    "divergence guard: training produced non-finite "
                    f"losses for {self.restores} epochs with no finite "
                    "epoch ever committed — the run is broken from the "
                    "start; inspect the data/LR")
            return state
        return self._restore(state)

    def _restore(self, state):
        self.restores += 1
        if self.restores > self.max_restores:
            raise RuntimeError(
                f"divergence guard: {self.restores - 1} last-good restores "
                f"did not stabilize training ({self.skipped} non-finite "
                "steps skipped) — refusing to keep spending the allocation; "
                "inspect the data/LR, or raise guard_max_restores")
        self.bad_streak = 0
        t0 = time.perf_counter()
        self.last_good.put(state)
        lr = get_learning_rate(state.optimizer) * self.lr_factor
        set_learning_rate(state.optimizer, lr)
        # keep halving across successive restores, not oscillating back up
        self.last_good.take(state)
        obs.guard_restore(self.restores, lr, seconds=time.perf_counter() - t0)
        return state

    def state_dict(self) -> dict:
        """The counters only (the copies are device state and form again on
        resume): a resumed run keeps its restore budget."""
        return {"skipped": int(self.skipped), "restores": int(self.restores)}

    def load_state_dict(self, sd: dict) -> None:
        self.skipped = int(sd.get("skipped", 0))
        self.restores = int(sd.get("restores", 0))
