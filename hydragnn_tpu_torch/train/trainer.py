"""The ``Trainer`` (port of ``train/trainer.py``'s host loop): ``__init__``,
``init_state``, ``place_state``, ``put_batch``, ``train_step``,
``eval_step``, ``train_epoch``, ``evaluate``, the staged (device-resident)
epochs ``stage_batches``, ``train_epoch_staged`` and ``evaluate_staged``,
and, from ``train/predict.py``, ``predict``, on the model's device.

Every step and forward runs through the trainer's programs
(``steps.CapturedSteps``, bound to the state's model and optimizer): on
the card one CUDA graph per shape key, captured at its first call and
replayed after (``train/capture.py``); on the CPU the same bodies eagerly.

The compute precision is the JAX package's decision
(``models.create.resolve_precision``), kept in ``precision``; where it
resolves to bf16 the training step runs in bf16 mixed precision
(``steps.train_body(mixed=True)``), and evaluation stays float32. The
trainer owns the ``torch.Generator`` (on the model's device, seeded 0)
that each training step's stochastic layers draw from (GAT's attention
dropout), as the JAX trainer threads its ``rng``; a captured step has it
registered with its graph.

A streaming epoch (JAX ``train_epoch``/``evaluate``) walks the loader's
dispatch plan (:meth:`Trainer._group_plan`): with ``steps_per_dispatch``
K > 1 (config or ``HYDRAGNN_STEPS_PER_DISPATCH``) every full K-group of
same-shape batches is stacked (``graph.stack_batches``) and taken by one
``train_multi``/``eval_multi`` replay, everything else by the single-step
program. With ``device_prefetch`` > 0 (config or
``HYDRAGNN_DEVICE_PREFETCH``) a background thread collates and stacks
ahead and copies each payload to the card from pinned memory on a side
stream, up to that many ahead; an event orders the copy before the replay
that reads it (:meth:`Trainer._prefetch_put`). Metrics stay on the card as
one packed vector per dispatch (``[loss * graphs, graphs, tasks *
graphs]``, :meth:`Trainer._acc_add`), read back once at the pass's end and
summed in float64 (:meth:`Trainer._acc_read`). ``HYDRAGNN_MAX_NUM_BATCH``
caps every pass, as in the JAX package.

A staged epoch (``device_resident_dataset``) is one replay per microbatch
of a stack kept on the card: no copy to it and no readback inside the
epoch; the microbatch order is drawn on the host from a ``torch.Generator``
and sent once, and the per-microbatch rows come back once.

:meth:`Trainer.fit_staged` (JAX ``fit_staged``) runs several epochs over
staged stacks with the plateau learning rate, early stopping and the best
state on the device (``steps.CapturedSteps.fit_dispatch``): every epoch's
order is drawn up front and sent in one copy, the epochs' replays are
queued with no host sync (:meth:`Trainer.fit_dispatch`), and the series
comes back in one readback (:meth:`Trainer.fit_read`).

With the divergence guard (``Training.divergence_guard``,
``train/guard.py``) a streaming epoch takes one step a dispatch, copies
the state before each step into the guard's buffers, reads the step's
``finite`` flag back, and on a bad step puts the copy back in place and
leaves the batch out of the epoch's mean. The fault hooks
(``utils/faults.py``: ``nan_at_step`` poisons the batch's ``x``,
``slow_step``, ``kill_at_step``) sit where the JAX trainer has them, on
the host step count ``_host_step``; a chunk calls ``kill_at_step`` for
each step it ran, after its readback.

With a telemetry run active (``obs/runtime.py``) a pass times its
training replays with CUDA events (``ProgramSet.timer``, resolved at the
pass's readback), counts its dispatches, ticks the trace capture (a
staged epoch at its end) and reports the time it waited on its data
(tracer regions ``train``, ``train_step``, ``dataload``); ``stage_batches``
is a ``staged`` event.

Every host batch ships in the compact wire format unless
``compact_transfer`` (or ``HYDRAGNN_COMPACT_TRANSFER``) is off
(``train/transfer.py``: int16 ids, a position placeholder for a model
that reads none), undone inside the programs. ``freeze_conv`` freezes the
encoder (``train/optimizer.py``).

Not ported yet, and refused where a config asks for them: meshes
(``ROADMAP.md``, queue 1, item 8).
"""

import dataclasses
import os
import time

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import GraphBatch, stack_batches
from hydragnn_tpu_torch.models.create import resolve_precision
from hydragnn_tpu_torch.obs import runtime as obs
from hydragnn_tpu_torch.train.capture import copy_state, state_tensors
from hydragnn_tpu_torch.train.common import (
    FIT_SCHED_FIELDS,
    SchedState,
    TrainState,
    _env_flag,
    _env_int,
    _nbatch,
    guard_enabled,
)
from hydragnn_tpu_torch.train.guard import DivergenceGuard
from hydragnn_tpu_torch.train.optimizer import ensure_optimizer_state, select_optimizer
from hydragnn_tpu_torch.train.predict import PredictMixin
from hydragnn_tpu_torch.train.steps import CapturedSteps, Staged
from hydragnn_tpu_torch.train.transfer import compact_for_transfer, needs_pos
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils import tracer as tr


class Trainer(PredictMixin):
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
        self.guard = DivergenceGuard(training_config) if self.guarded else None
        self._host_step = 0  # optimizer steps dispatched: the fault hooks' clock
        self.steps_per_dispatch = _env_int("HYDRAGNN_STEPS_PER_DISPATCH",
                                           int(training_config.get("steps_per_dispatch", 1)))
        self.device_prefetch = _env_int("HYDRAGNN_DEVICE_PREFETCH",
                                        int(training_config.get("device_prefetch", 0)))
        self.compact_transfer = _env_flag("HYDRAGNN_COMPACT_TRANSFER", training_config,
                                          "compact_transfer", default=True)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        # the staged epochs' microbatch order, drawn on the host
        self.perm_generator = torch.Generator().manual_seed(0)
        self.collate_s = 0.0  # host seconds making batches, summed over passes
        self._steps = None
        self._copy_stream = None
        self._fit_pending = None
        self._fit_timer = None
        self.fit_readbacks = 0  # chunks read back (one readback each)

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
        elsewhere) and, for an optimizer built for capture, its step
        counts (else they stay on the host). Frees the captured graphs:
        they hold the tensors that a move replaces."""
        self.release()
        state.model.to(self.device)
        capturable = state.optimizer.defaults.get("capturable", False)
        for per_param in state.optimizer.state.values():
            for key, value in per_param.items():
                if torch.is_tensor(value) and (key != "step" or capturable):
                    per_param[key] = value.to(self.device)
        return state

    def programs(self, state: TrainState) -> CapturedSteps:
        """The captured programs over ``state``'s model and optimizer (new
        ones, the old released, when the state holds others)."""
        steps = self._steps
        if steps is None or steps.model is not state.model or steps.optimizer is not state.optimizer:
            self.release()
            steps = self._steps = CapturedSteps(self, state)
        return steps

    def release(self):
        """Free every captured graph of this trainer."""
        if self._steps is not None:
            self._steps.release()
            self._steps = None

    def compact(self, batch: GraphBatch) -> GraphBatch:
        """A host batch in the wire format (``compact_transfer``); a
        device batch as it is."""
        if not self.compact_transfer or batch.x.device.type != "cpu":
            return batch
        return compact_for_transfer(batch, needs_pos(self.model))

    def put_batch(self, batch: GraphBatch) -> GraphBatch:
        """The host batch on the model's device, in one transfer."""
        return self.compact(batch).to(self.device)

    def _feed(self, batch: GraphBatch) -> GraphBatch:
        # on the card a program copies a host batch into its static input in
        # one transfer; on the CPU the body takes the batch as it is
        return self.compact(batch) if self.device.type == "cuda" else self.put_batch(batch)

    def train_step(self, state: TrainState, batch: GraphBatch):
        metrics = self.programs(state).train_step(self._feed(batch))
        state.step += 1
        return state, metrics

    def eval_step(self, state: TrainState, batch: GraphBatch):
        return self.programs(state).eval_step(self._feed(batch))

    def prepare_step(self, state: TrainState, batch: GraphBatch):
        """Capture the training step for ``batch``'s shape without taking
        it (the state is as before): a timed loop then only replays."""
        self.programs(state).train_step(self._feed(batch), run=False)

    def train_multi(self, state: TrainState, stacked: GraphBatch):
        """K steps over a stacked group (``graph.stack_batches``) in one
        replay; metrics stacked ``[K, ...]``."""
        metrics = self.programs(state).train_multi(self._feed(stacked))
        state.step += int(stacked.x.shape[0])
        return state, metrics

    def eval_multi(self, state: TrainState, stacked: GraphBatch):
        return self.programs(state).eval_multi(self._feed(stacked))

    # ---- epochs on the host loop ----------------------------------------

    @staticmethod
    def _acc_add(acc, metrics, multi=False):
        """Append one dispatch's ``[loss * graphs, graphs, tasks * graphs]``
        (summed over the group's K steps with ``multi``), on the device:
        no readback."""
        g = metrics["num_graphs"].to(torch.float32)
        loss, tasks = metrics["loss"].float(), metrics["tasks"].float()
        if multi:
            part = torch.cat([(loss @ g).reshape(1), g.sum().reshape(1), tasks.T @ g])
        else:
            part = torch.cat([(loss * g).reshape(1), g.reshape(1), tasks * g])
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

    def _batches(self, loader, nbatch=None):
        """The loader's batches (at most ``nbatch``), with the host
        seconds spent making them (sample fetch and collation) added to
        ``self.collate_s``."""
        it = iter(loader)
        for _ in range(len(loader) if nbatch is None else nbatch):
            t0 = time.perf_counter()
            batch = next(it, None)
            self.collate_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    @staticmethod
    def _group_plan(batches, K):
        """The dispatch plan (JAX ``Trainer._group_plan``): ``K``-long
        groups of same-shape batches (the multi-step program) and single
        batches (everything else). Only full groups take the multi-step
        program, so that no partial group captures a graph of its own; a
        shape change flushes the open group as singles."""
        pending = []
        for batch in batches:
            if K == 1:
                yield [batch]
                continue
            if pending and batch.shape_key() != pending[0].shape_key():
                for b in pending:
                    yield [b]
                pending = []
            pending.append(batch)
            if len(pending) == K:
                yield pending
                pending = []
        for b in pending:  # a trailing partial group: the single-step program
            yield [b]

    def _put_group(self, group):
        """A group as ``(payload, count)``: one batch, or K stacked."""
        if len(group) > 1:
            return self.compact(stack_batches(group)), len(group)
        return self.compact(group[0]), 1

    def _prefetch_put(self, plan, depth):
        """``(payload, count)`` per dispatch of ``plan``. With ``depth`` >
        0 a background thread stacks each group and copies it to the card
        from pinned memory on a side stream, up to ``depth`` ahead (the
        shared ``data.loaders.prefetch_iter``); the consumer's stream waits
        on the copy's event, and the payload's memory is marked in use by
        that stream until the replay that reads it. ``depth <= 0``: the
        program copies each host payload itself."""
        if depth <= 0 or self.device.type != "cuda":
            for group in plan:
                yield self._put_group(group)
            return
        from hydragnn_tpu_torch.data.loaders import prefetch_iter

        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy_stream = self._copy_stream

        def put(group):
            payload, count = self._put_group(group)
            with torch.cuda.stream(copy_stream):
                payload = payload.to(self.device)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return payload, count, done

        compute = torch.cuda.current_stream(self.device)
        for payload, count, done in prefetch_iter(plan, depth, fn=put,
                                                  name="hydragnn-torch-device-prefetch"):
            compute.wait_event(done)
            for t in payload.leaves()[1]:
                t.record_stream(compute)
            yield payload, count

    def _dispatches(self, loader, K):
        """``(payload, count)`` per dispatch of a pass; the time the loop
        waits for each (collation, stacking, the prefetch queue) is the
        ``dataload`` tracer region and the goodput ledger's data stall,
        unless the loader reports its own waits (the streaming loader's
        ``stream_epoch_stats``), which must not count twice."""
        it = self._prefetch_put(self._group_plan(self._batches(loader, _nbatch(loader)), K),
                                self.device_prefetch)
        ledger_waits = not getattr(loader, "reports_stream_stats", False)
        while True:
            tr.start("dataload")
            t0 = time.perf_counter()
            try:
                item = next(it, None)
            finally:
                if ledger_waits:
                    obs.data_wait(time.perf_counter() - t0)
                tr.stop("dataload")
            if item is None:
                return
            yield item

    def train_epoch(self, state: TrainState, loader):
        """One pass of training steps over ``loader``; returns ``(state,
        mean loss, per-task mean losses)``, weighted by graphs. Guarded,
        one step a dispatch, each checked (the module's docstring)."""
        guard = self.guard
        # the guard must isolate one step to skip it: guarded runs take K = 1
        K = 1 if guard is not None else max(1, self.steps_per_dispatch)
        if guard is not None and guard.last_good is None:
            guard.commit(state)
        acc = None
        tr.start("train")
        # resolved once a pass: with no run active the step path pays one read
        telemetry = obs.active()
        timer = self._timed(state, telemetry)
        for payload, count in self._dispatches(loader, K):
            tr.start("train_step")
            if count > 1:
                for s in range(self._host_step, self._host_step + count):
                    faults.slow_step(s)
                state, metrics = self.train_multi(state, payload)
                if telemetry is not None:
                    telemetry.on_dispatch(count)
                tr.stop("train_step")
                acc = self._acc_add(acc, metrics, multi=True)
                first = self._host_step
                self._host_step += count
                for s in range(first, self._host_step):
                    faults.kill_at_step(s)
                continue
            if faults.nan_at_step(self._host_step):
                payload = dataclasses.replace(payload, x=payload.x * float("nan"))
            prev = None if guard is None else guard.snapshot(state)
            faults.slow_step(self._host_step)
            state, metrics = self.train_step(state, payload)
            if telemetry is not None:
                telemetry.on_dispatch()
            tr.stop("train_step")
            # the guard's documented cost: one scalar read back a step
            if guard is not None and not bool(metrics["finite"]):
                # a poisoned update: put the copy back (or last-good, with
                # the rate lowered, after a streak); its metrics stay out
                state = guard.on_bad_step(state, prev)
            else:
                if guard is not None:
                    guard.bad_streak = 0
                acc = self._acc_add(acc, metrics)
            faults.kill_at_step(self._host_step)
            self._host_step += 1
        loss, tasks = self._acc_read(acc)  # the pass's one readback
        if timer is not None:
            self._steps.timer = None
            timer.flush()
        tr.stop("train")
        return state, loss, tasks

    def _timed(self, state, telemetry):
        """With a run active, a ``StepTimer`` on this pass's programs: each
        training replay is marked (``capture.Program``), and the pass's
        readback resolves the marks (:meth:`StepTimer.flush`)."""
        if telemetry is None:
            if self._steps is not None:
                self._steps.timer = None  # a pass that raised may have left one
            return None
        timer = telemetry.step_timer(self.device)
        self.programs(state).timer = timer
        return timer

    def evaluate(self, state: TrainState, loader):
        """``(mean loss, per-task mean losses)`` of the model in eval mode
        over ``loader``, with the same multi-step dispatch as training."""
        acc = None
        for payload, count in self._dispatches(loader, max(1, self.steps_per_dispatch)):
            if count > 1:
                acc = self._acc_add(acc, self.eval_multi(state, payload), multi=True)
            else:
                acc = self._acc_add(acc, self.eval_step(state, payload))
        return self._acc_read(acc)

    # ---- the device-resident dataset --------------------------------------

    def stage_batches(self, batches) -> Staged:
        """Stack same-shape collated batches and keep them on the card
        (JAX ``stage_batches``); raises ``ValueError`` on ragged batches."""
        batches = list(batches)
        obs.emit("staged", num_batches=len(batches))
        return Staged(self.put_batch(stack_batches(batches)), self.model.num_heads)

    def restage(self, staged: Staged, batches) -> Staged:
        """Stage ``batches`` into ``staged``'s own tensors, in place (JAX
        ``restage_per_chunk``): the programs bound to the stack keep their
        graphs and no second stack is held. Raises ``ValueError`` when the
        new stack's shapes differ from the staged one's."""
        new = self.compact(stack_batches(batches))
        if new.shape_key() != staged.stack.shape_key():
            raise ValueError("restage: the batches' shapes differ from the staged stack's")
        with torch.no_grad():
            for dst, src in zip(staged.stack.leaves()[1], new.leaves()[1]):
                dst.copy_(src)
        return staged

    @staticmethod
    def _rows_mean(rows):
        """``(mean loss, per-task means)`` of result rows ``[loss,
        graphs, tasks...]``, weighted by graphs, in float64."""
        rows = rows.cpu().numpy().astype(np.float64)  # the pass's one readback
        g = rows[:, 1]
        n = max(float(g.sum()), 1.0)
        return float(rows[:, 0] @ g) / n, (rows[:, 2:] * g[:, None]).sum(0) / n

    @staticmethod
    def _staged_count(staged: Staged) -> int:
        cap = os.getenv("HYDRAGNN_MAX_NUM_BATCH")
        return staged.nb if cap is None else min(staged.nb, int(cap))

    def train_epoch_staged(self, state: TrainState, staged: Staged, perm=None):
        """One epoch over a staged stack, one replay a microbatch (JAX
        ``train_epoch_staged``), in a shuffled order drawn from
        ``self.perm_generator`` (or ``perm``): the microbatches' order
        changes, their samples were fixed at staging. Returns ``(state,
        mean loss, per-task mean losses)``."""
        n_use = self._staged_count(staged)
        if perm is None:
            perm = torch.randperm(staged.nb, generator=self.perm_generator)[:n_use]
        perm = torch.as_tensor(perm, dtype=torch.int64)
        n_use = perm.shape[0]
        staged.perm[:n_use].copy_(perm, non_blocking=False)
        tr.start("train")
        telemetry = obs.active()
        timer = self._timed(state, telemetry)
        self.programs(state).epoch_scan(staged, n_use)
        if timer is not None:
            self._steps.timer = None
            telemetry.on_dispatch(n_use, tick=False)
        state.step += n_use
        loss, tasks = self._rows_mean(staged.rows[:n_use])  # the epoch's one readback
        if timer is not None:
            timer.flush()
        tr.stop("train")
        # one dispatch an epoch: the trace capture ticks per staged epoch
        obs.dispatch_boundary()
        return state, loss, tasks

    def evaluate_staged(self, state: TrainState, staged: Staged):
        """``(mean loss, per-task means)`` over a staged stack, one replay
        a microbatch and one readback (JAX ``evaluate_staged``)."""
        n = self._staged_count(staged)
        self.programs(state).eval_epoch(staged, n)
        return self._rows_mean(staged.rows[:n])

    # ---- whole-run chunks (JAX fit_staged) -----------------------------------

    def fit_staged(self, state: TrainState, staged_train: Staged, num_epoch: int,
                   staged_val: Staged = None, staged_test: Staged = None, shuffle: bool = True,
                   sched: SchedState = None, best_state: TrainState = None, pad_to: int = None):
        """``num_epoch`` epochs over staged stacks with the plateau rate,
        early stopping, the best state and the validation and test passes
        on the device, and one readback (JAX ``fit_staged``): the queueing
        of :meth:`fit_dispatch`, then :meth:`fit_read`. ``sched`` and
        ``best_state`` carry a run across chunks; ``pad_to`` pads the
        chunk with inert epochs, so that a short last chunk replays the
        programs the others captured. ``staged_val``/``staged_test`` None:
        the training loss stands for them (``HYDRAGNN_VALTEST=0``).

        Returns ``(state, best_state, sched, series)``; ``series`` holds
        numpy arrays over the epochs, ``train_loss``, ``val_loss``,
        ``test_loss``, ``lr``, ``stopped`` and ``train_tasks [E, T]``
        (NaN rows: epochs skipped after the stop), and ``sched``, the
        ``fit_sched`` section after the chunk. The state is updated in
        place; ``best_state`` and ``sched`` are the trainer's own buffers,
        which the next chunk updates in place."""
        state, best_state, sched = self.fit_dispatch(
            state, staged_train, num_epoch, staged_val, staged_test, shuffle, sched,
            best_state, pad_to)
        return state, best_state, sched, self.fit_read(state)

    def fit_dispatch(self, state: TrainState, staged_train: Staged, num_epoch: int,
                     staged_val: Staged = None, staged_test: Staged = None,
                     shuffle: bool = True, sched: SchedState = None,
                     best_state: TrainState = None, pad_to: int = None):
        """Queue a chunk (:meth:`fit_staged`'s arguments) with no host sync
        inside it: every epoch's order drawn from ``perm_generator`` (or in
        order) and sent in one copy, then ``max(num_epoch, pad_to)`` epochs
        of replays. Returns ``(state, best_state, sched)``; read the series
        with :meth:`fit_read`."""
        n_use = self._staged_count(staged_train)
        n_sched = max(int(num_epoch), int(pad_to or 0))
        if shuffle:
            perms = torch.stack([torch.randperm(staged_train.nb, generator=self.perm_generator)
                                 [:n_use] for _ in range(n_sched)])
        else:
            perms = torch.arange(n_use, dtype=torch.int64).repeat(n_sched, 1)
        if self.device.type == "cuda":
            perms = perms.pin_memory()
        steps = self.programs(state)
        fit = steps.fit_buffers(state)
        if sched is None:
            fit.sched.reset_()
            fit.epochs_done = 0
        elif sched is not fit.sched:
            fit.sched.load_(sched)
            fit.epochs_done = int(sched.epoch)
        if best_state is None:
            copy_state(fit.best, fit.state)
            fit.best_state.step = state.step
        elif best_state is not fit.best_state:
            ensure_optimizer_state(best_state.optimizer)
            copy_state(fit.best, state_tensors(best_state.model, best_state.optimizer))
            fit.best_state.step = best_state.step
        val_n = None if staged_val is None else self._staged_count(staged_val)
        test_n = None if staged_test is None else self._staged_count(staged_test)
        self._fit_timer = self._timed(state, obs.active())
        steps.fit_dispatch(staged_train, n_use, perms, num_epoch, staged_val, val_n, staged_test,
                           test_n)
        steps.timer = None
        # the pinned order stays referenced until the readback
        self._fit_pending = (perms, int(num_epoch), n_use, staged_train.rows.shape[1] - 2)
        return state, fit.best_state, fit.sched

    def fit_read(self, state: TrainState) -> dict:
        """The queued chunk's series: its one readback (see
        :meth:`fit_staged`). Advances ``state.step`` and the host step
        count by the steps the chunk ran, and calls ``kill_at_step`` for
        each."""
        _, num_epoch, n_use, num_tasks = self._fit_pending
        self._fit_pending = None
        fit = self._steps.fit
        # the chunk's one readback (owned: on the CPU .cpu() is the buffer itself)
        host = fit.series.cpu().numpy().copy()
        self.fit_readbacks += 1
        rows, tail = host[:num_epoch], host[-1]
        done = int(tail[5])
        ran = (done - fit.epochs_done) * n_use
        timer, self._fit_timer = self._fit_timer, None
        if timer is not None:
            # the steps that trained (not the inert epochs' after a stop)
            timer.flush(keep=ran)
            timer.telemetry.on_dispatch(ran, tick=False)
        fit.epochs_done = done
        fit.best_state.step = int(tail[7])
        state.step += ran
        first = self._host_step
        self._host_step += ran
        for s in range(first, self._host_step):
            faults.kill_at_step(s)
        dtypes = (np.float32, np.int32, np.float32, np.int32, np.bool_, np.int32, np.float32)
        return {
            "train_loss": rows[:, 0], "val_loss": rows[:, 1], "test_loss": rows[:, 2],
            "lr": rows[:, 3], "stopped": rows[:, 4] > 0.5,
            "train_tasks": rows[:, 5 : 5 + num_tasks],
            "sched": {k: np.asarray(v, dt) for k, v, dt in zip(FIT_SCHED_FIELDS, tail, dtypes)},
        }
