"""One training step and one evaluation step (port of
``train/steps.py::train_step``/``eval_step``).

:func:`train_step` is the JAX package's fused step taken eagerly: forward
in training mode (the BatchNorm layers update their running statistics),
the weighted multi-task loss, backward through the kernels' backward rules
(``ops``: ``*_vjp``), one optimizer update. Metrics stay on the device:
``loss``, ``tasks`` and ``num_graphs``, and with ``guarded`` the
``finite`` flag (the loss and every gradient finite). The three phases run
inside ``torch.profiler.record_function`` ranges named
``train_step.forward``, ``train_step.backward`` and
``train_step.optimizer``, so that a profile can split the step. A
stochastic layer (GAT's attention dropout) draws from the step's
``generator``, as the JAX step draws from its ``rng``.

With ``mixed`` (bf16 mixed precision, ``steps.py:131-170`` of the JAX
package) the batch's ``x`` and ``edge_attr`` go to bf16 (``pos`` stays
float32), and the forward and backward run on a bf16 copy of every float32
parameter (``torch.func.functional_call`` with the parameters only: the
BatchNorm statistics stay the module's own float32 buffers and update in
place). The loss is float32; the gradients land on the float32 master
parameters, which the optimizer updates. :func:`eval_step` computes in
float32, as the JAX package's does.

:class:`CapturedSteps` is the counterpart of the JAX package's
``CompiledSteps`` (``build_steps``): the programs ``train_step``,
``eval_step``, ``train_multi`` and ``eval_multi`` (K bodies over a stacked
group, the ``lax.scan`` of ``multi_train_step``/``eval_multi``),
``epoch_scan``, ``eval_epoch`` and ``predict_scan`` (one microbatch of a
staged stack per replay, picked by a device index: ``perm[pos]`` or
``pos``, the counterpart of ``_microbatch``), each one captured graph per
shape key on the card (``train/capture.py``) and the body itself on the
CPU.

A chunk of epochs (JAX ``fit_scan``, ``CapturedSteps.fit_dispatch``) runs
per epoch: ``fit_head`` (the state copied into the epoch-start snapshot,
the epoch's microbatch order into ``perm``), the epoch's ``epoch_scan``
replays, the ``eval_epoch`` replays of the validation and test stacks,
and ``fit_tail``: from the result rows it computes the losses weighted by
graphs, ``ReduceLROnPlateau`` (writing the rate tensor in place),
``EarlyStopping``, the warmup-gated best state and the epoch's series
row, all in float32 on the device. An epoch after the stop, or a padded
one (``pad_to``), still runs its replays, and the tail then puts the
snapshot back (``state = where(run, state, snapshot)``, in place): JAX
skips such an epoch with ``lax.cond``, and the port leaves the state and
``SchedState`` unchanged and writes JAX's NaN row, with no conditional
node in the graph. The chunk's buffers (:class:`FitBuffers`) are fixed:
every program reads and writes them in place.

Every program is instrumented (``obs/introspect.instrument``): while a
telemetry run is active each novel shape key leaves one ``compile`` record
(its FLOPs, bytes and capture seconds); the precision goes to the goodput
ledger (``ledger.note_precision``), whose MFU it picks the peak for.

With ``HYDRAGNN_NAN_SENTINEL=1`` the ``train_step`` and ``train_multi``
programs are wrapped by ``analysis.guards.nan_sentinel`` over
:func:`sentinel_tree`: a readback of the metrics and the state after each
replay, outside the graph.
"""

import copy
import dataclasses
import os

import torch
from torch.profiler import record_function

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.obs import introspect, ledger
from hydragnn_tpu_torch.train.capture import ProgramSet, copy_state, rate_tensors, state_tensors
from hydragnn_tpu_torch.train.common import SchedState, TrainState
from hydragnn_tpu_torch.train.optimizer import ensure_optimizer_state
from hydragnn_tpu_torch.train.transfer import decompact


def forward_bf16(model, batch: GraphBatch, generator=None):
    """The model's forward in bf16 mixed precision: ``x`` and
    ``edge_attr`` in bf16, every float32 parameter cast to bf16 (a cast
    autograd records, so gradients reach the float32 parameter), the
    module's own buffers."""
    batch = dataclasses.replace(
        batch,
        x=batch.x.to(torch.bfloat16),
        edge_attr=None if batch.edge_attr is None else batch.edge_attr.to(torch.bfloat16),
    )
    params = {
        name: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
        for name, p in model.named_parameters()
    }
    return torch.func.functional_call(model, params, (batch,), {"generator": generator})


def train_body(model, optimizer, batch: GraphBatch, guarded: bool = False,
               mixed: bool = False, generator=None):
    """One optimizer step of ``model`` on ``batch`` (already on the
    model's device), in bf16 mixed precision with ``mixed``; ``generator``
    (on the model's device) feeds a stochastic layer. Returns the metrics;
    the model and optimizer are updated in place."""
    batch = decompact(batch)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with record_function("train_step.forward"):
        outputs = forward_bf16(model, batch, generator) if mixed else model(batch, generator)
        loss, tasks = model.loss(outputs, batch)
    with record_function("train_step.backward"):
        loss.backward()
    metrics = {
        "loss": loss.detach(),
        "tasks": torch.stack(tasks).detach() if tasks else loss.new_zeros((0,)),
        "num_graphs": batch.graph_mask.sum(),
    }
    if guarded:
        finite = torch.isfinite(metrics["loss"])
        for p in model.parameters():
            if p.grad is not None:
                finite = finite & torch.isfinite(p.grad).all()
        metrics["finite"] = finite
    with record_function("train_step.optimizer"):
        optimizer.step()
    return metrics


def train_step(state: TrainState, batch: GraphBatch, guarded: bool = False,
               mixed: bool = False, generator=None):
    """:func:`train_body` on ``state``: returns ``(state, metrics)``; the
    state is updated in place and its ``step`` advanced."""
    metrics = train_body(state.model, state.optimizer, batch, guarded, mixed, generator)
    state.step += 1
    return state, metrics


def eval_body(model, batch: GraphBatch):
    """The loss and outputs of the model in eval mode (running BatchNorm
    statistics), with nothing recorded for autograd."""
    batch = decompact(batch)
    model.eval()
    with torch.inference_mode():
        outputs = model(batch)
        loss, tasks = model.loss(outputs, batch)
    return {
        "loss": loss,
        "tasks": torch.stack(tasks) if tasks else loss.new_zeros((0,)),
        "num_graphs": batch.graph_mask.sum(),
        "outputs": outputs,
    }


def eval_step(state: TrainState, batch: GraphBatch):
    """:func:`eval_body` of ``state``'s model."""
    return eval_body(state.model, batch)


def metrics_row(metrics) -> torch.Tensor:
    """``[loss, num_graphs, tasks...]`` in float32: one microbatch's row of
    a staged pass's result buffer."""
    return torch.cat([metrics["loss"].float().reshape(1),
                      metrics["num_graphs"].float().reshape(1), metrics["tasks"].float()])


def _stack_metrics(per_step):
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def _at(stacked: GraphBatch, k: int) -> GraphBatch:
    return stacked.map(lambda t: t[k])


def _microbatch(stacked: GraphBatch, idx: torch.Tensor) -> GraphBatch:
    """Microbatch ``idx`` (a device ``[1]`` index) of a staged stack."""
    return stacked.map(lambda t: t.index_select(0, idx)[0])


def _depth(args):
    return args[0].x.shape[0]


class Staged:
    """A stack of batches on the device (``Trainer.stage_batches``), with
    what its programs read and write in place: the cursor ``pos`` (a 0-d
    int64 the graph advances), the microbatch order ``perm``, and one
    result row per microbatch (:func:`metrics_row`)."""

    def __init__(self, stack: GraphBatch, num_tasks: int):
        self.stack = stack
        self.nb = stack.x.shape[0]
        dev = stack.x.device
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.perm = torch.arange(self.nb, dtype=torch.int64, device=dev)
        self.rows = torch.zeros((self.nb, 2 + num_tasks), dtype=torch.float32, device=dev)


def sentinel_tree(model, optimizer, metrics):
    """``(name, tensor)`` pairs in the order the JAX sentinel walks a
    step's ``(state, metrics)``: the parameters in flax's sorted order,
    the BatchNorm statistics likewise, then the optimizer's moments and
    the metrics. A name is the port's key, with ``= <JAX path>`` where
    ``models/bridge.py`` maps it."""
    from hydragnn_tpu_torch.models.bridge import _flax_path

    persistent = model.state_dict().keys()
    items = []
    for collection, named in (
            ("params", list(model.named_parameters())),
            ("batch_stats", [(n, b) for n, b in model.named_buffers() if n in persistent])):
        rows = []
        for name, t in named:
            try:
                path = _flax_path(model, name, collection)[0]
            except (KeyError, ValueError):
                path = None
            rows.append((path is None, path or (), name, t))
        for _, path, name, t in sorted(rows, key=lambda r: r[:3]):
            jax = "".join(f"['{c}']" for c in path)
            items.append((f"{name} = [0].{collection}{jax}" if path else name, t))
    if optimizer is not None:
        for name, p in model.named_parameters():
            for key, t in sorted(optimizer.state.get(p, {}).items()):
                if torch.is_tensor(t) and key != "step":
                    items.append((f"optimizer.{name}.{key}", t))
    items += [(f"metrics.{k} = [1]['{k}']", metrics[k]) for k in sorted(metrics)]
    return items


class FitBuffers:
    """What a chunk's programs are bound to (``CapturedSteps.fit_dispatch``):
    the training state's tensors (``capture.state_tensors``), the
    epoch-start snapshot of them, the best state (a copy of the model and
    optimizer, ``best_state``, whose tensors ``best`` the tail selects
    into), the schedulers' :class:`~hydragnn_tpu_torch.train.common.SchedState`,
    the chunk's epoch cursor ``pos`` and its count of epochs to run
    ``limit``, every epoch's microbatch order ``perms [epochs, n]``, and
    the ``series`` (a row an epoch, ``[train, val, test, lr, stopped,
    tasks...]``, then a row of the schedulers' state and the best state's
    step count: the chunk's one readback). All fixed, written in place."""

    def __init__(self, state: TrainState, device):
        ensure_optimizer_state(state.optimizer)
        self.state = state_tensors(state.model, state.optimizer)
        self.snap = [t.detach().clone() for t in self.state]
        # one deepcopy of both: the optimizer's copy is over the model's copy
        model, optimizer = copy.deepcopy((state.model, state.optimizer))
        self.best_state = TrainState(model=model, optimizer=optimizer, step=state.step)
        self.best = state_tensors(model, optimizer)
        self.sched = SchedState.init(device)
        self.epochs_done = 0  # sched.epoch as last read back
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.limit = torch.zeros((), dtype=torch.int64, device=device)
        self.perms = self.series = None
        self.device = device
        # the first parameter's step count: what the best state's step reads
        first = state.optimizer.state[next(state.model.parameters())]["step"]
        self.step_index = next(i for i, t in enumerate(self.state) if t is first)

    def shape(self, epochs: int, n: int, width: int):
        if self.perms is None or tuple(self.perms.shape) != (epochs, n):
            self.perms = torch.zeros((epochs, n), dtype=torch.int64, device=self.device)
        if self.series is None or tuple(self.series.shape) != (epochs + 1, width):
            self.series = torch.zeros((epochs + 1, width), dtype=torch.float32,
                                      device=self.device)


def _pass_means(rows):
    """``(loss, tasks)`` of a pass's result rows, weighted by graphs, in
    float32 on the device (JAX ``eval_epoch``)."""
    g = rows[:, 1]
    denom = torch.clamp(g.sum(), min=1.0)
    return (rows[:, 0] * g).sum() / denom, (rows[:, 2:] * g[:, None]).sum(0) / denom


class CapturedSteps(ProgramSet):
    """The trainer's programs over one model and optimizer (port of
    ``CompiledSteps``); see the module's docstring."""

    def __init__(self, trainer, state: TrainState):
        super().__init__(trainer.device, state.model, state.optimizer, trainer.generator)
        self.guarded = trainer.guarded
        self.mixed = trainer.precision["mixed"]
        # the MFU's peak follows the precision (obs/ledger.PEAK_FLOPS)
        ledger.note_precision(self.mixed, source=trainer.precision["source"])
        self.fit = None
        self.fit_config = fit_constants(trainer.training_config)
        if int(os.getenv("HYDRAGNN_NAN_SENTINEL", "0")):
            from hydragnn_tpu_torch.analysis.guards import nan_sentinel

            tree = lambda m: sentinel_tree(self.model, self.optimizer, m)  # noqa: E731
            self.train_step = nan_sentinel(self.train_step, scope="train_step", tree_of=tree)
            self.train_multi = nan_sentinel(self.train_multi, scope="train_multi", tree_of=tree)

    def program(self, name, body, kind="forward", mutates=False, bodies=lambda args: 1,
                bound=False):
        """:meth:`ProgramSet.program`, every program instrumented
        (``obs/introspect.py``: one record a novel shape key while a
        telemetry run is active)."""
        new = name not in self.programs
        prog = super().program(name, body, kind, mutates, bodies, bound)
        return introspect.instrument(prog) if new else prog

    def _train(self, batch):
        return train_body(self.model, self.optimizer, batch, self.guarded, self.mixed,
                          self.generator)

    def train_step(self, batch: GraphBatch, run: bool = True):
        """One step (``run=False``: only its capture, the state as before)."""
        prog = self.program("train_step", self._train, "step", mutates=True)
        return prog(batch) if run else prog.prepare(batch)

    def eval_step(self, batch: GraphBatch):
        return self.program("eval_step", lambda b: eval_body(self.model, b))(batch)

    def train_multi(self, stacked: GraphBatch):
        """K steps over a stacked group, metrics stacked ``[K, ...]``."""
        def body(s):
            return _stack_metrics([self._train(_at(s, k)) for k in range(s.x.shape[0])])

        return self.program("train_multi", body, "step", mutates=True, bodies=_depth)(stacked)

    def eval_multi(self, stacked: GraphBatch):
        def body(s):
            per = [eval_body(self.model, _at(s, k)) for k in range(s.x.shape[0])]
            return _stack_metrics([{k: v for k, v in m.items() if k != "outputs"} for m in per])

        return self.program("eval_multi", body, bodies=_depth)(stacked)

    def epoch_scan(self, staged: Staged, n: int):
        """``n`` training steps over ``staged`` in the order of
        ``staged.perm`` (one replay each, no copy to or from the host);
        fills ``staged.rows[:n]``."""
        def body(data, perm, pos, rows):
            at = pos.reshape(1)
            m = self._train(_microbatch(data, perm.index_select(0, at)))
            rows.index_copy_(0, at, metrics_row(m)[None])
            pos.add_(1)

        prog = self.program("epoch_scan", body, "step", mutates=True, bound=True)
        staged.pos.zero_()
        for _ in range(n):
            prog(staged.stack, staged.perm, staged.pos, staged.rows)

    def eval_epoch(self, staged: Staged, n: int, outputs: bool = False):
        """``n`` evaluation forwards over ``staged`` in order; fills
        ``staged.rows[:n]``. With ``outputs`` (``predict_scan``) returns
        every head's outputs stacked ``[n, rows, dim]`` on the device (one
        copy out of the graph per replay, none to the host)."""
        def body(data, pos, rows):
            at = pos.reshape(1)
            m = eval_body(self.model, _microbatch(data, at))
            rows.index_copy_(0, at, metrics_row(m)[None])
            pos.add_(1)
            return [o.float() for o in m["outputs"]] if outputs else None

        prog = self.program("predict_scan" if outputs else "eval_epoch", body, bound=True)
        staged.pos.zero_()
        outs = [prog(staged.stack, staged.pos, staged.rows) for _ in range(n)]
        if outputs:
            return [torch.stack(per_head) for per_head in zip(*outs)]
        return None

    # ---- a chunk of epochs (JAX fit_scan) -----------------------------------

    def fit_buffers(self, state: TrainState) -> FitBuffers:
        if self.fit is None:
            self.fit = FitBuffers(state, self.device)
        return self.fit

    def release(self):
        super().release()
        self.fit = None

    def fit_head(self, fit: FitBuffers, perm):
        """The state into the epoch-start snapshot, and the epoch's order
        (``perms[pos]``) into ``perm``."""
        n = len(fit.state)

        def body(perms, pos, perm, *flat):
            copy_state(list(flat[n:]), list(flat[:n]))
            perm.copy_(perms.index_select(0, pos.reshape(1))[0])

        self.program("fit_head", body, "tail", bound=True)(fit.perms, fit.pos, perm,
                                                           *fit.state, *fit.snap)

    def fit_tail(self, fit: FitBuffers, train_rows, val_rows=None, test_rows=None):
        """The epoch's schedulers, selection, best state and series row
        (see the module's docstring); advances ``pos``."""
        n, c = len(fit.state), self.fit_config
        has_val, has_test = val_rows is not None, test_rows is not None
        rows = [r for r in (train_rows, val_rows, test_rows) if r is not None]
        n_rows, n_lr = len(rows), len(rate_tensors(self.optimizer))
        step_index = fit.step_index

        def body(pos, limit, series, *rest):
            rows, rest = rest[:n_rows], rest[n_rows:]
            pbest, pbad, ebest, ecount, stopped, epoch, best_val = rest[:7]
            flat = rest[7:]
            state, snap, best = flat[:n], flat[n : 2 * n], flat[2 * n :]
            lr = state[n - n_lr]
            train_loss, train_tasks = _pass_means(rows[0])
            val_loss = _pass_means(rows[1])[0] if has_val else train_loss
            test_loss = _pass_means(rows[-1])[0] if has_test else val_loss
            run = ~stopped & (pos < limit)
            # ReduceLROnPlateau (train/scheduler.py's rule, float32)
            better = val_loss < pbest * (1.0 - c["threshold"])
            new_pbest = torch.where(better, val_loss, pbest)
            new_pbad = torch.where(better, torch.zeros_like(pbad), pbad + 1)
            drop = new_pbad > c["patience"]
            new_lr = torch.where(drop, torch.clamp(lr * c["factor"], min=c["min_lr"]), lr)
            new_pbad = torch.where(drop, torch.zeros_like(new_pbad), new_pbad)
            # EarlyStopping
            e_better = val_loss < ebest
            new_ebest = torch.where(e_better, val_loss, ebest)
            new_ecount = torch.where(e_better, torch.zeros_like(ecount), ecount + 1)
            new_stopped = ((new_ecount >= c["early_patience"]) if c["early"]
                           else torch.zeros_like(stopped))
            # the best state, from the warmup epoch on
            improved = (val_loss < best_val) & (epoch >= c["best_warmup"]) & run
            nan = torch.full_like(train_loss, float("nan"))
            row = torch.where(
                run,
                torch.cat([torch.stack([train_loss, val_loss, test_loss, new_lr,
                                        new_stopped.float()]), train_tasks]),
                torch.cat([torch.stack([nan, nan, nan, lr, stopped.float()]),
                           nan.expand(train_tasks.shape[0])]))
            with torch.no_grad():
                for t, s in zip(state, snap):
                    torch.where(run, t, s, out=t)
                for r in state[n - n_lr:]:
                    torch.where(run, new_lr, r, out=r)
                for b, t in zip(best, state):
                    torch.where(improved, t, b, out=b)
                for old, new in ((pbest, new_pbest), (pbad, new_pbad), (ebest, new_ebest),
                                 (ecount, new_ecount), (stopped, new_stopped),
                                 (epoch, epoch + 1), (best_val, torch.where(improved, val_loss,
                                                                           best_val))):
                    torch.where(run, new, old, out=old)
                width = series.shape[1]
                pad = lambda v: torch.cat([v, v.new_zeros(width - v.shape[0])])  # noqa: E731
                series.index_copy_(0, pos.reshape(1), pad(row)[None])
                series[-1].copy_(pad(torch.stack([
                    pbest, pbad.float(), ebest, ecount.float(), stopped.float(), epoch.float(),
                    best_val, best[step_index].float()])))
                pos.add_(1)

        name = f"fit_tail/{int(has_val)}{int(has_test)}"
        self.program(name, body, "tail", bound=True)(
            fit.pos, fit.limit, fit.series, *rows, *fit.sched.tensors(), *fit.state, *fit.snap,
            *fit.best)

    def fit_dispatch(self, staged: Staged, n: int, perms, num_epoch: int, val=None, n_val=0,
                     test=None, n_test=0):
        """Every epoch of a chunk, queued with no host sync: ``perms``
        (``[epochs, n]`` int64 on the host, pinned on the card's host)
        sets each epoch's order; epochs from ``num_epoch`` on are inert.
        The caller reads ``self.fit.series`` back once."""
        fit = self.fit
        epochs = perms.shape[0]
        fit.shape(epochs, n, max(5 + staged.rows.shape[1] - 2, 8))
        fit.perms.copy_(perms, non_blocking=True)
        fit.pos.zero_()
        fit.limit.fill_(int(num_epoch))
        for _ in range(epochs):
            self.fit_head(fit, staged.perm[:n])
            self.epoch_scan(staged, n)
            if val is not None:
                self.eval_epoch(val, n_val)
            if test is not None:
                self.eval_epoch(test, n_test)
            self.fit_tail(fit, staged.rows[:n], None if val is None else val.rows[:n_val],
                          None if test is None else test.rows[:n_test])


def fit_constants(training_config: dict) -> dict:
    """The chunk's scheduler constants (JAX ``build_steps``): the
    plateau's factor, patience, threshold and ``min_lr`` (``scheduler``),
    early stopping and its patience, and the best state's warmup
    (``checkpoint_warmup``, default 10 with ``Checkpoint``, else 0)."""
    sch = training_config.get("scheduler", {})
    return {
        "factor": float(sch.get("factor", 0.5)),
        "patience": int(sch.get("patience", 5)),
        "threshold": float(sch.get("threshold", 1e-4)),
        "min_lr": float(sch.get("min_lr", 1e-5)),
        "early": bool(training_config.get("EarlyStopping", False)),
        "early_patience": int(training_config.get("patience", 5)),
        "best_warmup": int(training_config.get(
            "checkpoint_warmup", 10 if training_config.get("Checkpoint", False) else 0)),
    }
