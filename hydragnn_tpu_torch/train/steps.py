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
"""

import dataclasses

import torch
from torch.profiler import record_function

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.train.capture import ProgramSet
from hydragnn_tpu_torch.train.common import TrainState


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


class CapturedSteps(ProgramSet):
    """The trainer's programs over one model and optimizer (port of
    ``CompiledSteps``); see the module's docstring."""

    def __init__(self, trainer, state: TrainState):
        super().__init__(trainer.device, state.model, state.optimizer, trainer.generator)
        self.guarded = trainer.guarded
        self.mixed = trainer.precision["mixed"]

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
