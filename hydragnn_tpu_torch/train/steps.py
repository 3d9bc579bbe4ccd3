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
"""

import dataclasses

import torch
from torch.profiler import record_function

from hydragnn_tpu_torch.graph.batch import GraphBatch
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


def train_step(state: TrainState, batch: GraphBatch, guarded: bool = False,
               mixed: bool = False, generator=None):
    """One optimizer step on ``batch`` (already on the model's device), in
    bf16 mixed precision with ``mixed``; ``generator`` (on the model's
    device) feeds a stochastic layer. Returns ``(state, metrics)``; the
    state is updated in place."""
    model, optimizer = state.model, state.optimizer
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
    state.step += 1
    return state, metrics


def eval_step(state: TrainState, batch: GraphBatch):
    """The loss and outputs of the model in eval mode (running BatchNorm
    statistics), with nothing recorded for autograd."""
    model = state.model
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
