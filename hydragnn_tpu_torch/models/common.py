"""Shared building blocks of the model stacks (port of ``models/common.py``).

Parameters follow PyTorch's layout (``nn.Linear`` weight ``[out, in]``);
``models/bridge.py`` carries weights across from the JAX package's
``[in, out]`` kernels. Every module draws its initial values in
``reset_parameters(generator)`` from an explicit ``torch.Generator``:
torch-style ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weights and biases,
and the JAX package's own inits for its raw ``x @ W`` matrices
(:func:`glorot_uniform_`, :func:`small_uniform_`).

Products promote as JAX's do (:func:`matmul`): a bf16 input times an f32
weight, or the other way round, is an f32 product, and a linear layer adds
its bias as a second operation, rounding twice in bf16 where JAX does.

The aggregation helpers at the end are the convs' message passing in the
two modes (:data:`AGGREGATIONS`), through the kernels' backward rules
(``ops``: ``*_vjp``). A kernel takes float32: bf16 inputs are upcast
before its wrapper, and its result goes back to the input's dtype, as the
JAX package's fused kernels do.
"""

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_count, segment_sum
from hydragnn_tpu_torch.ops import (
    fused_gather_mean_vjp,
    fused_gather_sum_vjp,
    fused_gather_weighted_sum_vjp,
)


# the draws of a checkpointed conv (models/base.py): recorded in its
# forward, replayed in its recompute
_DRAWS = threading.local()


@contextlib.contextmanager
def _draws(tape: list, replay: bool):
    prev = getattr(_DRAWS, "active", None)
    _DRAWS.active = (tape, replay, [0])
    try:
        yield
    finally:
        _DRAWS.active = prev


def recorded_draws():
    """``context_fn`` of ``torch.utils.checkpoint``: the forward records
    every :func:`draw_keep` mask, the recompute gets them back in order."""
    tape = []
    return _draws(tape, False), _draws(tape, True)


def draw_keep(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """A dropout mask: each entry True with probability ``1 - rate``,
    drawn from ``generator`` (or replayed, inside a checkpoint's
    recompute)."""
    active = getattr(_DRAWS, "active", None)
    if active is not None and active[1]:
        tape, _, at = active
        at[0] += 1
        return tape[at[0] - 1]
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - rate
    if active is not None:
        active[0].append(keep)
    return keep


def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill ``param`` with ``U(-bound, bound)`` drawn on the CPU from
    ``generator`` (so one seed gives one model on every device)."""
    with torch.no_grad():
        draw = torch.rand(param.shape, generator=generator, dtype=torch.float32)
        param.copy_(draw * (2.0 * bound) - bound)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX's ``@`` (PyTorch's
    refuses mixed dtypes)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


class TorchLinear(nn.Module):
    """``y = x @ weight.T``, then ``y + bias`` (JAX's ``TorchLinear``: two
    operations, not ``F.linear``'s fused one), with torch.nn.Linear's
    default init."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device)) if bias else None
        )

    def reset_parameters(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.in_features)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x):
        y = matmul(x, self.weight.t())
        return y if self.bias is None else y + self.bias


class SplitLinear(TorchLinear):
    """A ``TorchLinear(fan_in, features)`` meant for a concatenated input,
    exposing weight slices so a caller can use linearity:
    ``concat([a, b]) @ W == a @ W[:da] + b @ W[da:]``."""

    def piece(self, x, start: int):
        """``x @ weight[:, start : start + x.shape[-1]].T`` — one concat
        segment's contribution (no bias; add :attr:`bias` once)."""
        return matmul(x, self.weight[:, start : start + x.shape[-1]].t())


def get_activation(name: str) -> Callable:
    """Activation by name (the JAX package's table; ``gelu`` is the tanh
    approximation, as ``jax.nn.gelu``'s default)."""
    table = {
        "relu": F.relu,
        "selu": F.selu,
        "prelu": lambda x: torch.where(x >= 0, x, 0.25 * x),  # PReLU at init slope
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "tanh": torch.tanh,
        "lrelu_01": lambda x: F.leaky_relu(x, 0.1),
        "lrelu_025": lambda x: F.leaky_relu(x, 0.25),
        "lrelu_05": lambda x: F.leaky_relu(x, 0.5),
        "sigmoid": torch.sigmoid,
    }
    if name not in table:
        raise ValueError(f"Unknown activation function: {name}")
    return table[name]


def masked_error(pred, target, mask, kind: str = "mse"):
    """Masked elementwise loss, the mean over real rows x features, in
    float32 (port of ``masked_error``): padding rows add nothing to the sum
    or the count. ``kind``: ``mse``, ``mae``, ``rmse`` (its square root
    taken with a double-where, so a perfect fit has a zero, not a NaN,
    gradient) or ``smooth_l1``. The ``axis_name`` branch waits for
    parallelism (``ROADMAP.md``)."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    m = mask.reshape(tuple(mask.shape) + (1,) * (pred.ndim - 1)).to(pred.dtype)
    # where (not multiply): NaN or inf in a padded row cannot leak in
    diff = torch.where(m > 0, pred - target, 0.0)
    count = m.sum() * pred.shape[-1]
    if kind in ("mse", "rmse"):
        numer = (diff * diff).sum()
    elif kind == "mae":
        numer = diff.abs().sum()
    elif kind == "smooth_l1":
        a = diff.abs()
        numer = (torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5) * m).sum()
    else:
        raise ValueError(f"Unknown loss function: {kind}")
    out = numer / torch.clamp(count, min=1.0)
    if kind == "rmse":
        positive = out > 0.0
        out = torch.where(positive, torch.sqrt(torch.where(positive, out, 1.0)), 0.0)
    return out


def masked_gaussian_nll(mu, logvar, target, mask, eps: float = 1e-6):
    """Masked Gaussian negative log-likelihood ``0.5 * (exp(-s) (mu - y)^2
    + s)`` with ``s`` the head's log-variance channel, clamped below at
    ``log(eps)``; the mean over real rows x features, in float32 (port of
    ``masked_gaussian_nll``)."""
    mu = mu.to(torch.float32)
    target = target.to(torch.float32)
    logvar = logvar.to(torch.float32)
    m = mask.reshape(tuple(mask.shape) + (1,) * (mu.ndim - 1)).to(mu.dtype)
    diff = torch.where(m > 0, mu - target, 0.0)
    logvar = torch.maximum(logvar, torch.log(logvar.new_tensor(eps)))
    val = 0.5 * (torch.exp(-logvar) * diff * diff + logvar)
    numer = torch.where(m > 0, val, 0.0).sum()
    count = m.sum() * mu.shape[-1]
    return numer / torch.clamp(count, min=1.0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over real nodes only, padding rows zeroed; computed in
    float32 (port of ``MaskedBatchNorm``).

    Training: the masked batch mean and biased variance (two-pass,
    centred) normalise, and the running estimates take the unbiased
    variance, ``running = (1 - MOMENTUM) running + MOMENTUM batch`` under
    ``no_grad``, once per forward. Eval: the running statistics.
    ``batch_stats=True`` normalises with the batch's statistics in any
    mode and updates the running ones only in ``train()`` mode (the
    uncertainty scorer's sampling branch, which throws the update away as
    the JAX package does). The
    ``axis_name`` branch (statistics over a mesh axis) waits for
    parallelism (``ROADMAP.md``)."""

    MOMENTUM = 0.1

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.features = features
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, mask, batch_stats: Optional[bool] = None):
        in_dtype = x.dtype
        x = x.to(torch.float32)
        if batch_stats is None:
            batch_stats = self.training
        if batch_stats:
            m = mask.to(torch.float32)[:, None]
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(0) / count
            centered = (x - mean) * m
            var = (centered * centered).sum(0) / count
            if self.training:
                with torch.no_grad():
                    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                    mom = self.MOMENTUM
                    self.running_mean.copy_((1.0 - mom) * self.running_mean + mom * mean)
                    self.running_var.copy_((1.0 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[:, None], y, 0.0).to(in_dtype)


class MLP(nn.Module):
    """TorchLinear layers with an activation after each hidden layer (and
    after the last when ``final_activation``). ``final_bias_value`` sets the
    last layer's bias to a constant at init (its weight keeps the torch
    init); that layer is then called ``final``, else ``TorchLinear_{k}``,
    the JAX package's names."""

    def __init__(self, in_dim: int, layer_dims: Sequence[int],
                 activation: str = "relu", final_activation: bool = False,
                 final_bias_value: Optional[float] = None, device=None):
        super().__init__()
        self.act = get_activation(activation)
        self.final_activation = final_activation
        self.final_bias_value = final_bias_value
        self.names = []
        dims = [in_dim] + list(layer_dims)
        for i in range(len(layer_dims)):
            last = i == len(layer_dims) - 1
            name = "final" if last and final_bias_value is not None else f"TorchLinear_{i}"
            self.add_module(name, TorchLinear(dims[i], dims[i + 1], device=device))
            self.names.append(name)

    def reset_parameters(self, generator: torch.Generator):
        # init_params resets children before parents, so the layers already
        # hold their torch init here; only the constant final bias is ours
        if self.final_bias_value is not None:
            with torch.no_grad():
                self.final.bias.fill_(self.final_bias_value)

    def forward(self, x):
        n = len(self.names)
        for i, name in enumerate(self.names):
            x = getattr(self, name)(x)
            if i < n - 1 or self.final_activation:
                x = self.act(x)
        return x


def global_mean_pool(x, node_graph, n_node, num_graphs: int):
    """Padding-aware per-graph mean of node features -> ``[G, F]``; the
    padding graph's row is finite because padded node rows are zero."""
    total = segment_sum(x, node_graph, num_graphs)
    denom = torch.clamp(n_node.to(x.dtype), min=1.0)[:, None]
    return total / denom


def safe_sqrt(x):
    """sqrt that gives 0 (never NaN, nor a NaN gradient) at 0: the
    double-where of the JAX package's ``_safe_sqrt``."""
    nonzero = x > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, x, 1.0)), 0.0)


def glorot_uniform_(param: torch.Tensor, generator: torch.Generator):
    """flax's ``xavier_uniform`` for a raw ``[fan_in, fan_out]`` matrix:
    ``U(-b, b)``, ``b = sqrt(6 / (fan_in + fan_out))``."""
    fan_in, fan_out = param.shape
    uniform_(param, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def small_uniform_(param: torch.Tensor, generator: torch.Generator):
    """The JAX package's init of the coordinate MLP's last layer,
    ``variance_scaling(1e-6 / 3, "fan_avg", "uniform")`` (xavier at gain
    1e-3 in the reference): ``U(-b, b)``, ``b = sqrt(1e-6 / fan_avg)``."""
    fan_in, fan_out = param.shape
    uniform_(param, math.sqrt(1e-6 / ((fan_in + fan_out) / 2.0)), generator)


# ---------------------------------------------------------------------------
# aggregation: the fused kernels (K4-K6) or the gather in PyTorch + K1
# ---------------------------------------------------------------------------

# "fused" is the JAX package's HYDRAGNN_AGG=fused (the fused message-passing
# kernels), "segment" its HYDRAGNN_PALLAS=1 (a gather, then the segment
# kernels)
AGGREGATIONS = ("fused", "segment")


def check_aggregation(aggregation: str) -> str:
    if aggregation not in AGGREGATIONS:
        raise ValueError(
            f"aggregation must be one of {AGGREGATIONS}, got {aggregation!r}"
        )
    return aggregation


def _masked_gather(x, senders, edge_mask):
    return torch.where(edge_mask[:, None], x[senders.to(torch.int64)], 0.0)


def gather_segment_sum(x, senders, receivers, num_segments, edge_mask,
                       aggregation: str):
    """``segment_sum(where(mask, x[senders], 0), receivers)`` — GIN's
    aggregation: K4 (``"fused"``) or the gather in PyTorch and K1
    (``"segment"``). Returns ``[S, D]`` in ``x.dtype``."""
    if check_aggregation(aggregation) == "fused":
        return fused_gather_sum_vjp(x, senders, receivers, num_segments, edge_mask).to(x.dtype)
    return segment_sum(_masked_gather(x, senders, edge_mask), receivers, num_segments)


def gather_segment_mean(x, senders, receivers, num_segments, edge_mask,
                        aggregation: str):
    """Masked mean over real incoming edges — SAGE's aggregation: sum and
    real in-degree from one reduction (K5), or the gather in PyTorch, K1
    for the sum and a count of the mask. Returns ``[S, D]`` in
    ``x.dtype``."""
    if check_aggregation(aggregation) == "fused":
        mean, _deg = fused_gather_mean_vjp(x, senders, receivers, num_segments, edge_mask)
        return mean.to(x.dtype)
    total = segment_sum(_masked_gather(x, senders, edge_mask), receivers, num_segments)
    deg = segment_count(receivers, num_segments, weights=edge_mask)
    return total / torch.clamp(deg, min=1.0)[:, None]


def gather_weighted_segment_sum(h, w, senders, receivers, num_segments,
                                aggregation: str):
    """``segment_sum(h[senders] * w, receivers)`` — SchNet's CFConv
    aggregation (``w`` comes masked): K6 or the gather in PyTorch and
    K1."""
    if check_aggregation(aggregation) == "fused":
        return fused_gather_weighted_sum_vjp(h, w, senders, receivers, num_segments).to(h.dtype)
    return segment_sum(h[senders.to(torch.int64)] * w, receivers, num_segments)
