"""Shared building blocks of the model stacks (port of ``models/common.py``).

Parameters follow PyTorch's layout (``nn.Linear`` weight ``[out, in]``);
``models/bridge.py`` carries weights across from the JAX package's
``[in, out]`` kernels. Every module draws its initial values in
``reset_parameters(generator)`` from an explicit ``torch.Generator``:
torch-style ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weights and biases.
"""

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_sum


def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill ``param`` with ``U(-bound, bound)`` drawn on the CPU from
    ``generator`` (so one seed gives one model on every device)."""
    with torch.no_grad():
        draw = torch.rand(param.shape, generator=generator, dtype=torch.float32)
        param.copy_(draw * (2.0 * bound) - bound)


class TorchLinear(nn.Module):
    """``y = x @ weight.T + bias`` with torch.nn.Linear's default init."""

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
        return F.linear(x, self.weight, self.bias)


class SplitLinear(TorchLinear):
    """A ``TorchLinear(fan_in, features)`` meant for a concatenated input,
    exposing weight slices so a caller can use linearity:
    ``concat([a, b]) @ W == a @ W[:da] + b @ W[da:]``."""

    def piece(self, x, start: int):
        """``x @ weight[:, start : start + x.shape[-1]].T`` — one concat
        segment's contribution (no bias; add :attr:`bias` once)."""
        return F.linear(x, self.weight[:, start : start + x.shape[-1]])


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


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over real nodes only, padding rows zeroed.

    Eval with running statistics: ``(x - mean) * rsqrt(var + eps) * weight
    + bias``, computed in float32. The training branch (masked batch
    statistics and the running-stat update) comes with training; see
    ``ROADMAP.md``."""

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

    def forward(self, x, mask):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm training mode is not ported yet (see "
                "ROADMAP.md); call model.eval()"
            )
        in_dtype = x.dtype
        x = x.to(torch.float32)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        y = y * self.weight + self.bias
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
