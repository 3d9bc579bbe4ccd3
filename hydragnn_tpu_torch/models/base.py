"""HydraBase — the multi-headed GNN stack (port of ``models/base.py``).

Conv stack -> masked BatchNorm + activation per layer -> masked global
mean pool -> shared graph MLP + per-head MLPs (graph heads); node heads as
a shared MLP (``mlp``), a per-node MLP bank (``mlp_per_node``) or conv
stacks (``conv``). Submodules carry the JAX package's parameter names
(``encoder_conv_{i}``, ``encoder_bn_{i}``, ``graph_shared``,
``head_{h}_graph``, ``head_{h}_node``, ``head_{h}_conv_{l}``,
``head_{h}_bn_{l}``), which is what lets ``models/bridge.py`` map one onto
the other by path.

Only float32 inference is ported: ``forward`` needs eval mode and float32
parameters (the BatchNorm training branch, the loss, bf16 compute and the
backward rules of the kernels are queued in ``ROADMAP.md``).
"""

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.common import (
    MLP,
    MaskedBatchNorm,
    get_activation,
    global_mean_pool,
    uniform_,
)


class MLPNode(nn.Module):
    """Node-level head: one shared MLP (``num_mlp == 1``) or a per-node MLP
    bank. Parameters are stacked ``kernel_{i} [num_mlp, fan_in, fan_out]``
    and ``bias_{i} [num_mlp, fan_out]`` (the JAX package's layout); each
    node uses the MLP of its position within its graph."""

    def __init__(self, input_dim: int, output_dim: int, num_mlp: int,
                 hidden_dims: Tuple[int, ...], activation: str = "relu",
                 device=None):
        super().__init__()
        self.num_mlp = num_mlp
        self.act = get_activation(activation)
        self.dims = [input_dim] + list(hidden_dims) + [output_dim]
        for i in range(len(self.dims) - 1):
            fan_in, fan_out = self.dims[i], self.dims[i + 1]
            self.register_parameter(
                f"kernel_{i}",
                nn.Parameter(torch.empty(num_mlp, fan_in, fan_out, device=device)),
            )
            self.register_parameter(
                f"bias_{i}", nn.Parameter(torch.empty(num_mlp, fan_out, device=device))
            )

    def reset_parameters(self, generator: torch.Generator):
        for i in range(len(self.dims) - 1):
            bound = 1.0 / math.sqrt(self.dims[i])
            uniform_(getattr(self, f"kernel_{i}"), bound, generator)
            uniform_(getattr(self, f"bias_{i}"), bound, generator)

    def forward(self, x, node_index_in_graph):
        sel = torch.clamp(node_index_in_graph, 0, self.num_mlp - 1).to(torch.int64)
        h = x
        n_layers = len(self.dims) - 1
        for i in range(n_layers):
            kernel = getattr(self, f"kernel_{i}")
            bias = getattr(self, f"bias_{i}")
            if self.num_mlp == 1:
                h = h @ kernel[0] + bias[0]
            else:
                h = torch.einsum("nf,nfo->no", h, kernel[sel]) + bias[sel]
            if i < n_layers - 1:
                h = self.act(h)
        return h


class HydraBase(nn.Module):
    """Multi-headed stack; subclasses provide ``make_conv``, returning a
    module with ``forward(x, pos, batch) -> (x, pos)``."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        output_dim: Tuple[int, ...],
        output_type: Tuple[str, ...],
        config_heads: Dict[str, Any],
        activation: str = "relu",
        num_conv_layers: int = 2,
        num_nodes: Optional[int] = None,
        edge_dim: Optional[int] = None,
        initial_bias: Optional[float] = None,
        loss_weights: Tuple[float, ...] = (),
    ):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.output_dim = tuple(output_dim)
        self.output_type = tuple(output_type)
        self.config_heads = config_heads or {}
        self.activation = activation
        self.act = get_activation(activation)
        self.num_conv_layers = num_conv_layers
        self.num_nodes = num_nodes
        self.edge_dim = edge_dim
        self.initial_bias = initial_bias
        self.loss_weights = tuple(loss_weights)

    @property
    def use_edge_attr(self) -> bool:
        return self.edge_dim is not None and self.edge_dim > 0

    @property
    def num_heads(self) -> int:
        return len(self.output_dim)

    def make_conv(self, in_dim: int, out_dim: int, device=None) -> nn.Module:
        raise NotImplementedError

    def build(self, device=None):
        """Create the encoder and the heads (called by the subclass once
        its own conv settings are in place)."""
        for i in range(self.num_conv_layers):
            in_dim = self.input_dim if i == 0 else self.hidden_dim
            self.add_module(f"encoder_conv_{i}", self.make_conv(in_dim, self.hidden_dim, device))
            self.add_module(f"encoder_bn_{i}", MaskedBatchNorm(self.hidden_dim, device=device))
        heads = self.config_heads
        if "graph" in heads:
            g = heads["graph"]
            self.graph_shared = MLP(
                self.hidden_dim,
                [g["dim_sharedlayers"]] * g["num_sharedlayers"],
                activation=self.activation,
                final_activation=True,
                device=device,
            )
        self.node_conv_layers = {}
        for ihead in range(self.num_heads):
            head_type = self.output_type[ihead]
            head_dim = self.output_dim[ihead]
            if head_type == "graph":
                g = heads["graph"]
                dims = list(g["dim_headlayers"][: g["num_headlayers"]]) + [head_dim]
                self.add_module(f"head_{ihead}_graph", MLP(
                    g["dim_sharedlayers"], dims, activation=self.activation,
                    final_bias_value=self.initial_bias, device=device,
                ))
            elif head_type == "node":
                node_cfg = heads["node"]
                node_type = node_cfg["type"]
                hidden_dims = tuple(node_cfg["dim_headlayers"])
                if node_type in ("mlp", "mlp_per_node"):
                    num_mlp = 1 if node_type == "mlp" else int(self.num_nodes)
                    self.add_module(f"head_{ihead}_node", MLPNode(
                        self.hidden_dim, head_dim, num_mlp, hidden_dims,
                        activation=self.activation, device=device,
                    ))
                elif node_type == "conv":
                    dims = list(hidden_dims[: node_cfg["num_headlayers"]]) + [head_dim]
                    prev = self.hidden_dim
                    for il, od in enumerate(dims):
                        self.add_module(f"head_{ihead}_conv_{il}", self.make_conv(prev, od, device))
                        self.add_module(f"head_{ihead}_bn_{il}", MaskedBatchNorm(od, device=device))
                        prev = od
                    self.node_conv_layers[ihead] = len(dims)
                else:
                    raise ValueError(
                        f"Unknown head NN structure for node features: {node_type};"
                        " supported: 'mlp', 'mlp_per_node', 'conv'"
                    )
            else:
                raise ValueError(f"Unknown head type: {head_type}")

    @staticmethod
    def node_index_in_graph(batch: GraphBatch):
        n_node = batch.n_node.to(torch.int64)
        starts = torch.cumsum(n_node, 0) - n_node
        idx = torch.arange(batch.num_nodes, dtype=torch.int64, device=batch.device)
        return idx - starts[batch.node_graph.to(torch.int64)]

    def forward(self, batch: GraphBatch):
        """Per-head outputs: graph heads ``[G, dim]``, node heads
        ``[N, dim]`` (padding rows zero for ``mlp`` heads)."""
        param = next(self.parameters())
        if param.dtype != torch.float32:
            raise NotImplementedError(
                f"{param.dtype} compute is not ported yet (the port computes in "
                "float32, as the JAX package serves): see ROADMAP.md"
            )
        batch = batch.to(param.device)
        x, pos = batch.x, batch.pos
        for i in range(self.num_conv_layers):
            c, pos = getattr(self, f"encoder_conv_{i}")(x, pos, batch)
            c = getattr(self, f"encoder_bn_{i}")(c, batch.node_mask)
            x = self.act(c)

        x_graph = global_mean_pool(x, batch.node_graph, batch.n_node, batch.num_graphs)
        outputs = []
        node_index = None
        for ihead in range(self.num_heads):
            if self.output_type[ihead] == "graph":
                head = getattr(self, f"head_{ihead}_graph")
                outputs.append(head(self.graph_shared(x_graph)))
            elif ihead in self.node_conv_layers:
                h, p = x, pos
                for il in range(self.node_conv_layers[ihead]):
                    c, p = getattr(self, f"head_{ihead}_conv_{il}")(h, p, batch)
                    c = getattr(self, f"head_{ihead}_bn_{il}")(c, batch.node_mask)
                    h = self.act(c)
                outputs.append(h)
            else:
                if node_index is None:
                    node_index = self.node_index_in_graph(batch)
                out = getattr(self, f"head_{ihead}_node")(x, node_index)
                outputs.append(torch.where(batch.node_mask[:, None], out, 0.0))
        return tuple(outputs)

    def loss(self, outputs, batch):
        raise NotImplementedError(
            "the loss comes with training, which is not ported yet (see ROADMAP.md)"
        )
