"""HydraBase — the multi-headed GNN stack (port of ``models/base.py``).

Conv stack -> masked BatchNorm (unless the stack has none:
``conv_use_batchnorm``) + activation per layer -> masked global
mean pool -> shared graph MLP + per-head MLPs (graph heads); node heads as
a shared MLP (``mlp``), a per-node MLP bank (``mlp_per_node``) or conv
stacks (``conv``). Submodules carry the JAX package's parameter names
(``encoder_conv_{i}``, ``encoder_bn_{i}``, ``graph_shared``,
``head_{h}_graph``, ``head_{h}_node``, ``head_{h}_conv_{l}``,
``head_{h}_bn_{l}``), which is what lets ``models/bridge.py`` map one onto
the other by path.

The layer widths come from two hooks, as in the JAX package:
:meth:`HydraBase.conv_layer_specs` (the encoder) and
:meth:`HydraBase.node_conv_specs` (a ``conv`` node head) give ``(in, out,
BatchNorm width, conv keywords)`` per layer; GAT's head concatenation
overrides both. :meth:`HydraBase.prepare_batch` runs once per forward
before the first conv (DimeNet hoists its geometry there).

``forward`` runs the BatchNorm training branch in ``train()`` mode, and
:meth:`HydraBase.loss` is the weighted multi-task loss (or, with
``loss_nll``, the Gaussian NLL on one extra log-variance channel per head).
The forward computes in the dtypes it is given, as the JAX package's does:
with bf16 parameters and inputs (``train/steps.py``'s mixed precision) the
products run in bf16, BatchNorm statistics and losses in float32, and the
kernels on float32 upcasts. A batch with dense neighbour lists takes the
convs' dense branch, which every ported stack has; a stack without one
(``dense_branch`` False) raises on it. A conv with a stochastic layer
(GAT's attention dropout, ``stochastic``) draws it in ``train()`` mode
from the ``generator`` passed to ``forward``; eval is deterministic.
``forward(sample=True)`` runs the training branch in any mode without
changing the module: the stochastic layers draw and BatchNorm takes the
batch's statistics, but the running statistics stay as they are (one
sample of the uncertainty scorer's ``dropout`` mode, ``serve/quality.py``).

With ``conv_checkpointing`` (the JAX package's ``nn.remat`` of the conv
class) every conv, of the encoder and of a ``conv`` node head, runs under
``torch.utils.checkpoint`` (``use_reentrant=False``) when autograd records:
its activations are freed after the forward and recomputed in the
backward. The region is the conv alone: no BatchNorm is inside it, so no
running statistic is updated twice. The recompute sees the tensors the
forward saw (the parameters of the call, bf16 casts under mixed
precision) and the same dropout draws: the forward records each draw of
the conv (``common.recorded_draws``) and the recompute replays it, since
the draws come from the trainer's generator, not from the global RNG
state (which the checkpoint does not keep: reading it is not allowed
while a CUDA graph captures).
"""

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.common import (
    MLP,
    MaskedBatchNorm,
    check_aggregation,
    get_activation,
    global_mean_pool,
    masked_error,
    masked_gaussian_nll,
    matmul,
    recorded_draws,
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
                h = matmul(h, kernel[0]) + bias[0]
            else:
                k = kernel[sel]
                dtype = torch.promote_types(h.dtype, k.dtype)
                h = torch.einsum("nf,nfo->no", h.to(dtype), k.to(dtype)) + bias[sel]
            if i < n_layers - 1:
                h = self.act(h)
        return h


class HydraBase(nn.Module):
    """Multi-headed stack; subclasses provide ``make_conv``, returning a
    module with ``forward(x, pos, batch) -> (x, pos)``.

    ``aggregation`` picks the kernels of the convs' message passing:
    ``"fused"`` (the JAX package's ``HYDRAGNN_AGG=fused``) or
    ``"segment"`` (its ``HYDRAGNN_PALLAS=1``)."""

    # SchNet and EGNN keep the activation but have no encoder BatchNorm
    # (the JAX package's ``conv_use_batchnorm``, ``base.py:244-251``); node
    # conv heads keep theirs in every stack
    conv_use_batchnorm = True
    # whether the convs take the dense neighbour-list branch for a batch
    # that carries the lists
    dense_branch = False
    # the JAX package's HydraBase.dropout: GAT's attention dropout rate
    dropout = 0.25
    # whether the convs read node positions (SchNet, EGNN, DimeNet): the
    # others train on a position placeholder (train/transfer.py)
    conv_needs_pos = False

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
        equivariance: bool = False,
        aggregation: str = "fused",
        loss_function_type: str = "mse",
        loss_nll: bool = False,
        conv_checkpointing: bool = False,
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
        self.equivariance = bool(equivariance)
        self.aggregation = check_aggregation(aggregation)
        self.loss_function_type = loss_function_type
        # NLL mode: every head emits one extra log-variance channel
        self.loss_nll = bool(loss_nll)
        self.conv_checkpointing = bool(conv_checkpointing)

    @property
    def use_edge_attr(self) -> bool:
        return self.edge_dim is not None and self.edge_dim > 0

    @property
    def num_heads(self) -> int:
        return len(self.output_dim)

    def make_conv(self, in_dim: int, out_dim: int, last_layer: bool = False,
                  device=None, **kw) -> nn.Module:
        """The conv of one layer; ``last_layer`` is True for the encoder's
        last conv and each conv head's output conv (EGNN and SchNet turn
        their coordinate update off there); ``kw``: the rest of the layer
        spec's keywords (GAT's ``concat``)."""
        raise NotImplementedError

    def conv_layer_specs(self):
        """``(in_dim, out_dim, bn_dim, conv keywords)`` per encoder layer
        (the JAX package's ``_conv_layer_specs``)."""
        return [
            (self.input_dim if i == 0 else self.hidden_dim, self.hidden_dim, self.hidden_dim,
             {"last_layer": i == self.num_conv_layers - 1})
            for i in range(self.num_conv_layers)
        ]

    def node_conv_specs(self, node_cfg, head_dim: int):
        """The layer specs of a ``conv`` node head: ``num_headlayers``
        hidden convs, then the output conv (``_node_conv_specs``)."""
        dims = node_cfg["dim_headlayers"]
        specs, prev = [], self.hidden_dim
        for il in range(node_cfg["num_headlayers"]):
            specs.append((prev, dims[il], dims[il], {"last_layer": False}))
            prev = dims[il]
        specs.append((prev, head_dim, head_dim, {"last_layer": True}))
        return specs

    def prepare_batch(self, batch: GraphBatch) -> GraphBatch:
        """Once per forward, before the first conv: values every conv
        would otherwise recompute alike (the JAX package's
        ``_prepare_batch``). Default: the batch as it is."""
        return batch

    def build(self, device=None):
        """Create the encoder and the heads (called by the subclass once
        its own conv settings are in place)."""
        for i, (in_dim, out_dim, bn_dim, kw) in enumerate(self.conv_layer_specs()):
            self.add_module(f"encoder_conv_{i}", self.make_conv(in_dim, out_dim, device=device, **kw))
            if self.conv_use_batchnorm:
                self.add_module(f"encoder_bn_{i}", MaskedBatchNorm(bn_dim, device=device))
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
        uq_extra = 1 if self.loss_nll else 0
        for ihead in range(self.num_heads):
            head_type = self.output_type[ihead]
            head_dim = self.output_dim[ihead] + uq_extra
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
                    specs = self.node_conv_specs(node_cfg, head_dim)
                    for il, (in_dim, od, bn_dim, kw) in enumerate(specs):
                        self.add_module(f"head_{ihead}_conv_{il}",
                                        self.make_conv(in_dim, od, device=device, **kw))
                        self.add_module(f"head_{ihead}_bn_{il}", MaskedBatchNorm(bn_dim, device=device))
                    self.node_conv_layers[ihead] = len(specs)
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

    def set_dropout(self, rate: float):
        """Set the dropout rate of the stack and of every conv that has one
        (the JAX package's ``HydraBase.dropout`` field)."""
        self.dropout = float(rate)
        for m in self.modules():
            if getattr(m, "stochastic", False):
                m.dropout = float(rate)
        return self

    def _conv(self, conv, x, pos, batch, generator, sample):
        kw = {"generator": generator, "sample": sample} if getattr(conv, "stochastic", False) else {}
        if not (self.conv_checkpointing and torch.is_grad_enabled()):
            return conv(x, pos, batch, **kw)
        # the tensors of this call (bf16 casts inside forward_bf16's
        # functional_call), so that the recompute, outside that call, sees them
        tensors = dict(conv.named_parameters())
        tensors.update(conv.named_buffers())

        def run(x, pos):
            return torch.func.functional_call(conv, tensors, (x, pos, batch), kw)

        # the draws are recorded, so no global RNG state is kept (its read
        # is not allowed inside a CUDA graph capture)
        return checkpoint(run, x, pos, use_reentrant=False, preserve_rng_state=False,
                          context_fn=recorded_draws)

    def forward(self, batch: GraphBatch, generator: Optional[torch.Generator] = None,
                sample: bool = False):
        """Per-head outputs: graph heads ``[G, dim]``, node heads
        ``[N, dim]`` (padding rows zero for ``mlp`` heads); ``dim`` has one
        more column, the log-variance, under ``loss_nll``. ``generator``:
        the draws of a stochastic conv in ``train()`` mode or with
        ``sample`` (on the model's device). ``sample``: the training
        branch without its update of the running statistics (the module's
        docstring)."""
        batch = batch.to(next(self.parameters()).device)
        if "nbr_idx" in batch.extras and not self.dense_branch:
            raise NotImplementedError(
                f"{type(self).__name__} has no dense neighbour-list branch in the "
                "port yet (the JAX package's takes one for such a batch): see "
                "ROADMAP.md, queue 1"
            )
        batch = self.prepare_batch(batch)
        batch_stats = self.training or sample
        x, pos = batch.x, batch.pos
        for i in range(self.num_conv_layers):
            c, pos = self._conv(getattr(self, f"encoder_conv_{i}"), x, pos, batch, generator,
                                sample)
            if self.conv_use_batchnorm:
                c = getattr(self, f"encoder_bn_{i}")(c, batch.node_mask, batch_stats)
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
                    c, p = self._conv(getattr(self, f"head_{ihead}_conv_{il}"), h, p, batch,
                                      generator, sample)
                    c = getattr(self, f"head_{ihead}_bn_{il}")(c, batch.node_mask, batch_stats)
                    h = self.act(c)
                outputs.append(h)
            else:
                if node_index is None:
                    node_index = self.node_index_in_graph(batch)
                out = getattr(self, f"head_{ihead}_node")(x, node_index)
                outputs.append(torch.where(batch.node_mask[:, None], out, 0.0))
        return tuple(outputs)

    def loss(self, outputs, batch: GraphBatch):
        """Weighted multi-task loss: ``(total, per-task list)``, float32
        scalars. ``loss_weights`` are normalised by their abs-sum at
        construction. Under ``loss_nll`` the total is the unweighted sum of
        the heads' Gaussian NLLs and each task reports the MSE of the mean
        channel."""
        tot = 0.0
        tasks = []
        for ihead in range(self.num_heads):
            pred = outputs[ihead]
            target = batch.targets[ihead]
            mask = batch.graph_mask if self.output_type[ihead] == "graph" else batch.node_mask
            if self.loss_nll:
                d = self.output_dim[ihead]
                tot = tot + masked_gaussian_nll(pred[..., :d], pred[..., d:], target, mask)
                tasks.append(masked_error(pred[..., :d], target, mask, "mse"))
                continue
            err = masked_error(pred, target, mask, self.loss_function_type)
            tasks.append(err)
            tot = tot + self.loss_weights[ihead] * err
        return tot, tasks
