"""GIN stack — Graph Isomorphism Network (port of ``models/gin.py``).

``out = mlp_1(relu(mlp_0((1 + eps) * x_i + sum_{j->i} x_j)))`` with a
trainable scalar ``eps`` initialised at 100.0. The neighbour sum is K4,
``fused_gather_sum`` (``aggregation="fused"``), or the gather in PyTorch
and K1 (``"segment"``); a batch that carries the dense neighbour lists
takes the dense branch (``ops/dense_agg``: the gather through the lists
and a masked sum over K, PyTorch ops).
"""

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import TorchLinear, check_aggregation, gather_segment_sum
from hydragnn_tpu_torch.ops.dense_agg import dense_sum, gather_neighbors


class GINConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, aggregation: str = "fused",
                 eps_init: float = 100.0, device=None):
        super().__init__()
        self.aggregation = check_aggregation(aggregation)
        self.eps_init = eps_init
        self.eps = nn.Parameter(torch.empty((), device=device))
        self.mlp_0 = TorchLinear(in_dim, out_dim, device=device)
        self.mlp_1 = TorchLinear(out_dim, out_dim, device=device)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.eps.fill_(self.eps_init)

    def forward(self, x, pos, batch):
        extras = batch.extras
        if "nbr_idx" in extras:
            x_j = gather_neighbors(x, extras["nbr_idx"], extras["rev_idx"], extras["rev_mask"])
            aggr = dense_sum(x_j, extras["nbr_mask"])
        else:
            aggr = gather_segment_sum(
                x, batch.senders, batch.receivers, x.shape[0], batch.edge_mask,
                self.aggregation,
            )
        h = (1.0 + self.eps) * x + aggr
        # the reference hardcodes ReLU inside the conv's MLP
        return self.mlp_1(F.relu(self.mlp_0(h))), pos


class GINStack(HydraBase):
    dense_branch = True

    def __init__(self, device=None, **common):
        super().__init__(**common)
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        return GINConv(in_dim, out_dim, aggregation=self.aggregation, device=device)
