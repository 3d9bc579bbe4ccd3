"""GraphSAGE stack (port of ``models/sage.py``).

``out = lin_l(mean_{j->i} x_j) + lin_r(x_i)``, ``lin_r`` without a bias;
the mean runs over real incoming edges only (sum over the mask's in-degree,
at least 1). The mean is K5, ``fused_gather_mean`` (``"fused"``), or the
gather in PyTorch, K1 and a count of the mask (``"segment"``); a batch that
carries the dense neighbour lists takes the dense branch (the masked sum
over K of the gathered rows, over the degree that ``nbr_mask`` counts).
"""

import torch
from torch import nn

from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import TorchLinear, check_aggregation, gather_segment_mean
from hydragnn_tpu_torch.ops.dense_agg import dense_sum, gather_neighbors


class SAGEConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, aggregation: str = "fused",
                 device=None):
        super().__init__()
        self.aggregation = check_aggregation(aggregation)
        self.lin_l = TorchLinear(in_dim, out_dim, device=device)
        self.lin_r = TorchLinear(in_dim, out_dim, bias=False, device=device)

    def forward(self, x, pos, batch):
        extras = batch.extras
        if "nbr_idx" in extras:
            nmask = extras["nbr_mask"]
            x_j = gather_neighbors(x, extras["nbr_idx"], extras["rev_idx"], extras["rev_mask"])
            deg = nmask.sum(dim=1).to(x.dtype)
            aggr = dense_sum(x_j, nmask) / torch.clamp(deg, min=1.0)[:, None]
        else:
            aggr = gather_segment_mean(
                x, batch.senders, batch.receivers, x.shape[0], batch.edge_mask,
                self.aggregation,
            )
        return self.lin_l(aggr) + self.lin_r(x), pos


class SAGEStack(HydraBase):
    dense_branch = True

    def __init__(self, device=None, **common):
        super().__init__(**common)
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        return SAGEConv(in_dim, out_dim, aggregation=self.aggregation, device=device)
