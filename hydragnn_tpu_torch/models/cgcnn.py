"""CGCNN stack — crystal graph convolutions (port of ``models/cgcnn.py``).

``z_ij = [x_i, x_j, e_ij]``; ``out_i = x_i + sum_{j->i} sigmoid(lin_f(z)) *
softplus(lin_s(z))``. The width is constant: the factory builds the stack
at ``hidden_dim = input_dim``, and refuses a ``conv`` node head. The sum
is K1 in the segment branch, a masked sum over K in the dense one.
"""

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_sum
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import TorchLinear
from hydragnn_tpu_torch.ops.dense_agg import dense_sum, gather_neighbors


class CGConv(nn.Module):
    def __init__(self, channels: int, edge_dim: int = 0, device=None):
        super().__init__()
        self.edge_dim = edge_dim
        z_dim = 2 * channels + edge_dim
        self.lin_f = TorchLinear(z_dim, channels, device=device)
        self.lin_s = TorchLinear(z_dim, channels, device=device)

    def forward(self, x, pos, batch):
        extras = batch.extras
        dense = "nbr_idx" in extras
        if dense:
            x_j = gather_neighbors(x, extras["nbr_idx"], extras["rev_idx"], extras["rev_mask"])
            parts = [x[:, None, :].expand_as(x_j), x_j]
            if self.edge_dim > 0:
                parts.append(batch.edge_attr[extras["nbr_edge"].to(torch.int64)])
        else:
            parts = [x.index_select(0, batch.receivers), x.index_select(0, batch.senders)]
            if self.edge_dim > 0:
                parts.append(batch.edge_attr)
        z = torch.cat(parts, dim=-1)
        msg = torch.sigmoid(self.lin_f(z)) * F.softplus(self.lin_s(z))
        if dense:
            return x + dense_sum(msg, extras["nbr_mask"]), pos
        msg = torch.where(batch.edge_mask[:, None], msg, 0.0)
        return x + segment_sum(msg, batch.receivers, x.shape[0]), pos


class CGCNNStack(HydraBase):
    dense_branch = True

    def __init__(self, device=None, **common):
        super().__init__(**common)
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        # the width is the input's: in_dim is both in and out
        return CGConv(in_dim, edge_dim=self.edge_dim or 0, device=device)
