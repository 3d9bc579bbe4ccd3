"""EGNN stack — E(n)-equivariant graph convolution (port of
``models/egnn.py``).

E_GCL: an edge MLP on ``[h_sender, h_receiver, |dx|^2, e_ij]`` (two
Linear + ReLU), the messages summed at the **sender**, a node MLP on ``[h,
aggregated messages]``; with ``equivariance``, every conv but the last also
moves the positions by the mean of a tanh-bounded coordinate update. No
encoder BatchNorm.

As in the JAX package, the first edge-MLP layer is split by linearity into
node-axis products (``SplitLinear`` pieces of ``edge_mlp_0``: ``y_snd =
x @ W_s``, ``y_rcv = x @ W_r + b``, the radial row ``w_rad``), which stay
``torch.matmul``s. The edge phase then runs as:

- ``"fused"`` (``HYDRAGNN_AGG=fused``): K7, ``fused_egnn_edge_phase`` —
  gather, radial term, both edge-MLP products, the coordinate weight and
  the packed ``[e, (trans,) mask]`` sum at the senders in one kernel;
- ``"segment"`` (``HYDRAGNN_PALLAS=1``): the same math in PyTorch on
  gathered rows, then K1 at the senders.
"""

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_sum
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import (
    SplitLinear,
    TorchLinear,
    check_aggregation,
    matmul,
    safe_sqrt,
    small_uniform_,
)
from hydragnn_tpu_torch.ops import fused_egnn_edge_phase
from hydragnn_tpu_torch.ops.segment_kernels import upcast


class E_GCL(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 edge_attr_dim: int, equivariant: bool,
                 aggregation: str = "fused", device=None):
        super().__init__()
        self.aggregation = check_aggregation(aggregation)
        self.in_dim = in_dim
        self.hidden_dim = hidden_dim
        self.edge_attr_dim = edge_attr_dim
        self.equivariant = equivariant
        fan_in = 2 * in_dim + 1 + edge_attr_dim
        self.edge_mlp_0 = SplitLinear(fan_in, hidden_dim, device=device)
        self.edge_mlp_1 = TorchLinear(hidden_dim, hidden_dim, device=device)
        if equivariant:
            self.coord_mlp_0 = TorchLinear(hidden_dim, hidden_dim, device=device)
            self.coord_mlp_1 = nn.Parameter(torch.empty(hidden_dim, 1, device=device))
        self.node_mlp_0 = TorchLinear(in_dim + hidden_dim, hidden_dim, device=device)
        self.node_mlp_1 = TorchLinear(hidden_dim, out_dim, device=device)

    def reset_parameters(self, generator: torch.Generator):
        if self.equivariant:
            small_uniform_(self.coord_mlp_1, generator)

    def forward(self, x, pos, batch):
        n, hd = x.shape[0], self.hidden_dim
        pre = self.edge_mlp_0
        y_snd = pre.piece(x, 0)  # sender side [N, H]
        y_rcv = pre.piece(x, self.in_dim) + pre.bias  # receiver side + bias
        w_rad = pre.weight[:, 2 * self.in_dim]  # [H] radial column
        ze = (
            pre.piece(batch.edge_attr, 2 * self.in_dim + 1)
            if self.edge_attr_dim > 0 else None
        )
        if self.aggregation == "fused":
            params = [w_rad.contiguous(), self.edge_mlp_1.weight.t().contiguous(),
                      self.edge_mlp_1.bias]
            if self.equivariant:
                params += [self.coord_mlp_0.weight.t().contiguous(),
                           self.coord_mlp_0.bias, self.coord_mlp_1]
            both = fused_egnn_edge_phase(
                upcast(y_snd), upcast(y_rcv), pos, [upcast(p) for p in params],
                batch.senders, batch.receivers, n, batch.edge_mask, ze=upcast(ze),
            )
            agg = both[:, :hd].to(x.dtype)  # the kernel's f32, back to x's dtype
        else:
            # at e's dtype, as the JAX package's segment branch leaves it
            both = self._edge_phase_segment(y_snd, y_rcv, w_rad, ze, pos, batch)
            agg = both[:, :hd]
        if self.equivariant:
            pos = pos + both[:, hd : hd + 3] / torch.clamp(both[:, -1], min=1.0)[:, None]
        h = F.relu(self.node_mlp_0(torch.cat([x, agg], dim=-1)))
        return self.node_mlp_1(h), pos

    def _edge_phase_segment(self, y_snd, y_rcv, w_rad, ze, pos, batch):
        """``e`` (or, equivariant, the packed ``[e, trans, mask]``) summed
        at the senders: the edge math in PyTorch on gathered rows, then
        K1."""
        row = batch.senders.to(torch.int64)
        col = batch.receivers.to(torch.int64)
        emask = batch.edge_mask[:, None]
        coord_diff = pos[row] - pos[col]
        radial = (coord_diff * coord_diff).sum(-1, keepdim=True)
        coord_diff = coord_diff / (safe_sqrt(radial) + 1.0)
        e = y_snd[row] + y_rcv[col] + radial * w_rad
        if ze is not None:
            e = e + ze
        e = F.relu(self.edge_mlp_1(F.relu(e)))
        e = torch.where(emask, e, 0.0)
        if self.equivariant:
            cw = torch.tanh(matmul(F.relu(self.coord_mlp_0(e)), self.coord_mlp_1))
            trans = torch.where(emask, torch.clamp(coord_diff * cw, -100.0, 100.0), 0.0)
            e = torch.cat([e, trans, emask.to(e.dtype)], dim=-1)
        return segment_sum(e, batch.senders, pos.shape[0])


class EGCLStack(HydraBase):
    conv_use_batchnorm = False  # Identity feature layers, as the reference

    def __init__(self, device=None, **common):
        super().__init__(**common)
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        return E_GCL(
            in_dim, out_dim, self.hidden_dim,
            edge_attr_dim=self.edge_dim or 0,
            equivariant=self.equivariance and not last_layer,
            aggregation=self.aggregation,
            device=device,
        )
