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
  gathered rows, then K1 at the senders;
- a batch that carries the dense neighbour lists: the same math on
  ``[N, K, *]`` slots gathered through the lists, summed at the senders
  through the reverse lists (``ops/dense_agg``, PyTorch ops).

``fused`` trains through K7's backward rule (``fused_egnn_edge_phase_vjp``),
which also returns ``pos``'s gradient.
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
from hydragnn_tpu_torch.ops import fused_egnn_edge_phase_vjp
from hydragnn_tpu_torch.ops.dense_agg import aggregate_to_senders, gather_neighbors


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
        ze = (  # the dense branch gathers the narrow edge_attr first
            pre.piece(batch.edge_attr, 2 * self.in_dim + 1)
            if self.edge_attr_dim > 0 and "nbr_idx" not in batch.extras else None
        )
        if "nbr_idx" in batch.extras:
            both = self._edge_phase_dense(y_snd, y_rcv, w_rad, pos, batch)
            agg = both[:, :hd]
        elif self.aggregation == "fused":
            params = [w_rad.contiguous(), self.edge_mlp_1.weight.t().contiguous(),
                      self.edge_mlp_1.bias]
            if self.equivariant:
                params += [self.coord_mlp_0.weight.t().contiguous(),
                           self.coord_mlp_0.bias, self.coord_mlp_1]
            both = fused_egnn_edge_phase_vjp(
                y_snd, y_rcv, pos, params, batch.senders, batch.receivers, n,
                batch.edge_mask, ze=ze,
            )
            agg = both[:, :hd].to(x.dtype)  # the kernel's f32, back to x's dtype
        else:
            # at e's dtype, as the JAX package's segment branch leaves it
            both = self._edge_phase_segment(y_snd, y_rcv, ze, w_rad, pos, batch)
            agg = both[:, :hd]
        if self.equivariant:
            pos = pos + both[:, hd : hd + 3] / torch.clamp(both[:, -1], min=1.0)[:, None]
        h = F.relu(self.node_mlp_0(torch.cat([x, agg], dim=-1)))
        return self.node_mlp_1(h), pos

    def _edge_phase_segment(self, y_snd, y_rcv, ze, w_rad, pos, batch):
        """``e`` (or, equivariant, the packed ``[e, trans, mask]``) summed
        at the senders: the edge math in PyTorch on gathered rows, then
        K1."""
        row = batch.senders.to(torch.int64)
        col = batch.receivers.to(torch.int64)
        packed = self._messages(y_snd[row], y_rcv[col], ze, pos[row] - pos[col], w_rad,
                                batch.edge_mask[:, None])
        return segment_sum(packed, batch.senders, pos.shape[0])

    def _edge_phase_dense(self, y_snd, y_rcv, w_rad, pos, batch):
        """The same sum in the dense frame (``egnn.py:156-230`` of the JAX
        package): one gather of ``[y_snd, pos]`` through the lists (its
        backward, through the reverse lists, carries ``pos``'s gradient
        too), the messages ``[N, K, *]`` summed at the senders through the
        reverse lists (``aggregate_to_senders``)."""
        extras = batch.extras
        nbr, nmask = extras["nbr_idx"], extras["nbr_mask"]
        rev, rmask = extras["rev_idx"], extras["rev_mask"]
        hd = self.hidden_dim
        both_j = gather_neighbors(torch.cat([y_snd, pos], dim=-1), nbr, rev, rmask)
        ze = None
        if self.edge_attr_dim > 0:
            # the narrow edge_attr gathered first, projected after
            edge_attr = batch.edge_attr[extras["nbr_edge"].to(torch.int64)]
            ze = self.edge_mlp_0.piece(edge_attr, 2 * self.in_dim + 1)
        packed = self._messages(both_j[..., :hd], y_rcv[:, None, :], ze,
                                both_j[..., hd:] - pos[:, None, :], w_rad, nmask[..., None])
        return aggregate_to_senders(packed, nbr, nmask, rev, rmask)

    def _messages(self, y_s, y_r, ze, coord_diff, w_rad, emask):
        """The edge MLP on the gathered rows ``y_s``, ``y_r`` (and ``ze``)
        with the radial term of ``coord_diff`` and, equivariant, the bounded
        coordinate update: ``e`` or the packed ``[e, trans, mask]``, masked
        by ``emask`` (the JAX package's order of operations)."""
        radial = (coord_diff * coord_diff).sum(-1, keepdim=True)
        coord_diff = coord_diff / (safe_sqrt(radial) + 1.0)
        e = y_s + y_r + radial * w_rad
        if ze is not None:
            e = e + ze
        e = F.relu(self.edge_mlp_1(F.relu(e)))
        e = torch.where(emask, e, 0.0)
        if not self.equivariant:
            return e
        cw = torch.tanh(matmul(F.relu(self.coord_mlp_0(e)), self.coord_mlp_1))
        trans = torch.where(emask, torch.clamp(coord_diff * cw, -100.0, 100.0), 0.0)
        return torch.cat([e, trans, emask.to(trans.dtype)], dim=-1)


class EGCLStack(HydraBase):
    conv_use_batchnorm = False  # Identity feature layers, as the reference
    dense_branch = True

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
