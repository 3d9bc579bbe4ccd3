"""SchNet stack (SCF) — continuous-filter convolutions (port of
``models/schnet.py``).

Per conv: the edge length (from ``pos`` by a safe square root, or the norm
of ``edge_attr``) expanded in Gaussians, a filter network ``filter_1(ssp(
filter_0(rbf)))`` times a cosine cutoff and the edge mask, ``h = x @
lin1``, the filtered sum ``sum_{j->i} h_j * w_ij`` (K6,
``fused_gather_weighted_sum``, in ``"fused"`` mode; the gather in PyTorch
and K1 in ``"segment"`` mode), then ``aggr @ lin2 + bias2``. No encoder
BatchNorm. With ``equivariance``, every conv but the last moves the
positions by the mean of a bounded coordinate update, summed at the
senders through K1.

A batch that carries the dense neighbour lists takes the dense frame
(``schnet.py:77-183`` of the JAX package): the positions gathered through
the lists, every per-edge value ``[N, K, *]`` masked by ``nbr_mask``, the
coordinate update summed at the senders through the reverse lists
(``ops/dense_agg.aggregate_to_senders``, the count from ``rev_mask``) and
the filtered sum a masked sum over K of ``gather_neighbors(h) * w``.

``lin1``, ``lin2``, ``bias2`` and ``coord_mlp_1`` are raw parameters in
the JAX package's ``x @ W`` layout (so the bridge copies them as they are);
the filter and coordinate layers are ``TorchLinear``s.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_sum
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import (
    TorchLinear,
    check_aggregation,
    gather_weighted_segment_sum,
    glorot_uniform_,
    matmul,
    safe_sqrt,
    small_uniform_,
)
from hydragnn_tpu_torch.ops.dense_agg import aggregate_to_senders, dense_sum, gather_neighbors


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


class GaussianSmearing(nn.Module):
    def __init__(self, start: float, stop: float, num_gaussians: int):
        super().__init__()
        offset = torch.linspace(start, stop, num_gaussians, dtype=torch.float32)
        self.register_buffer("offset", offset, persistent=False)
        self.coeff = -0.5 / float(offset[1] - offset[0]) ** 2

    def forward(self, dist):
        d = dist[..., None] - self.offset
        # coeff < 0, so the clamp changes nothing but bounds the exp
        return torch.exp(torch.clamp(self.coeff * d * d, max=0.0))


class CFConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_filters: int,
                 num_gaussians: int, cutoff: float, equivariant: bool,
                 use_edge_attr: bool, aggregation: str = "fused", device=None):
        super().__init__()
        self.aggregation = check_aggregation(aggregation)
        self.cutoff = cutoff
        self.equivariant = equivariant
        self.use_edge_attr = use_edge_attr
        self.smearing = GaussianSmearing(0.0, cutoff, num_gaussians).to(device)
        self.filter_0 = TorchLinear(num_gaussians, num_filters, device=device)
        self.filter_1 = TorchLinear(num_filters, num_filters, device=device)
        self.lin1 = nn.Parameter(torch.empty(in_dim, num_filters, device=device))
        if equivariant:
            self.coord_mlp_0 = TorchLinear(num_filters, num_filters, device=device)
            self.coord_mlp_1 = nn.Parameter(torch.empty(num_filters, 1, device=device))
        self.lin2 = nn.Parameter(torch.empty(num_filters, out_dim, device=device))
        self.bias2 = nn.Parameter(torch.empty(out_dim, device=device))

    def reset_parameters(self, generator: torch.Generator):
        glorot_uniform_(self.lin1, generator)
        glorot_uniform_(self.lin2, generator)
        if self.equivariant:
            small_uniform_(self.coord_mlp_1, generator)
        with torch.no_grad():
            self.bias2.zero_()

    def forward(self, x, pos, batch):
        n = x.shape[0]
        extras = batch.extras
        dense = "nbr_idx" in extras
        if dense:
            # the dense frame: every per-edge value is [N, K, *] (receiver,
            # slot); pos goes through the lists' gather, so the equivariant
            # backward is scatter-free too
            nbr, nmask = extras["nbr_idx"], extras["nbr_mask"]
            rev, rmask = extras["rev_idx"], extras["rev_mask"]
            pos_j = gather_neighbors(pos, nbr, rev, rmask)
            diff = pos_j - pos[:, None, :]
            emask = nmask[..., None]
            edge_attr = batch.edge_attr[extras["nbr_edge"].to(torch.int64)] \
                if self.use_edge_attr else None
        else:
            diff = pos[batch.senders.to(torch.int64)] - pos[batch.receivers.to(torch.int64)]
            emask = batch.edge_mask[:, None]
            edge_attr = batch.edge_attr
        if self.use_edge_attr:
            edge_weight = torch.linalg.vector_norm(edge_attr, dim=-1)
        else:
            edge_weight = safe_sqrt((diff * diff).sum(-1))
        rbf = self.smearing(edge_weight)

        w = self.filter_1(shifted_softplus(self.filter_0(rbf)))
        cos_cut = 0.5 * (torch.cos(edge_weight * math.pi / self.cutoff) + 1.0)
        w = torch.where(emask, w * cos_cut[..., None], 0.0)
        h = matmul(x, self.lin1)

        if self.equivariant:
            coord_diff = diff / (safe_sqrt((diff * diff).sum(-1, keepdim=True)) + 1.0)
            cw = matmul(F.relu(self.coord_mlp_0(w)), self.coord_mlp_1)
            trans = torch.where(emask, torch.clamp(coord_diff * cw, -100.0, 100.0), 0.0)
            if dense:
                # the sum at the senders through the reverse lists; the
                # count is the real out-degree
                agg = aggregate_to_senders(trans, nbr, nmask, rev, rmask)
                cnt = rmask.sum(dim=1).to(trans.dtype)
            else:
                # the update and the real out-degree from one pass at the senders
                both = segment_sum(
                    torch.cat([trans, batch.edge_mask.to(trans.dtype)[:, None]], -1),
                    batch.senders, n,
                )
                agg, cnt = both[:, :3], both[:, 3]
            pos = pos + agg / torch.clamp(cnt, min=1.0)[:, None]

        if dense:
            aggr = dense_sum(gather_neighbors(h, nbr, rev, rmask) * w, nmask)
        else:
            aggr = gather_weighted_segment_sum(
                h, w, batch.senders, batch.receivers, n, self.aggregation
            )
        return matmul(aggr, self.lin2) + self.bias2, pos


class SCFStack(HydraBase):
    conv_use_batchnorm = False  # Identity feature layers, as the reference
    dense_branch = True
    conv_needs_pos = True

    def __init__(self, num_filters: int, num_gaussians: int, radius: float,
                 device=None, **common):
        super().__init__(**common)
        self.num_filters = num_filters
        self.num_gaussians = num_gaussians
        self.radius = radius
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        return CFConv(
            in_dim, out_dim,
            num_filters=self.num_filters,
            num_gaussians=self.num_gaussians,
            cutoff=self.radius,
            equivariant=self.equivariance and not last_layer,
            use_edge_attr=self.use_edge_attr,
            aggregation=self.aggregation,
            device=device,
        )
