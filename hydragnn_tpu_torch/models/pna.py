"""PNA stack — Principal Neighbourhood Aggregation (port of ``models/pna.py``).

Aggregators [mean, min, max, std] x scalers [identity, amplification,
attenuation, linear], degree statistics from the dataset's degree
histogram, one pre-layer and one post-layer, optional edge encoder.

The message MLP is one Linear, so ``m = yi[receiver] + z[edge]`` with
``yi = x @ Wi + b``, ``yj = x @ Wj`` from node-axis products and
``z = yj[sender] (+ e @ We)``; every aggregator of ``m`` reduces to one of
``z`` shifted by ``yi`` (std ignores the shift). The statistics of ``z``
come from one of two kernels, chosen by ``aggregation``:

- ``"fused"`` (the JAX package's ``HYDRAGNN_AGG=fused``): K3,
  ``fused_gather_moments`` gathers, masks and reduces in one pass and
  hands back ``z`` for the min/max pass;
- ``"segment"`` (``HYDRAGNN_PALLAS=1``): the gather and mask in PyTorch,
  then K2, ``segment_moments``.

The dense neighbour-list branch is not ported (see ``ROADMAP.md``).
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_minmax_fused
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import SplitLinear, TorchLinear
from hydragnn_tpu_torch.ops import fused_gather_moments, segment_moments

AGGREGATIONS = ("fused", "segment")


def pna_degree_averages(deg_histogram) -> Tuple[float, float]:
    """``(avg_log, avg_lin)`` degree statistics from a degree histogram."""
    total = max(float(sum(deg_histogram)), 1.0)
    avg_log = sum(h * math.log(d + 1.0) for d, h in enumerate(deg_histogram)) / total
    avg_lin = sum(h * float(d) for d, h in enumerate(deg_histogram)) / total
    return max(avg_log, 1e-12), max(avg_lin, 1e-12)


class PNAConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, avg_deg_log: float,
                 avg_deg_lin: float, edge_dim: Optional[int] = None,
                 aggregation: str = "fused", device=None):
        super().__init__()
        if aggregation not in AGGREGATIONS:
            raise ValueError(
                f"aggregation must be one of {AGGREGATIONS}, got {aggregation!r}"
            )
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.avg_deg_log = avg_deg_log
        self.avg_deg_lin = avg_deg_lin
        self.aggregation = aggregation
        self.use_edge = edge_dim is not None and edge_dim > 0
        fan_in = 2 * in_dim + (in_dim if self.use_edge else 0)
        self.pre_nn = SplitLinear(fan_in, in_dim, device=device)
        if self.use_edge:
            self.edge_encoder = TorchLinear(edge_dim, in_dim, device=device)
        # input: x (in_dim) + 4 aggregators x 4 scalers x in_dim
        self.post_nn = TorchLinear(17 * in_dim, out_dim, device=device)
        self.lin = TorchLinear(out_dim, out_dim, device=device)

    def forward(self, x, pos, batch):
        n = x.shape[0]
        pre = self.pre_nn
        yi = pre.piece(x, 0) + pre.bias  # [N, D]
        yj = pre.piece(x, self.in_dim)  # [N, D]
        ze = None  # [E, D] encoded-edge contribution
        if self.use_edge:
            ze = pre.piece(self.edge_encoder(batch.edge_attr), 2 * self.in_dim)

        if self.aggregation == "fused":
            s, cnt, sq, z = fused_gather_moments(
                yj, batch.senders, batch.receivers, n, batch.edge_mask, ze=ze
            )
            # back to the caller's dtype (the kernel accumulates in f32)
            s, cnt, sq, z = (a.to(yj.dtype) for a in (s, cnt, sq, z))
        else:
            z = yj[batch.senders.to(torch.int64)]  # [E, D]
            if ze is not None:
                z = z + ze
            z = torch.where(batch.edge_mask[:, None], z, 0.0)
            s, cnt, sq = segment_moments(z, batch.receivers, n)
        has = cnt > 0
        deg = torch.clamp(cnt, min=1.0)
        mean_z = s / deg
        # PNA std numerics: sqrt(relu(E[z^2] - E[z]^2) + eps), identical for
        # m = yi + z because the variance ignores the constant shift
        std = torch.sqrt(torch.clamp(sq / deg - mean_z * mean_z, min=0.0) + 1e-5)
        mn_z, mx_z = segment_minmax_fused(z, batch.receivers, n, has=has)

        # shift yi back in; empty receivers keep the fill of 0
        mean = torch.where(has, yi + mean_z, 0.0)
        mn = torch.where(has, yi + mn_z, 0.0)
        mx = torch.where(has, yi + mx_z, 0.0)
        aggr = torch.cat([mean, mn, mx, std], dim=-1)
        log_deg = torch.log(deg + 1.0)
        scaled = torch.cat(
            [
                aggr,  # identity
                aggr * (log_deg / self.avg_deg_log),  # amplification
                aggr * (self.avg_deg_log / log_deg),  # attenuation
                aggr * (deg / self.avg_deg_lin),  # linear
            ],
            dim=-1,
        )
        out = self.post_nn(torch.cat([x, scaled], dim=-1))
        return self.lin(out), pos


class PNAStack(HydraBase):
    """PNA with the degree histogram ``deg`` and an aggregation mode."""

    def __init__(self, deg, aggregation: str = "fused", device=None, **common):
        super().__init__(**common)
        if aggregation not in AGGREGATIONS:
            raise ValueError(
                f"aggregation must be one of {AGGREGATIONS}, got {aggregation!r}"
            )
        self.deg = tuple(deg)
        self.aggregation = aggregation
        self.avg_deg_log, self.avg_deg_lin = pna_degree_averages(self.deg)
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, device=None):
        return PNAConv(
            in_dim,
            out_dim,
            self.avg_deg_log,
            self.avg_deg_lin,
            edge_dim=self.edge_dim if self.use_edge_attr else None,
            aggregation=self.aggregation,
            device=device,
        )
