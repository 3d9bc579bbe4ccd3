"""MFC stack — Molecular Fingerprint Convolution (port of ``models/mfc.py``).

``out_i = h_i @ w_l[d_i] + x_i @ w_r[d_i] + b_l[d_i]``, with ``h_i`` the
sum of the senders' rows (K1 in the segment branch; a masked sum over K
in the dense one) and ``d_i`` the real in-degree, clamped to the top bank
kept. The banks are stacked parameters ``w_l``, ``w_r`` ``[K+1, in,
out]`` and ``b_l`` ``[K+1, out]`` (``K`` the config's ``max_neighbours``),
applied as the JAX package applies them: one matmul of the one-hot degree
expansion ``[N, 2 * k_used * in]`` with the banks stacked ``[2 * k_used *
in, out]``. Gathering ``w[d_i]`` instead would materialise one ``[in,
out]`` matrix per node (``[N, 256, 256]`` at hidden 256); the expansion
spends ``k_used`` times the least FLOPs, but in one dense product. Banks
no batch can select are sliced off: above the dataset's
``degree_bound`` (``mfc_degree_bound``) and above the dense lists' width.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_count, segment_sum
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import matmul, uniform_
from hydragnn_tpu_torch.ops.dense_agg import dense_sum, gather_neighbors


class MFConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, max_degree: int,
                 degree_bound: Optional[int] = None, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.degree_bound = degree_bound
        k = max_degree + 1
        self.w_l = nn.Parameter(torch.empty(k, in_dim, out_dim, device=device))
        self.b_l = nn.Parameter(torch.empty(k, out_dim, device=device))
        self.w_r = nn.Parameter(torch.empty(k, in_dim, out_dim, device=device))

    def reset_parameters(self, generator: torch.Generator):
        bound = 1.0 / self.in_dim ** 0.5
        for p in (self.w_l, self.b_l, self.w_r):
            uniform_(p, bound, generator)

    def forward(self, x, pos, batch):
        n = x.shape[0]
        extras = batch.extras
        k_used = self.w_l.shape[0]
        if self.degree_bound is not None:
            k_used = min(k_used, self.degree_bound + 1)
        if "nbr_idx" in extras:
            nmask = extras["nbr_mask"]
            x_j = gather_neighbors(x, extras["nbr_idx"], extras["rev_idx"], extras["rev_mask"])
            h = dense_sum(x_j, nmask)
            deg = nmask.sum(dim=1).to(torch.float32)
            k_used = min(k_used, nmask.shape[1] + 1)
        else:
            msg = torch.where(batch.edge_mask[:, None], x.index_select(0, batch.senders), 0.0)
            h = segment_sum(msg, batch.receivers, n)
            deg = segment_count(batch.receivers, n, weights=batch.edge_mask)
        # a degree above the banks kept takes the top one (never a zero row)
        deg = torch.clamp(deg.to(torch.int64), 0, k_used - 1)
        onehot = F.one_hot(deg, k_used).to(h.dtype)
        expanded = torch.cat([
            (onehot[:, :, None] * h[:, None, :]).reshape(n, -1),
            (onehot[:, :, None] * x[:, None, :]).reshape(n, -1),
        ], dim=1)
        w = torch.cat([
            self.w_l[:k_used].reshape(k_used * self.in_dim, self.out_dim),
            self.w_r[:k_used].reshape(k_used * self.in_dim, self.out_dim),
        ], dim=0)
        return matmul(expanded, w) + self.b_l[deg], pos


class MFCStack(HydraBase):
    dense_branch = True

    def __init__(self, max_degree: int = 10, degree_bound: Optional[int] = None,
                 device=None, **common):
        super().__init__(**common)
        self.max_degree = max_degree
        self.degree_bound = degree_bound
        self.build(device=device)

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        return MFConv(in_dim, out_dim, max_degree=self.max_degree,
                      degree_bound=self.degree_bound, device=device)
