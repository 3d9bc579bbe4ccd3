"""GAT stack — GATv2 attention (port of ``models/gat.py``).

Per conv, ``heads`` (6) attention heads of width ``C`` (the layer's out
width): ``x_l = x @ w_l + b_l``, ``x_r = x @ w_r + b_r``, the logit of an
edge ``j->i`` ``sum_c att * leaky_relu(x_l[j] + x_r[i], 0.05)``, a softmax
over each receiver's edges and its self-loop, the weighted sum of ``x_l``,
then heads concatenated (hidden layers) or averaged (the last layer), plus
``bias``. Attention dropout (``dropout``, 0.25) acts on the softmax's
numerator terms in ``train()`` mode (or with the forward's ``sample``),
drawn from the forward's
``torch.Generator``; the denominator keeps them undropped, as in the JAX
package (the ``1/(1-p)`` scale commutes with the division).

Segment branch: the self-loops are a second block of virtual edges, the
softmax's numerator is :func:`graph.segment.segment_softmax_unnorm`, and
the weighted messages and the denominator are summed in one K1 launch of
width ``heads * (C + 1)``. Dense branch (a batch with the neighbour
lists): the softmax is local over the K slots and the self slot, and the
weighted sum contracts K in float32 (the JAX ``einsum``'s
``preferred_element_type``).

``w_l``, ``b_l``, ``w_r``, ``b_r``, ``att`` and ``bias`` are raw parameters
in the JAX package's ``x @ W`` layout (the bridge copies them as they are).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_softmax_unnorm, segment_sum
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import draw_keep, glorot_uniform_, matmul, uniform_
from hydragnn_tpu_torch.ops.dense_agg import gather_neighbors


def attention_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: each entry kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else 0; the draws come from
    ``generator`` (on ``x``'s device)."""
    if generator is None:
        raise ValueError(
            "attention dropout in train() mode needs a torch.Generator: pass "
            "generator= to the forward (Trainer does), or set_dropout(0.0)"
        )
    keep = draw_keep(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GATv2Conv(nn.Module):
    stochastic = True  # takes the forward's generator (HydraBase._conv)

    def __init__(self, in_dim: int, out_dim: int, heads: int, negative_slope: float,
                 dropout: float, concat: bool, device=None):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.concat = concat
        hc = heads * out_dim
        self.w_l = nn.Parameter(torch.empty(in_dim, hc, device=device))
        self.b_l = nn.Parameter(torch.empty(hc, device=device))
        self.w_r = nn.Parameter(torch.empty(in_dim, hc, device=device))
        self.b_r = nn.Parameter(torch.empty(hc, device=device))
        self.att = nn.Parameter(torch.empty(1, heads, out_dim, device=device))
        self.bias = nn.Parameter(torch.empty(hc if concat else out_dim, device=device))

    def reset_parameters(self, generator: torch.Generator):
        glorot_uniform_(self.w_l, generator)
        glorot_uniform_(self.w_r, generator)
        # flax's xavier_uniform on [1, H, C]: fan_in H, fan_out C
        uniform_(self.att, math.sqrt(6.0 / (self.heads + self.out_dim)), generator)
        with torch.no_grad():
            for p in (self.b_l, self.b_r, self.bias):
                p.zero_()

    def _drop(self, x, generator, sample):
        if not (self.training or sample) or self.dropout == 0.0:
            return x
        return attention_dropout(x, self.dropout, generator)

    def _logits(self, x_j, x_i):
        return (F.leaky_relu(x_j + x_i, self.negative_slope) * self.att).sum(dim=-1)

    def forward(self, x, pos, batch, generator=None, sample=False):
        n = x.shape[0]
        h, c = self.heads, self.out_dim
        x_l = (matmul(x, self.w_l) + self.b_l).reshape(n, h, c)
        x_r = (matmul(x, self.w_r) + self.b_r).reshape(n, h, c)
        extras = batch.extras
        if "nbr_idx" in extras:
            nmask = extras["nbr_mask"]
            xl_j = gather_neighbors(
                x_l.reshape(n, h * c), extras["nbr_idx"], extras["rev_idx"], extras["rev_mask"]
            ).reshape(n, -1, h, c)  # [N, K, H, C]
            k = xl_j.shape[1]
            alpha_n = self._logits(xl_j, x_r[:, None])  # [N, K, H]
            alpha_s = self._logits(x_l, x_r)  # [N, H]: the self-loop
            alpha_n = torch.where(nmask[..., None], alpha_n, -1e9)
            alpha_s = torch.where(batch.node_mask[:, None], alpha_s, -1e9)
            # a padded node: amax -1e9, exp(0) = 1, masked to 0 below
            amax = torch.maximum(alpha_n.amax(dim=1), alpha_s)[:, None]
            ex_n = torch.where(nmask[..., None], torch.exp(alpha_n - amax), 0.0)
            ex_s = torch.where(batch.node_mask[:, None], torch.exp(alpha_s - amax[:, 0]), 0.0)
            exd = self._drop(torch.cat([ex_n, ex_s[:, None]], dim=1), generator, sample)
            f32 = torch.float32
            num = torch.einsum("nkh,nkhc->nhc", exd[:, :k].to(f32), xl_j.to(f32)).to(x_l.dtype)
            num = num + exd[:, k][..., None] * x_l
            den = ex_n.sum(dim=1) + ex_s  # [N, H]
            out = num / torch.clamp(den[..., None], min=1e-16)
        else:
            # real edges, then one self-loop per node
            loop = torch.arange(n, dtype=batch.senders.dtype, device=x.device)
            send = torch.cat([batch.senders, loop])
            recv = torch.cat([batch.receivers, loop])
            emask = torch.cat([batch.edge_mask, batch.node_mask])
            xl_s = x_l.index_select(0, send)
            alpha = self._logits(xl_s, x_r.index_select(0, recv))  # [E+N, H]
            ex = segment_softmax_unnorm(alpha, recv, n, mask=emask)
            exd = self._drop(ex, generator, sample)
            # the numerator and the denominator in one sum: [E+N, H, C+1]
            packed = torch.cat([xl_s * exd[..., None], ex[..., None]], dim=-1)
            s = segment_sum(packed.reshape(packed.shape[0], h * (c + 1)), recv, n)
            s = s.reshape(n, h, c + 1)
            out = s[..., :c] / torch.clamp(s[..., -1:], min=1e-16)
        out = out.reshape(n, h * c) if self.concat else out.mean(dim=1)
        return out + self.bias, pos


class GATStack(HydraBase):
    dense_branch = True

    def __init__(self, heads: int = 6, negative_slope: float = 0.05, device=None, **common):
        super().__init__(**common)
        self.heads = heads
        self.negative_slope = negative_slope
        self.build(device=device)

    def conv_layer_specs(self):
        # heads concatenated on every encoder layer but the last
        hh = self.hidden_dim * self.heads
        specs = [(self.input_dim, self.hidden_dim, hh, {"concat": True})]
        specs += [(hh, self.hidden_dim, hh, {"concat": True})] * (self.num_conv_layers - 2)
        specs.append((hh, self.hidden_dim, self.hidden_dim, {"concat": False}))
        return specs

    def node_conv_specs(self, node_cfg, head_dim):
        # concatenated on a conv head's hidden convs, averaged on its output
        dims, h = node_cfg["dim_headlayers"], self.heads
        specs = [(self.hidden_dim, dims[0], dims[0] * h, {"concat": True})]
        for il in range(node_cfg["num_headlayers"] - 1):
            specs.append((dims[il] * h, dims[il + 1], dims[il + 1] * h, {"concat": True}))
        specs.append((dims[-1] * h, head_dim, head_dim, {"concat": False}))
        return specs

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None, concat=True):
        return GATv2Conv(in_dim, out_dim, heads=self.heads, negative_slope=self.negative_slope,
                         dropout=self.dropout, concat=concat, device=device)
