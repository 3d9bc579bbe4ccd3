"""DimeNet++ stack — directional message passing (port of
``models/dimenet.py``).

Per conv: a linear embedding of the node rows, an embedding block on the
edges (``emb_*``), an interaction block (``int_*``: the radial and
spherical bases projected, the triplet aggregation, residual layers
``before_skip_*`` / ``after_skip_*``) and an output block (``out_*``: the
edges summed at their receivers). No encoder BatchNorm. The bases: the
Bessel radial basis with a learned ``freq`` (``rbf``), and the spherical
basis ``env(d) j_l(z_ln d) P_l(cos angle)``, with ``j_l`` the spherical
Bessel functions by upward recurrence and ``P_l`` the Legendre
polynomials by recurrence, as the JAX package computes them. (In float32
the upward recurrence loses ``j_l`` where ``z d`` is small: both packages
share that, and the tests hold the port to the JAX package's own float32
error against a float64 evaluation.)

Two geometries, each computed once per forward by
:meth:`DIMEStack.prepare_batch` (no parameters, so every conv shares it),
in float32 whatever the compute dtype:

- triplet tables (``trip_*``, ``graph.batch.pack_triplets``): the angle per
  triplet ``k->j->i`` by ``atan2``, the basis ``[T, S*R]``, and the
  aggregation ``sum_{k} x_kj[k->j] * sbf`` over the T axis as one K1 launch
  with ``E`` segments (``trip_ji``);
- the dense lists with the slot tables (``ops.dense_agg``,
  ``with_slot_tables``): every triplet regrouped under its central node
  ``j`` as an (out-slot, in-slot) grid, ``cos`` of the angle as ``a *
  rsqrt(a^2 + b^2)``, the masks folded into the Legendre part ``[N, Ko,
  Ki, S]``, and the aggregation a batched matmul over the fused (in-slot,
  S) axis (:func:`bmm_triplet_aggregate`), scatter-free both ways.

:func:`compute_triplets` lives in ``graph/batch.py``. Graph partitioning
(``partition_axis``) is not ported.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.graph.segment import segment_sum
from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.common import TorchLinear, safe_sqrt
from hydragnn_tpu_torch.ops.dense_agg import gather_rows_to_slots, group_sum, slots_to_rows

# zeros of the spherical Bessel functions j_0..j_6, 6 each (the JAX
# package's table)
BESSEL_ZEROS = np.array(
    [
        [3.141593, 6.283185, 9.424778, 12.566371, 15.707963, 18.849556],
        [4.493409, 7.725252, 10.904122, 14.066194, 17.220755, 20.371303],
        [5.763459, 9.095011, 12.322941, 15.514603, 18.689036, 21.853874],
        [6.987932, 10.417119, 13.698023, 16.923621, 20.121806, 23.304247],
        [8.182561, 11.704907, 15.039665, 18.301256, 21.525418, 24.727566],
        [9.355812, 12.966530, 16.354710, 19.653152, 22.904551, 26.127750],
        [10.512835, 14.207392, 17.647975, 20.983463, 24.262768, 27.507868],
    ]
)


# their float32 values, held as float64 (a tensor built from them at either
# precision passes through no float32 array)
BESSEL_ZEROS_F32 = BESSEL_ZEROS.astype(np.float32).astype(np.float64)


def spherical_jn(l_max: int, x: torch.Tensor):
    """``[j_0, ..., j_{l_max}](x)`` by upward recurrence, ``x`` clamped at
    1e-8."""
    x = torch.clamp(x, min=1e-8)
    j = [torch.sin(x) / x]
    if l_max >= 1:
        j.append(torch.sin(x) / (x * x) - torch.cos(x) / x)
    for ll in range(2, l_max + 1):
        j.append((2 * ll - 1) / x * j[ll - 1] - j[ll - 2])
    return j


def legendre(l_max: int, x: torch.Tensor):
    """``[P_0, ..., P_{l_max}](x)`` by recurrence."""
    p = [torch.ones_like(x)]
    if l_max >= 1:
        p.append(x)
    for ll in range(2, l_max + 1):
        p.append(((2 * ll - 1) * x * p[ll - 1] - (ll - 1) * p[ll - 2]) / ll)
    return p


def integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` (``n >= 1``) by the square-and-multiply order of JAX's
    ``lax.integer_pow``, which ``jnp.power`` takes for an integer
    exponent."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def envelope(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """The smooth cutoff ``1/x + a x^(p-1) + b x^p + c x^(p+1)`` (``p =
    exponent + 1``), 0 from ``x = 1``."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    xc = torch.clamp(x, min=1e-8)
    xp = integer_pow(xc, p - 1)
    val = 1.0 / xc + a * xp + b * xp * x + c * xp * x * x
    return torch.where(x < 1.0, val, 0.0)


class BesselBasisLayer(nn.Module):
    """``env(d) * sin(freq * d)``, ``d = dist / cutoff``; ``freq`` is learned,
    initialised at ``pi * (1, ..., R)``."""

    def __init__(self, num_radial: int, cutoff: float, envelope_exponent: int = 5, device=None):
        super().__init__()
        self.cutoff = cutoff
        self.envelope_exponent = envelope_exponent
        self.freq = nn.Parameter(torch.empty(num_radial, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.freq.copy_(torch.arange(1, self.freq.shape[0] + 1, dtype=torch.float32) * math.pi)

    def forward(self, dist):
        d = (dist / self.cutoff)[:, None]
        return envelope(d, self.envelope_exponent) * torch.sin(self.freq * d)


# the zeros on each device, made at the first call there: a captured
# forward (train/capture.py) runs its body eagerly first, and a capture
# cannot copy from the host
_ZEROS_ON_DEVICE = {}


def _bessel_zeros(num_spherical: int, num_radial: int, dtype, device) -> torch.Tensor:
    key = (num_spherical, num_radial, dtype, torch.device(device))
    zeros = _ZEROS_ON_DEVICE.get(key)
    if zeros is None:
        zeros = _ZEROS_ON_DEVICE[key] = torch.tensor(
            BESSEL_ZEROS_F32[:num_spherical, :num_radial], dtype=dtype, device=device)
    return zeros


def radial_sbf(dist, num_spherical: int, num_radial: int, cutoff: float,
               envelope_exponent: int) -> torch.Tensor:
    """``env(d) * j_l(z_ln * d)`` -> ``[..., S, R]``, the radial half of the
    spherical basis (one implementation for both geometries)."""
    d = torch.clamp(dist / cutoff, 1e-6, 1.0)
    env = envelope(d, envelope_exponent)
    # the float32 zeros (the JAX package's), also in a float64 evaluation
    zeros = _bessel_zeros(num_spherical, num_radial, torch.float32, dist.device)
    jl = spherical_jn(num_spherical - 1, d[..., None, None] * zeros)
    rad = torch.stack([jl[ll][..., ll, :] for ll in range(num_spherical)], dim=-2)
    return env[..., None, None] * rad


def spherical_basis(num_spherical, num_radial, cutoff, envelope_exponent, dist, angle, idx_kj):
    """``sbf[t, l*R + n] = env(d_kj) j_l(z_ln d_kj) P_l(cos angle_t)``: the
    radial part per edge, gathered at each triplet's ``k->j`` edge."""
    rbf = radial_sbf(dist, num_spherical, num_radial, cutoff, envelope_exponent)  # [E, S, R]
    cbf = torch.stack(legendre(num_spherical - 1, torch.cos(angle)), dim=1)  # [T, S]
    out = rbf.index_select(0, idx_kj) * cbf[:, :, None]
    return out.reshape(out.shape[0], num_spherical * num_radial)


def _edge_lengths(batch, pos, cutoff):
    i, j = batch.receivers, batch.senders
    diff = pos.index_select(0, i) - pos.index_select(0, j)
    dist = safe_sqrt((diff * diff).sum(-1))
    return torch.where(batch.edge_mask, dist, cutoff)  # a padded edge: env finite


def _cross(a, b):
    """``a x b`` over the last axis, as ``jnp.cross`` writes it."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dimenet_geometry(batch, pos, num_spherical, num_radial, cutoff, envelope_exponent):
    """``(dist [E], sbf [T, S*R])`` from the triplet tables; a padded
    triplet's row is 0."""
    ex = batch.extras
    dist = _edge_lengths(batch, pos, cutoff)
    pos_i = pos.index_select(0, ex["trip_i"])
    pos_ji = pos.index_select(0, ex["trip_j"]) - pos_i
    pos_ki = pos.index_select(0, ex["trip_k"]) - pos_i
    a = (pos_ji * pos_ki).sum(-1)
    cr = _cross(pos_ji, pos_ki)
    b = torch.sqrt((cr * cr).sum(-1))
    angle = torch.atan2(b, a)
    sbf = spherical_basis(num_spherical, num_radial, cutoff, envelope_exponent, dist, angle,
                          ex["trip_kj"])
    return dist, torch.where(ex["trip_mask"][:, None], sbf, 0.0)


def dimenet_geometry_dense(batch, pos, num_spherical, num_radial, cutoff, envelope_exponent):
    """``(dist [E], rad [N, Ki, S, R], cbf [N, Ko, Ki, S])`` on the slot
    grids of each central node ``j``: ``rad`` on its in-edge slots
    (``k->j``), ``cbf`` on its (out-slot ``j->i``, in-slot ``k->j``) pairs
    with every mask folded in (both slots valid, ``k != i``)."""
    ex = batch.extras
    nbr_edge, nbr_mask = ex["nbr_edge"], ex["nbr_mask"]
    out_edge, out_mask = ex["out_edge"], ex["rev_mask"]
    dist = _edge_lengths(batch, pos, cutoff)
    n, ki = nbr_edge.shape
    ko = out_edge.shape[1]
    d_g = torch.where(nbr_mask, dist.index_select(0, nbr_edge.reshape(-1)).reshape(n, ki), cutoff)
    rad = radial_sbf(d_g, num_spherical, num_radial, cutoff, envelope_exponent)
    k_id = ex["nbr_idx"]  # [N, Ki]: k of each in-edge
    i_id = torch.where(out_mask, batch.receivers.index_select(0, out_edge.reshape(-1))
                       .reshape(n, ko), 0)  # [N, Ko]: i of each out-edge
    pos_i = pos.index_select(0, i_id.reshape(-1)).reshape(n, ko, 3)
    pos_k = pos.index_select(0, k_id.reshape(-1)).reshape(n, ki, 3)
    pos_ji = pos[:, None, :] - pos_i  # [N, Ko, 3]
    pos_ki = pos_k[:, None, :, :] - pos_i[:, :, None, :]  # [N, Ko, Ki, 3]
    a = (pos_ji[:, :, None, :] * pos_ki).sum(-1)
    cr = _cross(pos_ji[:, :, None, :].expand_as(pos_ki), pos_ki)
    b2 = (cr * cr).sum(-1)
    # cos(atan2(b, a)) = a / hypot(a, b); the floor guards a = b = 0 (masked)
    cos_t = a * torch.rsqrt(torch.clamp(a * a + b2, min=1e-24))
    cbf = torch.stack(legendre(num_spherical - 1, cos_t), dim=-1)  # [N, Ko, Ki, S]
    valid = out_mask[:, :, None] & nbr_mask[:, None, :] & (k_id[:, None, :] != i_id[:, :, None])
    return dist, rad, torch.where(valid[..., None], cbf, 0.0)


def bmm_triplet_aggregate(x_down, rad, cbf, lin_sbf1, lin_sbf2, batch, num_spherical,
                          num_radial):
    """``sum_k sbf[(k,j,i)] * x_down[k->j]`` for every edge ``j->i``, as one
    batched matmul per central node ``j``: ``out[j, ko] = sum_{ki, s}
    cbf[j, ko, ki, s] * (rad[j, ki, s] @ Wf[s]) * x_down[nbr_edge[j, ki]]``,
    ``Wf`` the two bias-free sbf projections composed (the identity fed
    through the same modules). The product accumulates in float32; the
    result goes back onto the edge rows through the slot tables."""
    ex = batch.extras
    dt = x_down.dtype
    sr = num_spherical * num_radial
    wf = lin_sbf2(lin_sbf1(torch.eye(sr, dtype=dt, device=x_down.device)))
    wf = wf.reshape(num_spherical, num_radial, -1)
    radw = torch.einsum("nksr,srd->nksd", rad.to(dt), wf)  # [N, Ki, S, D]
    xg = gather_rows_to_slots(x_down, ex["nbr_edge"], ex["nbr_mask"], ex["edge_slot"],
                              batch.edge_mask)  # [N, Ki, D]
    m = radw * xg[:, :, None, :]
    n, ki, s, d = m.shape
    ko = cbf.shape[1]
    f32 = torch.float32
    out = torch.bmm(cbf.to(dt).reshape(n, ko, ki * s).to(f32),
                    m.reshape(n, ki * s, d).to(f32)).to(dt)  # [N, Ko, D]
    return slots_to_rows(out, ex["out_slot"], batch.edge_mask, ex["out_edge"], ex["rev_mask"])


class ResidualLayer(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.lin1 = TorchLinear(dim, dim, device=device)
        self.lin2 = TorchLinear(dim, dim, device=device)

    def forward(self, x):
        return x + F.silu(self.lin2(F.silu(self.lin1(x))))


class DimeNetConv(nn.Module):
    """One reference "conv": lin -> embedding -> interaction -> output
    block."""

    def __init__(self, in_dim, out_dim, hidden_dim, int_emb_size, basis_emb_size,
                 out_emb_size, num_radial, num_spherical, num_before_skip, num_after_skip,
                 cutoff, envelope_exponent, device=None):
        super().__init__()
        self.num_radial, self.num_spherical = num_radial, num_spherical
        self.num_before_skip, self.num_after_skip = num_before_skip, num_after_skip
        lin = lambda i, o, bias=True: TorchLinear(i, o, bias=bias, device=device)  # noqa: E731
        self.rbf = BesselBasisLayer(num_radial, cutoff, envelope_exponent, device=device)
        self.lin = lin(in_dim, hidden_dim)
        self.emb_lin_rbf = lin(num_radial, hidden_dim)
        self.emb_lin = lin(3 * hidden_dim, hidden_dim)
        self.int_rbf1 = lin(num_radial, basis_emb_size, False)
        self.int_rbf2 = lin(basis_emb_size, hidden_dim, False)
        self.int_sbf1 = lin(num_spherical * num_radial, basis_emb_size, False)
        self.int_sbf2 = lin(basis_emb_size, int_emb_size, False)
        self.int_lin_ji = lin(hidden_dim, hidden_dim)
        self.int_lin_kj = lin(hidden_dim, hidden_dim)
        self.int_down = lin(hidden_dim, int_emb_size, False)
        self.int_up = lin(int_emb_size, hidden_dim, False)
        for bi in range(num_before_skip):
            self.add_module(f"before_skip_{bi}", ResidualLayer(hidden_dim, device=device))
        self.int_lin = lin(hidden_dim, hidden_dim)
        for ai in range(num_after_skip):
            self.add_module(f"after_skip_{ai}", ResidualLayer(hidden_dim, device=device))
        self.out_lin_rbf = lin(num_radial, hidden_dim, False)
        self.out_up = lin(hidden_dim, out_emb_size, False)
        self.out_0 = lin(out_emb_size, out_emb_size)
        self.out_final = lin(out_emb_size, out_dim, False)

    def forward(self, x, pos, batch):
        act = F.silu
        ex = batch.extras
        bmm_mode = "dn2_rad" in ex
        if not (bmm_mode or "dn_sbf" in ex):
            raise ValueError(
                "DimeNet needs triplet tables or dense neighbour lists with the slot "
                "tables in batch.extras (build batches with need_triplets=True), turned "
                "into the geometry by DIMEStack.prepare_batch"
            )
        if bmm_mode:
            dist, rad, cbf = ex["dn2_dist"], ex["dn2_rad"], ex["dn2_cbf"]
        else:
            dist, sbf = ex["dn_dist"], ex["dn_sbf"]
        i, j = batch.receivers, batch.senders
        rbf = self.rbf(dist)

        # embedding block: edge states
        h = self.lin(x)
        r = act(self.emb_lin_rbf(rbf))
        e = act(self.emb_lin(torch.cat([h.index_select(0, i), h.index_select(0, j), r], dim=-1)))

        # interaction block
        rbf_b = self.int_rbf2(self.int_rbf1(rbf))
        x_ji = act(self.int_lin_ji(e))
        x_kj = act(self.int_lin_kj(e)) * rbf_b
        x_kj = act(self.int_down(x_kj))
        if bmm_mode:
            x_kj = bmm_triplet_aggregate(x_kj, rad, cbf, self.int_sbf1, self.int_sbf2, batch,
                                         self.num_spherical, self.num_radial)
        else:
            sbf_b = self.int_sbf2(self.int_sbf1(sbf))
            x_kj = torch.where(ex["trip_mask"][:, None],
                               x_kj.index_select(0, ex["trip_kj"]) * sbf_b, 0.0)
            x_kj = segment_sum(x_kj, ex["trip_ji"], i.shape[0])  # K1, E segments
        x_kj = act(self.int_up(x_kj))
        hh = x_ji + x_kj
        for bi in range(self.num_before_skip):
            hh = getattr(self, f"before_skip_{bi}")(hh)
        hh = act(self.int_lin(hh)) + e
        for ai in range(self.num_after_skip):
            hh = getattr(self, f"after_skip_{ai}")(hh)

        # output block: edge states summed at their receivers
        o = torch.where(batch.edge_mask[:, None], self.out_lin_rbf(rbf) * hh, 0.0)
        if "nbr_edge" in ex:
            o = group_sum(o, ex["nbr_edge"], ex["nbr_mask"], i, batch.edge_mask)
        else:
            o = segment_sum(o, i, x.shape[0])
        o = act(self.out_0(self.out_up(o)))
        return self.out_final(o), pos


class DIMEStack(HydraBase):
    conv_use_batchnorm = False  # Identity feature layers, as the reference
    dense_branch = True
    conv_needs_pos = True

    def __init__(self, basis_emb_size: int = 8, envelope_exponent: int = 5,
                 int_emb_size: int = 64, out_emb_size: int = 128, num_after_skip: int = 2,
                 num_before_skip: int = 1, num_radial: int = 6, num_spherical: int = 7,
                 radius: float = 2.0, device=None, **common):
        super().__init__(**common)
        self.basis_emb_size = basis_emb_size
        self.envelope_exponent = envelope_exponent
        self.int_emb_size = int_emb_size
        self.out_emb_size = out_emb_size
        self.num_after_skip = num_after_skip
        self.num_before_skip = num_before_skip
        self.num_radial = num_radial
        self.num_spherical = num_spherical
        self.radius = radius
        self.build(device=device)

    def prepare_batch(self, batch):
        """The geometry, once per forward: the dense grids when the batch
        has the slot tables, else the triplet axis."""
        ex = batch.extras
        geometry = (self.num_spherical, self.num_radial, self.radius, self.envelope_exponent)
        if "dn_dist" in ex or "dn2_rad" in ex:
            return batch
        if "out_edge" in ex:
            dist, rad, cbf = dimenet_geometry_dense(batch, batch.pos, *geometry)
            return batch.with_extras({"dn2_dist": dist, "dn2_rad": rad, "dn2_cbf": cbf})
        if "trip_i" in ex:
            dist, sbf = dimenet_geometry(batch, batch.pos, *geometry)
            return batch.with_extras({"dn_dist": dist, "dn_sbf": sbf})
        return batch

    def make_conv(self, in_dim, out_dim, last_layer=False, device=None):
        hidden_dim = out_dim if in_dim == 1 else in_dim
        if hidden_dim <= 1:
            raise ValueError(
                "DimeNet requires more than one hidden dimension between input_dim and "
                "output_dim."
            )
        return DimeNetConv(
            in_dim, out_dim, hidden_dim,
            int_emb_size=self.int_emb_size,
            basis_emb_size=self.basis_emb_size,
            out_emb_size=self.out_emb_size,
            num_radial=self.num_radial,
            num_spherical=self.num_spherical,
            num_before_skip=self.num_before_skip,
            num_after_skip=self.num_after_skip,
            cutoff=self.radius,
            envelope_exponent=self.envelope_exponent,
            device=device,
        )
