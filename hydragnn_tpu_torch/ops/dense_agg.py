"""Dense neighbour-list aggregation: message passing without a scatter
(port of ``hydragnn_tpu/ops/dense_agg.py``).

The host turns a batch's edge list into fixed-width lists per node (numpy):
``nbr_idx [N, K_in]``, the sender of each incoming-edge slot, with
``nbr_edge`` (its edge row) and ``nbr_mask``; and the reverse lists
``rev_idx [N, K_out]``, the flat ``receiver * K_in + slot`` of each
outgoing edge, with ``rev_mask``. Every aggregation is then a masked
reduction over the K axis, and the gather's backward reads the cotangent
through the reverse list: a gather and a sum, never a scatter. A sum at
the senders (EGNN's messages, SchNet's coordinate update) reads the
per-slot values through the reverse list, and its backward gathers
through the forward list.

:func:`gather_neighbors` and :func:`aggregate_to_senders` are
``torch.autograd.Function``s with those rules (the JAX package's
``custom_vjp``s). DimeNet's dense branch adds the slot tables
(``with_slot_tables``: ``out_edge``, ``edge_slot``, ``out_slot``) and three
more such Functions for one-owner groupings: :func:`group_sum`,
:func:`gather_rows_to_slots` and :func:`slots_to_rows`, each a gather
forward and a gather back. The sums and statistics accumulate in ``torch.float32``
whatever the message dtype and come back at it, as the JAX package's do.
No kernel of the card runs here: the JAX package's dense branch is XLA
gathers and reductions (its Pallas variant lost to XLA's fusion and was
deleted), so the port's is PyTorch ops.
"""

from typing import Optional, Tuple

import numpy as np
import torch

_BIG = 1e9


def max_degree(senders, receivers, edge_mask=None) -> Tuple[int, int]:
    """``(max in-degree, max out-degree)`` over real edges, at least 1
    each: the K widths a layout needs for the lists."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if edge_mask is not None:
        senders = senders[np.asarray(edge_mask)]
        receivers = receivers[np.asarray(edge_mask)]
    if senders.size == 0:
        return 1, 1
    k_in = int(np.bincount(receivers).max())
    k_out = int(np.bincount(senders).max())
    return max(k_in, 1), max(k_out, 1)


def build_group_lists(owner_ids, valid_mask, num_groups: int, k: int,
                      label: str = "k"):
    """Invert a one-owner mapping into fixed-width member lists: ``(lists
    [G, k] int32, mask [G, k] bool)``, members in row order. Raises
    ``ValueError`` when a group has more than ``k`` members (``label``
    names the width in the message)."""
    owner_ids = np.asarray(owner_ids, np.int64)
    rows = np.arange(owner_ids.shape[0])
    if valid_mask is not None:
        keep = np.asarray(valid_mask, bool)
        owner_ids, rows = owner_ids[keep], rows[keep]
    lists = np.zeros((num_groups, k), np.int32)
    mask = np.zeros((num_groups, k), bool)
    order = np.argsort(owner_ids, kind="stable")
    o_sorted = owner_ids[order]
    slot = np.arange(o_sorted.shape[0]) - np.searchsorted(o_sorted, o_sorted, side="left")
    if o_sorted.size and np.any(slot >= k):
        raise ValueError(f"group size exceeds layout {label}={k}; recompute the layout")
    lists[o_sorted, slot] = rows[order]
    mask[o_sorted, slot] = True
    return lists, mask


def build_neighbor_lists(senders: np.ndarray, receivers: np.ndarray,
                         edge_mask: Optional[np.ndarray], num_nodes: int,
                         k_in: int, k_out: int, with_slot_tables: bool = False):
    """The lists of an edge list, as numpy arrays (real edges only; a
    ``False`` row of ``edge_mask`` is padding): ``nbr_idx``, ``nbr_edge``,
    ``nbr_mask`` ``[N, K_in]`` and ``rev_idx``, ``rev_mask`` ``[N,
    K_out]``. A padded slot holds index 0, always in range; its consumer
    masks it.

    ``with_slot_tables`` (DimeNet's dense branch) adds ``out_edge [N,
    K_out]``, the edge row of each outgoing slot (valid where
    ``rev_mask``), ``edge_slot [E]``, the flat ``receiver * K_in + slot``
    of each edge, and ``out_slot [E]``, the flat ``sender * K_out + slot``
    of each edge (0 for a padded edge)."""
    senders = np.asarray(senders, np.int64)
    nbr_edge, nbr_mask = build_group_lists(receivers, edge_mask, num_nodes, k_in, label="k_in")
    nbr_idx = np.where(nbr_mask, senders[nbr_edge], 0).astype(np.int32)
    flat_of_edge = np.zeros(senders.shape[0], np.int64)  # [E] -> receiver*K_in + slot
    rr, ss = np.nonzero(nbr_mask)
    flat_of_edge[nbr_edge[rr, ss]] = rr * k_in + ss
    out_edge, rev_mask = build_group_lists(senders, edge_mask, num_nodes, k_out, label="k_out")
    rev_idx = np.where(rev_mask, flat_of_edge[out_edge], 0).astype(np.int32)
    out = {
        "nbr_idx": nbr_idx,
        "nbr_edge": nbr_edge,
        "nbr_mask": nbr_mask,
        "rev_idx": rev_idx,
        "rev_mask": rev_mask,
    }
    if with_slot_tables:
        # out_edge's inverse permutation: routes per-(sender, out-slot)
        # values back onto the edge rows
        out_slot = np.zeros(senders.shape[0], np.int64)
        rr, ss = np.nonzero(rev_mask)
        out_slot[out_edge[rr, ss]] = rr * k_out + ss
        out.update(
            out_edge=out_edge,
            edge_slot=flat_of_edge.astype(np.int32),
            out_slot=out_slot.astype(np.int32),
        )
    return out


def attach_neighbor_lists(batch):
    """``batch`` (on the host) with the lists in its ``extras``, at the
    widths its own real edges need; with the slot tables too when the batch
    carries DimeNet's triplets (``trip_ji``)."""
    k_in, k_out = max_degree(batch.senders, batch.receivers, batch.edge_mask)
    lists = build_neighbor_lists(
        batch.senders.numpy(), batch.receivers.numpy(), batch.edge_mask.numpy(),
        batch.num_nodes, k_in, k_out, with_slot_tables="trip_ji" in batch.extras,
    )
    return batch.with_extras({k: torch.from_numpy(v) for k, v in lists.items()})


class _GatherNeighbors(torch.autograd.Function):
    """``x[nbr_idx]`` with ``_gather_bwd``'s rule (``dense_agg.py:129-137``):
    the cotangent ``g [N, K_in, D]`` read through the reverse list, masked
    by ``rev_mask`` and summed over ``K_out`` in ``torch.float32``, then
    cast back to ``g``'s dtype."""

    @staticmethod
    def forward(ctx, x, nbr_idx, rev_idx, rev_mask):
        ctx.save_for_backward(rev_idx, rev_mask)
        n, k_in = nbr_idx.shape
        return x.index_select(0, nbr_idx.reshape(-1)).reshape(n, k_in, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        rev_idx, rev_mask = ctx.saved_tensors
        n, k_in, d = g.shape
        k_out = rev_idx.shape[1]
        contrib = g.reshape(n * k_in, d).index_select(0, rev_idx.reshape(-1))
        contrib = contrib.reshape(n, k_out, d)
        gm = torch.where(rev_mask[..., None], contrib, 0.0).to(torch.float32)
        return gm.sum(dim=1).to(g.dtype), None, None, None


def gather_neighbors(x: torch.Tensor, nbr_idx: torch.Tensor, rev_idx: torch.Tensor,
                     rev_mask: torch.Tensor) -> torch.Tensor:
    """``x[nbr_idx]`` (``[N, D] -> [N, K_in, D]``) whose backward is a
    gather through the reverse list, not a scatter-add. The rows of ``x``
    are the receivers of ``nbr_idx``."""
    return _GatherNeighbors.apply(x, nbr_idx, rev_idx, rev_mask)


def dense_moments(h: torch.Tensor, nbr_mask: torch.Tensor):
    """``(mean, std, deg, has)`` over the K axis of masked messages ``h
    [N, K, D]``: PNA's statistics. They accumulate in ``torch.float32``;
    ``mean``, ``std`` and ``deg`` come back at ``h``'s dtype. An empty
    receiver has mean 0 and std ``sqrt(1e-5)``, as in the segment
    branches."""
    hm = torch.where(nbr_mask[..., None], h, 0.0).to(torch.float32)
    cnt = nbr_mask.sum(dim=1).to(torch.float32)[:, None]
    has = cnt > 0
    deg = torch.clamp(cnt, min=1.0)
    mean = hm.sum(dim=1) / deg
    sq = (hm * hm).sum(dim=1) / deg
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0) + 1e-5)
    return mean.to(h.dtype), std.to(h.dtype), deg.to(h.dtype), has


def dense_minmax(h: torch.Tensor, nbr_mask: torch.Tensor, has: torch.Tensor,
                 fill: float = 0.0):
    """``(min, max)`` over the K axis; an empty receiver gets ``fill``.
    ``amax``/``amin`` split a gradient evenly among tied entries, as JAX's
    max-reduction JVP does (``torch.max(dim)`` would give it all to one)."""
    m = nbr_mask[..., None]
    mx = torch.where(m, h, -_BIG).amax(dim=1)
    mn = torch.where(m, h, _BIG).amin(dim=1)
    return torch.where(has, mn, fill), torch.where(has, mx, fill)


class _AggregateToSenders(torch.autograd.Function):
    """``_agg_send_fwd`` / ``_agg_send_bwd`` (``dense_agg.py:259-290``):
    per-slot values ``h [N, K_in, D]`` summed at their senders through the
    reverse list, masked by ``rev_mask``, in ``torch.float32`` and back at
    ``h``'s dtype; the backward gathers the cotangent through ``nbr_idx``,
    masked by ``nbr_mask``."""

    @staticmethod
    def forward(ctx, h, nbr_idx, nbr_mask, rev_idx, rev_mask):
        ctx.save_for_backward(nbr_idx, nbr_mask)
        n, k_in, d = h.shape
        contrib = h.reshape(n * k_in, d).index_select(0, rev_idx.reshape(-1))
        contrib = contrib.reshape(n, rev_idx.shape[1], d)
        hm = torch.where(rev_mask[..., None], contrib, 0.0).to(torch.float32)
        return hm.sum(dim=1).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        nbr_idx, nbr_mask = ctx.saved_tensors
        n, k_in = nbr_idx.shape
        gh = g.index_select(0, nbr_idx.reshape(-1)).reshape(n, k_in, g.shape[1])
        return torch.where(nbr_mask[..., None], gh, 0.0), None, None, None, None


def aggregate_to_senders(h: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                         rev_idx: torch.Tensor, rev_mask: torch.Tensor) -> torch.Tensor:
    """Sum per-slot values ``h [N, K_in, D]`` (keyed by receiver and slot)
    onto their **sender** nodes -> ``[N, D]``, scatter-free both ways."""
    return _AggregateToSenders.apply(h, nbr_idx, nbr_mask, rev_idx, rev_mask)


def dense_sum(h: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """The masked sum over the K axis of ``h [N, K, D]``, in
    ``torch.float32``, returned at ``h``'s dtype."""
    return torch.where(nbr_mask[..., None], h, 0.0).to(torch.float32).sum(dim=1).to(h.dtype)


class _GroupSum(torch.autograd.Function):
    """``group_sum`` (``dense_agg.py:143-182``): the member rows
    ``values[lists]`` masked and summed over K in ``torch.float32``, back at
    ``values``' dtype; the backward gathers ``g[owner_ids]``, zero where a
    row is not ``valid``."""

    @staticmethod
    def forward(ctx, values, lists, lists_mask, owner_ids, valid):
        ctx.save_for_backward(owner_ids, valid)
        g_rows, k = lists.shape
        member = values.index_select(0, lists.reshape(-1)).reshape(g_rows, k, values.shape[1])
        hm = torch.where(lists_mask[..., None], member, 0.0).to(torch.float32)
        return hm.sum(dim=1).to(values.dtype)

    @staticmethod
    def backward(ctx, g):
        owner_ids, valid = ctx.saved_tensors
        gv = torch.where(valid[:, None], g.index_select(0, owner_ids), 0.0)
        return gv, None, None, None, None


def group_sum(values: torch.Tensor, lists: torch.Tensor, lists_mask: torch.Tensor,
              owner_ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Segment sum of ``values [T, D]`` for a grouping in which every valid
    row has one owner (``owner_ids [T]``, ``valid [T]``), given the groups'
    member lists ``lists [G, K]`` and ``lists_mask``: ``[G, D]``,
    scatter-free both ways (DimeNet's edge -> node sum)."""
    return _GroupSum.apply(values, lists, lists_mask, owner_ids, valid)


class _GatherRowsToSlots(torch.autograd.Function):
    """``gather_rows_to_slots`` (``dense_agg.py:185-204``): ``table[lists]``
    masked by ``lists_mask``; the backward reads the cotangent's slot of
    each row, ``g.reshape(G*K, D)[slot_of_row]``, zero where a row is not
    ``row_valid``."""

    @staticmethod
    def forward(ctx, table, lists, lists_mask, slot_of_row, row_valid):
        ctx.save_for_backward(slot_of_row, row_valid)
        g_rows, k = lists.shape
        rows = table.index_select(0, lists.reshape(-1)).reshape(g_rows, k, table.shape[1])
        return torch.where(lists_mask[..., None], rows, 0.0)

    @staticmethod
    def backward(ctx, g):
        slot_of_row, row_valid = ctx.saved_tensors
        g_rows, k, d = g.shape
        gt = g.reshape(g_rows * k, d).index_select(0, slot_of_row)
        return torch.where(row_valid[:, None], gt, 0.0), None, None, None, None


def gather_rows_to_slots(table: torch.Tensor, lists: torch.Tensor, lists_mask: torch.Tensor,
                         slot_of_row: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """``table[lists]`` (``[R, D] -> [G, K, D]``, zero in masked slots) for a
    one-owner grouping (every valid row sits in one slot, at
    ``slot_of_row``); the backward is that inverse permutation, a
    gather."""
    return _GatherRowsToSlots.apply(table, lists, lists_mask, slot_of_row, row_valid)


class _SlotsToRows(torch.autograd.Function):
    """``slots_to_rows`` (``dense_agg.py:207-225``): the slot of each row,
    ``slots.reshape(G*K, D)[slot_of_row]``, zero where a row is not
    ``row_valid``; the backward gathers ``g[lists]`` masked by
    ``lists_mask``."""

    @staticmethod
    def forward(ctx, slots, slot_of_row, row_valid, lists, lists_mask):
        ctx.save_for_backward(lists, lists_mask)
        g_rows, k, d = slots.shape
        out = slots.reshape(g_rows * k, d).index_select(0, slot_of_row)
        return torch.where(row_valid[:, None], out, 0.0)

    @staticmethod
    def backward(ctx, g):
        lists, lists_mask = ctx.saved_tensors
        g_rows, k = lists.shape
        gs = g.index_select(0, lists.reshape(-1)).reshape(g_rows, k, g.shape[1])
        return torch.where(lists_mask[..., None], gs, 0.0), None, None, None, None


def slots_to_rows(slots: torch.Tensor, slot_of_row: torch.Tensor, row_valid: torch.Tensor,
                  lists: torch.Tensor, lists_mask: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`gather_rows_to_slots`: per-slot values ``slots
    [G, K, D]`` routed back onto their rows -> ``[R, D]``; the backward
    gathers through ``lists``."""
    return _SlotsToRows.apply(slots, slot_of_row, row_valid, lists, lists_mask)
