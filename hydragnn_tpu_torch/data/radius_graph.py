"""The radius graph of one sample, on the host (port of
``data/radius_graph.py``'s ``radius_graph``).

Edges are ``(senders=j, receivers=i)``: every ordered pair within the
cutoff, so the graph is symmetric. ``max_neighbors`` caps each receiver's
incoming edges in ascending ``j``, torch-cluster's order. Up to 1024 atoms
the distances are one dense matrix; above, a cell list gives the same
edges.

:func:`radius_graph_pbc` is the periodic version (ase's neighbour list
semantics): every pair within the cutoff through one of the 27 image
shifts of the cell (those along a non-periodic axis left out), a node's
own image included, edges in the JAX package's order.
"""

from typing import Optional, Tuple

import numpy as np


def radius_graph(pos: np.ndarray, radius: float, max_neighbors: int = 32,
                 loop: bool = False) -> np.ndarray:
    """``[2, E]`` int64: every ``j -> i`` with ``|pos_j - pos_i| <= radius``
    (``i == j`` only with ``loop``), at most ``max_neighbors`` per ``i``,
    the smallest ``j`` first."""
    n = pos.shape[0]
    if n == 0:
        return np.zeros((2, 0), dtype=np.int64)
    pos = np.asarray(pos, dtype=np.float64)
    if n <= 1024:
        diff = pos[None, :, :] - pos[:, None, :]  # [i, j]
        within = np.sqrt((diff * diff).sum(-1)) <= radius
        if not loop:
            np.fill_diagonal(within, False)
        senders, receivers = [], []
        for i in range(n):
            js = np.nonzero(within[i])[0][:max_neighbors]
            senders.append(js)
            receivers.append(np.full(js.shape, i, dtype=np.int64))
        return np.stack([np.concatenate(senders), np.concatenate(receivers)]).astype(np.int64)

    # cell list: candidates from the 27 cells around each point's own
    grid = np.floor((pos - pos.min(axis=0)) / radius).astype(np.int64)
    dims = grid.max(axis=0) + 1
    cid = (grid[:, 0] * dims[1] + grid[:, 1]) * dims[2] + grid[:, 2]
    order = np.argsort(cid, kind="stable")
    uniq, start = np.unique(cid[order], return_index=True)
    counts = np.diff(np.append(start, n))
    recv_all, send_all = [], []
    for off in np.array([[a, b, c] for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]):
        ng = grid + off
        pts = np.nonzero(np.all((ng >= 0) & (ng < dims), axis=1))[0]
        ncid = (ng[pts, 0] * dims[1] + ng[pts, 1]) * dims[2] + ng[pts, 2]
        slot = np.searchsorted(uniq, ncid)
        hit = (slot < uniq.shape[0]) & (uniq[np.minimum(slot, uniq.shape[0] - 1)] == ncid)
        pts, slot = pts[hit], slot[hit]
        c = counts[slot]
        total = int(c.sum())
        if total == 0:
            continue
        within_cell = np.arange(total) - np.repeat(np.cumsum(c) - c, c)
        recv_all.append(np.repeat(pts, c))
        send_all.append(order[np.repeat(start[slot], c) + within_cell])
    if not recv_all:
        return np.zeros((2, 0), dtype=np.int64)
    recv, send = np.concatenate(recv_all), np.concatenate(send_all)
    keep = np.linalg.norm(pos[send] - pos[recv], axis=1) <= radius
    if not loop:
        keep &= send != recv
    recv, send = recv[keep], send[keep]
    so = np.lexsort((send, recv))
    recv, send = recv[so], send[so]
    group_start = np.nonzero(np.r_[True, recv[1:] != recv[:-1]])[0]
    rank = np.arange(recv.shape[0]) - np.repeat(
        group_start, np.diff(np.append(group_start, recv.shape[0])))
    keep = rank < max_neighbors
    return np.stack([send[keep], recv[keep]]).astype(np.int64)


def radius_graph_pbc(pos: np.ndarray, cell: np.ndarray, radius: float,
                     max_neighbors: int = 32, loop: bool = False,
                     pbc: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """``(edge_index [2, E] int64, lengths [E] float32)`` over the 27
    image shifts ``(i, j, k) in {-1, 0, 1}^3`` of ``cell`` (``[3, 3]``
    rows, or its diagonal ``[3]``). ``pbc``: a per-axis mask (default all
    periodic); a shift along a non-periodic axis is left out, so a slab
    (``"T T F"``) has no edge across its vacuum. A node's own image is a
    neighbour; the node itself only with ``loop``. Edges come shift by
    shift, each shift's pairs in ``(i, j)`` row order, then stably sorted
    by receiver, and each receiver keeps its first ``max_neighbors``.
    Raises ``ValueError`` when a pair is within the cutoff through two
    images (the cutoff must shrink or the cell grow). A Python loop over
    the edges, on the host, as in the JAX package."""
    cell = np.asarray(cell, dtype=np.float64)
    if cell.ndim == 1:
        cell = np.diag(cell)
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)])
    if pbc is not None:
        pbc = np.asarray(pbc, dtype=bool)
        shifts = shifts[np.all((shifts == 0) | pbc[None, :], axis=1)]
    senders, receivers, lengths = [], [], []
    seen = set()
    for s in shifts @ cell:
        diff = (pos[None, :, :] + s[None, None, :]) - pos[:, None, :]  # [i, j]
        dist = np.sqrt((diff * diff).sum(-1))
        within = dist <= radius
        if not loop and np.abs(s).sum() <= 1e-12:
            np.fill_diagonal(within, False)
        ii, jj = np.nonzero(within)
        for i, j in zip(ii, jj):
            key = (int(j), int(i))
            if key in seen:
                raise ValueError(
                    "Adding periodic boundary conditions would result in "
                    "duplicate edges. Cutoff radius must be reduced or "
                    "system size increased."
                )
            seen.add(key)
            senders.append(j)
            receivers.append(i)
            lengths.append(dist[i, j])
    if not senders:
        return np.zeros((2, 0), dtype=np.int64), np.zeros((0,), dtype=np.float32)
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.float32)
    order = np.argsort(receivers, kind="stable")
    senders, receivers, lengths = senders[order], receivers[order], lengths[order]
    keep = np.ones(senders.shape[0], dtype=bool)
    count = {}
    for idx, r in enumerate(receivers):
        c = count.get(int(r), 0)
        if c >= max_neighbors:
            keep[idx] = False
        count[int(r)] = c + 1
    return np.stack([senders[keep], receivers[keep]]), lengths[keep]
