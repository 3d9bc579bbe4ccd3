"""Statically shaped padded graph batches (port of ``graph/batch.py``).

A batch is node/edge/graph tensors padded to fixed sizes, with a trailing
*padding graph* that absorbs every padding node and edge, so pooling and
graph-level math need no special cases: the padding rows fall into graph
``G-1`` and are masked out. Padded edges point at node ``n_pad-1``, which
is always a padding node.

Collation runs on the host in numpy; the batch then moves to the device
with :meth:`GraphBatch.to`.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class GraphBatch:
    """A padded multigraph batch of tensors.

    Shapes: N = padded node count, E = padded edge count, G = padded graph
    count (always >= real graphs + 1: the last slot is the padding graph).
    Index tensors are int32, as in the JAX package."""

    x: torch.Tensor  # [N, F] node input features
    pos: torch.Tensor  # [N, 3] node positions
    senders: torch.Tensor  # [E] int32, source node of each edge (j of j->i)
    receivers: torch.Tensor  # [E] int32, target node of each edge
    edge_attr: Optional[torch.Tensor]  # [E, De] or None
    node_graph: torch.Tensor  # [N] int32, graph id of each node
    n_node: torch.Tensor  # [G] int32
    n_edge: torch.Tensor  # [G] int32
    node_mask: torch.Tensor  # [N] bool, True on real nodes
    edge_mask: torch.Tensor  # [E] bool
    graph_mask: torch.Tensor  # [G] bool

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.n_node.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "GraphBatch":
        """The same batch on ``device`` (``self`` when already there).

        A host batch goes to the card in one copy: every field is staged
        into one pinned byte buffer (:func:`stage_bytes`), the buffer is
        copied without blocking the host, and the fields come back as views
        of the device buffer (:func:`unstage_bytes`)."""
        device = torch.device(device)
        if self.x.device == device:
            return self
        names = [f.name for f in dataclasses.fields(self) if getattr(self, f.name) is not None]
        tensors = [getattr(self, name) for name in names]
        if self.x.device.type != "cpu":
            moved = [t.to(device) for t in tensors]
        else:
            pin = device.type == "cuda"
            host, spans = stage_bytes(tensors, pin_memory=pin)
            moved = unstage_bytes(host.to(device, non_blocking=pin), spans)
        fields = {f.name: None for f in dataclasses.fields(self)}
        fields.update(zip(names, moved))
        return GraphBatch(**fields)


_ALIGN = 16  # bytes: every field's view starts on a 16-byte boundary


def stage_bytes(tensors, pin_memory: bool = False):
    """Copy ``tensors`` (on the CPU) into one byte buffer, each at an
    offset aligned to 16 bytes. Returns the buffer and the
    ``(offset, nbytes, dtype, shape)`` spans that :func:`unstage_bytes`
    reads."""
    spans, total = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        spans.append((total, nbytes, t.dtype, tuple(t.shape)))
        total += _round_up(nbytes, _ALIGN)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin_memory)
    for t, (off, nbytes, _, _) in zip(tensors, spans):
        buf[off : off + nbytes].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    return buf, spans


def unstage_bytes(buf: torch.Tensor, spans):
    """The tensors :func:`stage_bytes` packed, as views of ``buf``."""
    return [
        buf[off : off + nbytes].view(dtype).view(shape)
        for off, nbytes, dtype, shape in spans
    ]


def _round_up(value: int, multiple: int) -> int:
    return int(-(-value // multiple) * multiple)


def pad_sizes_for(
    max_nodes: int,
    max_edges: int,
    batch_size: int,
    node_multiple: int = 8,
    edge_multiple: int = 8,
    graph_multiple: int = 1,
) -> Tuple[int, int, int]:
    """Static pad sizes for a batch of up to ``batch_size`` graphs: every
    graph maximal, plus one guaranteed padding node and one padding graph,
    rounded up to the given multiples."""
    n_pad = _round_up(batch_size * max_nodes + 1, node_multiple)
    e_pad = _round_up(max(batch_size * max_edges, 1), edge_multiple)
    g_pad = _round_up(batch_size + 1, graph_multiple)
    return n_pad, e_pad, g_pad


def collate_graphs(
    samples,
    n_pad: int,
    e_pad: int,
    g_pad: int,
) -> GraphBatch:
    """Collate ``GraphData``-like samples into one padded batch of model
    inputs (no targets: only inference is ported).

    Each sample exposes numpy arrays: ``x [n,F]``, ``pos [n,3]``,
    ``edge_index [2,e]`` and optional ``edge_attr [e,De]``. The batch is
    built in numpy and wrapped as CPU tensors; :meth:`GraphBatch.to` moves
    it to the device in one transfer."""
    num_graphs = len(samples)
    total_nodes = int(sum(s.x.shape[0] for s in samples))
    total_edges = int(sum(s.edge_index.shape[1] for s in samples))
    if num_graphs > g_pad - 1:
        raise ValueError(f"batch of {num_graphs} graphs exceeds g_pad-1={g_pad - 1}")
    if total_nodes > n_pad - 1:
        raise ValueError(f"{total_nodes} nodes exceed n_pad-1={n_pad - 1}")
    if total_edges > e_pad:
        raise ValueError(f"{total_edges} edges exceed e_pad={e_pad}")

    feat_dim = samples[0].x.shape[1]
    x = np.zeros((n_pad, feat_dim), dtype=np.float32)
    pos = np.zeros((n_pad, 3), dtype=np.float32)
    # padding edges point at the last node slot (always a padding node since
    # total_nodes <= n_pad - 1) and live in the padding graph
    senders = np.full((e_pad,), n_pad - 1, dtype=np.int32)
    receivers = np.full((e_pad,), n_pad - 1, dtype=np.int32)
    edge_dim = None
    edge_attr = None
    if samples[0].edge_attr is not None:
        edge_dim = samples[0].edge_attr.shape[1]
        edge_attr = np.zeros((e_pad, edge_dim), dtype=np.float32)
    node_graph = np.full((n_pad,), g_pad - 1, dtype=np.int32)
    n_node = np.zeros((g_pad,), dtype=np.int32)
    n_edge = np.zeros((g_pad,), dtype=np.int32)
    node_mask = np.zeros((n_pad,), dtype=bool)
    edge_mask = np.zeros((e_pad,), dtype=bool)
    graph_mask = np.zeros((g_pad,), dtype=bool)

    node_off = 0
    edge_off = 0
    for g, s in enumerate(samples):
        n = s.x.shape[0]
        e = s.edge_index.shape[1]
        x[node_off : node_off + n] = s.x
        if s.pos is not None:
            pos[node_off : node_off + n] = s.pos
        senders[edge_off : edge_off + e] = s.edge_index[0] + node_off
        receivers[edge_off : edge_off + e] = s.edge_index[1] + node_off
        if edge_dim is not None:
            edge_attr[edge_off : edge_off + e] = s.edge_attr
        node_graph[node_off : node_off + n] = g
        n_node[g] = n
        n_edge[g] = e
        node_mask[node_off : node_off + n] = True
        edge_mask[edge_off : edge_off + e] = True
        graph_mask[g] = True
        node_off += n
        edge_off += e

    # padding nodes all sit in the padding graph; record its node count so
    # means over the padding graph stay well defined
    n_node[g_pad - 1] = n_pad - node_off
    n_edge[g_pad - 1] = e_pad - edge_off

    t = torch.from_numpy
    return GraphBatch(
        x=t(x),
        pos=t(pos),
        senders=t(senders),
        receivers=t(receivers),
        edge_attr=None if edge_attr is None else t(edge_attr),
        node_graph=t(node_graph),
        n_node=t(n_node),
        n_edge=t(n_edge),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        graph_mask=t(graph_mask),
    )
