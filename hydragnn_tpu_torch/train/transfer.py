"""The host-to-device wire format (port of ``train/transfer.py``'s
compaction): what the host ships (:func:`compact_for_transfer`) and what
the program undoes (:func:`decompact`).

``compact_transfer`` (``Training.compact_transfer`` or
``HYDRAGNN_COMPACT_TRANSFER``, on by default, as in the JAX package):

- ``senders``, ``receivers`` and ``node_graph`` travel as int16 when the
  node and graph counts fit, and become int32 again inside the program;
- ``pos`` travels as a ``[..., 1, 3]`` placeholder when the model never
  reads positions (``conv_needs_pos`` False and no equivariance), and the
  program fills it with NaN, so that a conv that reads positions without
  declaring it fails at its first loss instead of training on zeros.

:func:`decompact` runs first in every training, evaluation and predict
body (``train/steps.py``), so on the card it is part of the captured
graph: the graph's body sees int32 ids and full positions, and a compact
batch selects its own program (its shapes and dtypes differ).
"""

import dataclasses

import torch

from hydragnn_tpu_torch.graph.batch import GraphBatch

_IDS = ("senders", "receivers", "node_graph")


def needs_pos(model) -> bool:
    return bool(getattr(model, "conv_needs_pos", True) or getattr(model, "equivariance", False))


def compact_for_transfer(batch: GraphBatch, keep_pos: bool) -> GraphBatch:
    """The host batch (plain ``[N, F]`` or stacked ``[K, N, F]``) in the
    compact wire format."""
    rep = {}
    if batch.x.shape[-2] < 2**15 and batch.n_node.shape[-1] < 2**15:
        rep.update({k: getattr(batch, k).to(torch.int16) for k in _IDS})
    if not keep_pos:
        rep["pos"] = torch.zeros(tuple(batch.pos.shape[:-2]) + (1, 3), dtype=torch.float32)
    return dataclasses.replace(batch, **rep)


def decompact(batch: GraphBatch) -> GraphBatch:
    """The inverse of :func:`compact_for_transfer`, on the device: int32
    ids, and NaN positions of the full shape for the placeholder."""
    rep = {}
    if batch.senders.dtype == torch.int16:
        rep.update({k: getattr(batch, k).to(torch.int32) for k in _IDS})
    if batch.pos.shape[-2] == 1 and batch.x.shape[-2] != 1:
        rep["pos"] = torch.full(tuple(batch.x.shape[:-1]) + (3,), float("nan"),
                                dtype=torch.float32, device=batch.x.device)
    return dataclasses.replace(batch, **rep) if rep else batch


def wire_bytes(batch: GraphBatch) -> int:
    """The bytes a batch ships: every tensor's, unpadded."""
    return int(sum(t.numel() * t.element_size() for t in batch.leaves()[1]))
