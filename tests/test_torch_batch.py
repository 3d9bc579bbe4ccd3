"""Port parity: padded batch collation (``graph/batch.py``) against the JAX
package's ``collate_graphs``, and the one-buffer staging that carries a
host batch to the card in one copy.

Collation is exact (the same numpy arrays), so every field is compared
bit for bit, padding included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import collate_graphs as jax_collate

from hydragnn_tpu_torch.graph import collate_graphs, pad_sizes_for
from hydragnn_tpu_torch.graph.batch import stage_bytes, unstage_bytes

from test_torch_pna import samples


@pytest.mark.parametrize("with_edge_attr", [False, True])
def pytest_collate_matches_jax(with_edge_attr):
    graphs = samples(num=5, seed=4, with_edge_attr=with_edge_attr)
    pads = pad_sizes_for(10, 40, 6)
    ref = jax_collate(graphs, *pads)
    got = collate_graphs(graphs, *pads)
    for f in dataclasses.fields(got):
        mine, theirs = getattr(got, f.name), getattr(ref, f.name)
        if theirs is None and f.name != "extras":
            assert mine is None, f.name
            continue
        if f.name == "targets":  # one per head; none without head types
            assert mine == () and tuple(theirs) == (), f.name
            continue
        if f.name == "extras":  # none without a layout that asks (JAX: None)
            assert mine == {}, f.name
            continue
        theirs = np.asarray(theirs)
        assert mine.numpy().dtype == theirs.dtype, f.name
        np.testing.assert_array_equal(mine.numpy(), theirs, err_msg=f.name)
    # padded edges point at the last node, a padding node in the padding graph
    real_edges = int(got.edge_mask.sum())
    assert (got.senders[real_edges:] == pads[0] - 1).all()
    assert not got.node_mask[-1] and got.node_graph[-1] == pads[2] - 1


def pytest_staged_batch_round_trips_through_one_buffer():
    graphs = samples(num=3, seed=6, with_edge_attr=True)
    batch = collate_graphs(graphs, *pad_sizes_for(10, 40, 4))
    names = [f.name for f in dataclasses.fields(batch) if f.name not in ("targets", "extras")]
    tensors = [getattr(batch, n) for n in names]  # targets: (), extras: {} here
    buf, spans = stage_bytes(tensors)
    assert buf.dtype == torch.uint8 and buf.ndim == 1
    assert all(off % 16 == 0 for off, *_ in spans)
    back = unstage_bytes(buf.clone(), spans)
    for name, t, b in zip(names, tensors, back):
        assert b.dtype == t.dtype and b.shape == t.shape, name
        assert torch.equal(b, t), name
    # the views share the one buffer
    assert all(b.untyped_storage().data_ptr() == back[0].untyped_storage().data_ptr() for b in back)
