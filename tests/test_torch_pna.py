"""Port parity: the whole multi-head PNA forward (eval) against the JAX
package's ``model.apply(..., train=False)``, weights carried across by
``models/bridge.py``.

Each port aggregation mode is held against the JAX configuration that
turns the same kernels on: ``"fused"`` against ``HYDRAGNN_AGG=fused``,
``"segment"`` against ``HYDRAGNN_PALLAS=1`` (the Pallas kernels run in
interpret mode on the CPU). The variables are read at trace time, so every
case builds and applies its own JAX model, with no jit shared across
modes. BatchNorm running statistics are set to non-trivial values so that
they matter. Only real rows are compared (``graph_mask``/``node_mask``).
Tolerance: rtol 1e-4, atol 1e-5 (contraction orders differ).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import pad_sizes_for
from hydragnn_tpu.models import create_model_config as jax_create_model_config

from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.ops import launch_counts

from _torch_jax_init import cached_init_model_params

RTOL, ATOL = 1e-4, 1e-5
JAX_ENV = {"fused": ("HYDRAGNN_AGG", "fused"), "segment": ("HYDRAGNN_PALLAS", "1")}


def arch(node_type="mlp", edge_dim=None, hidden=16, layers=2):
    return {
        "model_type": "PNA",
        "input_dim": 1,
        "hidden_dim": hidden,
        "output_dim": [1, 2],
        "output_type": ["graph", "node"],
        "output_heads": {
            "graph": {
                "num_sharedlayers": 2,
                "dim_sharedlayers": 8,
                "num_headlayers": 2,
                "dim_headlayers": [8, 8],
            },
            "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": node_type},
        },
        "task_weights": [1.0, 1.0],
        "num_conv_layers": layers,
        "num_nodes": 10,
        "edge_dim": edge_dim,
        "pna_deg": [0, 2, 6, 8, 4],
    }


def samples(num=6, seed=0, with_edge_attr=False):
    rng = np.random.default_rng(seed)

    class _S:
        pass

    out = []
    for _ in range(num):
        n = int(rng.integers(4, 11))
        s = _S()
        s.x = rng.random((n, 1)).astype(np.float32)
        s.pos = rng.random((n, 3)).astype(np.float32)
        src = np.repeat(np.arange(n), 2)
        dst = (src + rng.integers(1, n, src.shape[0])) % n
        s.edge_index = np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int64)
        s.edge_attr = None
        if with_edge_attr:
            d = np.linalg.norm(s.pos[s.edge_index[0]] - s.pos[s.edge_index[1]], axis=1)
            s.edge_attr = d[:, None].astype(np.float32)
        out.append(s)
    return out


def jax_variables(model, batch, seed=0):
    """Initialised variables with non-trivial BatchNorm running stats, as
    nested dicts of numpy arrays."""
    variables = jax.tree_util.tree_map(np.asarray, cached_init_model_params(model, batch))
    rng = np.random.default_rng(seed + 100)
    stats = variables["batch_stats"]
    for name in stats:
        f = stats[name]["mean"].shape[0]
        stats[name]["mean"] = rng.normal(0.0, 0.3, f).astype(np.float32)
        stats[name]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
    return variables


CASES = [
    ("fused", "mlp", None),
    ("segment", "mlp", None),
    ("fused", "mlp_per_node", 1),
    ("segment", "mlp", 1),
    ("segment", "conv", None),
]


@pytest.mark.parametrize("aggregation,node_type,edge_dim", CASES)
def pytest_pna_forward_matches_jax(monkeypatch, aggregation, node_type, edge_dim):
    env, value = JAX_ENV[aggregation]
    monkeypatch.setenv(env, value)
    cfg = arch(node_type=node_type, edge_dim=edge_dim)
    graphs = samples(with_edge_attr=edge_dim is not None)
    n_pad, e_pad, g_pad = pad_sizes_for(10, 40, 6)

    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_collate(graphs, n_pad, e_pad, g_pad))
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables(jmodel, jbatch)
    ref = [np.asarray(o) for o in jmodel.apply(variables, jbatch, train=False)]

    model = create_model_config(cfg, device="cpu", aggregation=aggregation)
    load_flax_variables(model, variables)
    batch = collate_graphs(graphs, n_pad, e_pad, g_pad)
    before = launch_counts()
    with torch.inference_mode():
        got = [o.numpy() for o in model(batch)]
    assert launch_counts() == before  # the CPU runs the plain versions

    gmask = batch.graph_mask.numpy()
    nmask = batch.node_mask.numpy()
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0][gmask], ref[0][gmask], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1][nmask], ref[1][nmask], rtol=RTOL, atol=ATOL)


def pytest_pna_modes_agree_and_seed_is_deterministic():
    """Both port modes compute the same function from the same seed."""
    graphs = samples(seed=3)
    batch = collate_graphs(graphs, *pad_sizes_for(10, 40, 6))
    outs = []
    for aggregation in ("fused", "segment"):
        model = create_model_config(arch(), device="cpu", aggregation=aggregation, seed=5)
        with torch.inference_mode():
            outs.append([o.numpy() for o in model(batch)])
    nmask = batch.node_mask.numpy()
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[0][1][nmask], outs[1][1][nmask], rtol=RTOL, atol=ATOL)


def pytest_pna_unported_options_raise():
    # every stack is ported: GAT builds (tests/test_torch_gat_mfc_cgcnn.py)
    assert type(create_model_config({**arch(), "model_type": "GAT"}, device="cpu")).__name__ == "GATStack"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model_config({**arch(), "partition_axis": "data"}, device="cpu")
    with pytest.raises(ValueError):
        create_model_config(arch(), device="cpu", aggregation="dense")
    # conv checkpointing is ported (tests/test_torch_optimizers.py holds it)
    assert create_model_config({**arch(), "conv_checkpointing": True},
                               device="cpu").conv_checkpointing
    # bf16 compute is ported: a bf16 forward runs and returns bf16, as
    # JAX's does in fused mode (tests/test_torch_bf16.py holds its values)
    model = create_model_config(arch(), device="cpu")
    batch = collate_graphs(samples(), *pad_sizes_for(10, 40, 6))
    batch = dataclasses.replace(batch, x=batch.x.to(torch.bfloat16))
    with torch.inference_mode():
        outs = model.eval().to(torch.bfloat16)(batch)
    assert [o.dtype for o in outs] == [torch.bfloat16, torch.bfloat16]
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)


def pytest_bridge_rejects_incomplete_variables():
    jbatch = jax.tree_util.tree_map(
        jnp.asarray, jax_collate(samples(), *pad_sizes_for(10, 40, 6))
    )
    variables = jax_variables(jax_create_model_config(arch()), jbatch)
    model = create_model_config(arch(), device="cpu")
    del variables["batch_stats"]["encoder_bn_1"]
    with pytest.raises(ValueError, match="not filled"):
        load_flax_variables(model, variables)
