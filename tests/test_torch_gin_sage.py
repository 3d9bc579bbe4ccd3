"""Port parity: the whole GIN and SAGE forward (eval) against the JAX
package's ``model.apply(..., train=False)``, weights carried across by
``models/bridge.py``, in both aggregation modes.

``"fused"`` (K4 / K5) runs against ``HYDRAGNN_AGG=fused`` and ``"segment"``
(a gather, then K1) against ``HYDRAGNN_PALLAS=1``; the Pallas kernels run
in interpret mode on the CPU. BatchNorm running statistics are non-trivial.
Only real rows are compared. Tolerance: rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import pad_sizes_for
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model_params

from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.ops import launch_counts

from test_torch_pna import JAX_ENV, samples
from test_torch_pna import arch as pna_arch

RTOL, ATOL = 1e-4, 1e-5
PAD = (10, 40, 6)  # max nodes, max edges, graphs: test_torch_pna's samples


def arch(model_type, node_type="mlp", hidden=8, layers=2, equivariance=False,
         edge_dim=None):
    cfg = pna_arch(node_type=node_type, edge_dim=edge_dim, hidden=hidden, layers=layers)
    cfg.update(
        model_type=model_type,
        equivariance=equivariance,
        # SchNet: the stack swaps the two, so 5 filters (an odd K6 width)
        # over 7 Gaussians
        num_gaussians=5,
        num_filters=7,
        radius=2.0,
    )
    return cfg


def jax_variables(model, batch, seed=0):
    """Initialised variables, as nested dicts of numpy arrays, with
    non-trivial BatchNorm running statistics where the model has any."""
    variables = jax.tree_util.tree_map(np.asarray, init_model_params(model, batch))
    rng = np.random.default_rng(seed + 100)
    for stats in variables.get("batch_stats", {}).values():
        f = stats["mean"].shape[0]
        stats["mean"] = rng.normal(0.0, 0.3, f).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
    return variables


def check_forward_matches_jax(monkeypatch, cfg, aggregation, seed=0):
    graphs = samples(seed=seed, with_edge_attr=cfg.get("edge_dim") is not None)
    n_pad, e_pad, g_pad = pad_sizes_for(*PAD)

    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_collate(graphs, n_pad, e_pad, g_pad))
    jmodel = jax_create_model_config(cfg)
    # the variables are the same in every mode (the fused branches declare
    # the same names and shapes), so init traces the plain XLA path, which
    # compiles faster than the Pallas interpreter
    variables = jax_variables(jmodel, jbatch, seed)
    env, value = JAX_ENV[aggregation]
    monkeypatch.setenv(env, value)
    # one program (traced now, under this case's env) runs faster than
    # the eager op-by-op apply
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    ref = [np.asarray(o) for o in apply(variables, jbatch)]

    model = create_model_config(cfg, device="cpu", aggregation=aggregation)
    load_flax_variables(model, variables)
    batch = collate_graphs(graphs, n_pad, e_pad, g_pad)
    before = launch_counts()
    with torch.inference_mode():
        got = [o.numpy() for o in model(batch)]
    assert launch_counts() == before  # the CPU runs the plain versions

    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    for kind, g, r in zip(cfg["output_type"], got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        m = masks[kind]
        np.testing.assert_allclose(g[m], r[m], rtol=RTOL, atol=ATOL)


CASES = [
    ("GIN", "fused", "mlp"),
    ("GIN", "segment", "conv"),
    ("SAGE", "fused", "conv"),
    ("SAGE", "segment", "mlp_per_node"),
]


@pytest.mark.parametrize("model_type,aggregation,node_type", CASES)
def pytest_gin_sage_forward_matches_jax(monkeypatch, model_type, aggregation, node_type):
    check_forward_matches_jax(monkeypatch, arch(model_type, node_type), aggregation)


@pytest.mark.parametrize("model_type", ["GIN", "SAGE", "SchNet", "EGNN"])
def pytest_port_modes_agree_and_seed_is_deterministic(model_type):
    """Both port modes compute one function from one seed, for every new
    family (SchNet and EGNN with their coordinate update on)."""
    cfg = arch(model_type, equivariance=True)
    batch = collate_graphs(samples(seed=3), *pad_sizes_for(*PAD))
    outs = []
    for aggregation in ("fused", "segment", "segment"):
        model = create_model_config(cfg, device="cpu", aggregation=aggregation, seed=5)
        with torch.inference_mode():
            outs.append([o.numpy() for o in model(batch)])
    nmask = batch.node_mask.numpy()
    np.testing.assert_array_equal(outs[1][0], outs[2][0])
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[0][1][nmask], outs[1][1][nmask], rtol=RTOL, atol=ATOL)
