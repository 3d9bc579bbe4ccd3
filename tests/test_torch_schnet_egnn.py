"""Port parity: the whole SchNet and EGNN forward (eval) against the JAX
package's ``model.apply(..., train=False)``, weights carried across by
``models/bridge.py``, in both aggregation modes (``"fused"``: K6 / K7
against ``HYDRAGNN_AGG=fused``; ``"segment"``: a gather and K1 against
``HYDRAGNN_PALLAS=1``, Pallas in interpret mode).

The cases cover SchNet with its coordinate update on (gated off on the
last layer), EGNN with and without it, a ``conv`` node head (its own
BatchNorm, its output conv a last layer) and EGNN's encoded edge features
(``ze``). Only real rows are compared. Tolerance: rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydragnn_tpu.graph import collate_graphs as jax_collate
from hydragnn_tpu.graph import pad_sizes_for
from hydragnn_tpu.models import create_model_config as jax_create_model_config

from hydragnn_tpu_torch.models import create_model_config, load_flax_variables

from test_torch_gin_sage import PAD, arch, check_forward_matches_jax, jax_variables
from test_torch_pna import samples

CASES = [
    # model_type, aggregation, node head, equivariance, edge_dim
    ("SchNet", "fused", "mlp", False, None),
    ("SchNet", "segment", "mlp", True, None),
    ("SchNet", "fused", "conv", True, None),
    ("EGNN", "fused", "mlp", True, None),
    ("EGNN", "segment", "conv", True, None),
    ("EGNN", "fused", "conv", False, 1),
]


@pytest.mark.parametrize("model_type,aggregation,node_type,equivariance,edge_dim", CASES)
def pytest_schnet_egnn_forward_matches_jax(monkeypatch, model_type, aggregation,
                                          node_type, equivariance, edge_dim):
    cfg = arch(model_type, node_type, equivariance=equivariance, edge_dim=edge_dim)
    check_forward_matches_jax(monkeypatch, cfg, aggregation, seed=1)


def pytest_bridge_places_raw_leaves_and_rejects_the_rest():
    """EGNN and SchNet have no encoder BatchNorm and raw ``self.param``
    leaves; a missing one leaves a port tensor unfilled, an unknown one has
    no place."""
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_collate(samples(), *pad_sizes_for(*PAD)))
    for model_type in ("EGNN", "SchNet"):
        cfg = arch(model_type, equivariance=True)
        variables = jax_variables(jax_create_model_config(cfg), jbatch)
        assert not any(k.startswith("encoder_bn") for k in variables.get("batch_stats", {}))
        model = create_model_config(cfg, device="cpu")
        load_flax_variables(model, variables)
        del variables["params"]["encoder_conv_0"]["coord_mlp_1"]
        with pytest.raises(ValueError, match="not filled"):
            load_flax_variables(model, variables)
        # the last conv has no coordinate update, so no place for this one
        variables["params"]["encoder_conv_1"]["coord_mlp_1"] = np.zeros((8, 1), np.float32)
        with pytest.raises(ValueError, match="has no"):
            load_flax_variables(model, variables)
