from hydragnn_tpu_torch.models.base import HydraBase, MLPNode
from hydragnn_tpu_torch.models.bridge import init_params, load_flax_variables
from hydragnn_tpu_torch.models.common import (
    MLP,
    MaskedBatchNorm,
    SplitLinear,
    TorchLinear,
    get_activation,
    global_mean_pool,
)
from hydragnn_tpu_torch.models.create import MODEL_TYPES, create_model_config
from hydragnn_tpu_torch.models.pna import PNAConv, PNAStack, pna_degree_averages

__all__ = [
    "HydraBase",
    "MLP",
    "MLPNode",
    "MODEL_TYPES",
    "MaskedBatchNorm",
    "PNAConv",
    "PNAStack",
    "SplitLinear",
    "TorchLinear",
    "create_model_config",
    "get_activation",
    "global_mean_pool",
    "init_params",
    "load_flax_variables",
    "pna_degree_averages",
]
