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
from hydragnn_tpu_torch.models.cgcnn import CGCNNStack, CGConv
from hydragnn_tpu_torch.models.create import (
    MODEL_TYPES,
    create_model_config,
    init_model_params,
    print_model,
)
from hydragnn_tpu_torch.models.dimenet import DIMEStack, DimeNetConv
from hydragnn_tpu_torch.models.egnn import E_GCL, EGCLStack
from hydragnn_tpu_torch.models.gat import GATStack, GATv2Conv
from hydragnn_tpu_torch.models.gin import GINConv, GINStack
from hydragnn_tpu_torch.models.mfc import MFConv, MFCStack
from hydragnn_tpu_torch.models.pna import PNAConv, PNAStack, pna_degree_averages
from hydragnn_tpu_torch.models.sage import SAGEConv, SAGEStack
from hydragnn_tpu_torch.models.schnet import CFConv, SCFStack

__all__ = [
    "CFConv",
    "CGCNNStack",
    "CGConv",
    "DIMEStack",
    "DimeNetConv",
    "EGCLStack",
    "E_GCL",
    "GATStack",
    "GATv2Conv",
    "GINConv",
    "GINStack",
    "HydraBase",
    "MFCStack",
    "MFConv",
    "MLP",
    "MLPNode",
    "MODEL_TYPES",
    "MaskedBatchNorm",
    "PNAConv",
    "PNAStack",
    "SAGEConv",
    "SAGEStack",
    "SCFStack",
    "SplitLinear",
    "TorchLinear",
    "create_model_config",
    "init_model_params",
    "print_model",
    "get_activation",
    "global_mean_pool",
    "init_params",
    "load_flax_variables",
    "pna_degree_averages",
]
