"""Model factory (port of ``models/create.py``).

``create_model_config(config["NeuralNetwork"]["Architecture"], ...)``
builds the stack named by ``model_type`` on the device, with its weights
drawn from a seeded ``torch.Generator``, in eval mode. Only PNA is ported;
the other eight stacks raise ``NotImplementedError`` (see ``ROADMAP.md``).
"""

from typing import Optional

import torch

from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.bridge import init_params
from hydragnn_tpu_torch.models.pna import PNAStack
from hydragnn_tpu_torch.utils.device import resolve_device

MODEL_TYPES = ["GIN", "PNA", "GAT", "MFC", "CGCNN", "SAGE", "SchNet", "DimeNet", "EGNN"]


def _normalize_weights(task_weights, num_heads):
    if task_weights is None:
        task_weights = [1.0] * num_heads
    if len(task_weights) != num_heads:
        raise ValueError(
            f"Inconsistent number of loss weights and tasks: "
            f"{len(task_weights)} VS {num_heads}"
        )
    s = sum(abs(w) for w in task_weights)
    return tuple(w / s for w in task_weights)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md")


def create_model_config(config: dict, device=None, aggregation: str = "fused",
                        seed: int = 0) -> HydraBase:
    """Build the model of the Architecture section ``config`` (after the
    JAX package's ``update_config``).

    ``device``: ``None`` means the card (raises without one); ``"cpu"``
    runs the plain PyTorch versions. ``aggregation``: ``"fused"`` (K3) or
    ``"segment"`` (K2) for PNA's statistics pass. ``seed`` seeds the
    ``torch.Generator`` the weights are drawn from."""
    dev = resolve_device(device)
    model_type = config["model_type"]
    if model_type not in MODEL_TYPES:
        raise ValueError(f"Unknown model_type: {model_type}")
    if model_type != "PNA":
        raise _not_ported(f"the {model_type} stack")
    if config.get("partition_axis") is not None:
        raise _not_ported("partition_axis (graph-partition parallelism)")
    if config.get("ilossweights_nll", 0):
        raise _not_ported("the uncertainty-weighted NLL loss")
    if config.get("conv_checkpointing", False):
        raise _not_ported("conv_checkpointing")
    if config.get("pna_deg") is None:
        raise ValueError("PNA requires degree input.")
    output_dim = tuple(config["output_dim"])
    model = PNAStack(
        deg=tuple(config["pna_deg"]),
        aggregation=aggregation,
        device=dev,
        input_dim=config["input_dim"],
        hidden_dim=config["hidden_dim"],
        output_dim=output_dim,
        output_type=tuple(config["output_type"]),
        config_heads=config["output_heads"],
        activation=config.get("activation_function", "relu"),
        num_conv_layers=config["num_conv_layers"],
        num_nodes=config.get("num_nodes"),
        edge_dim=config.get("edge_dim"),
        initial_bias=config.get("initial_bias"),
        loss_weights=_normalize_weights(config.get("task_weights"), len(output_dim)),
    )
    init_params(model, torch.Generator().manual_seed(int(seed)))
    return model.eval()
