"""Model factory (port of ``models/create.py``).

``create_model_config(config["NeuralNetwork"]["Architecture"], ...)``
builds the stack named by ``model_type`` on the device, with its weights
drawn from a seeded ``torch.Generator``, in eval mode. PNA, GIN, SAGE,
SchNet and EGNN are ported; GAT, MFC, CGCNN and DimeNet raise
``NotImplementedError`` (see ``ROADMAP.md``). :func:`resolve_precision` is
the JAX package's compute-precision decision, which the trainer reads.
"""

import os
from typing import Optional

import torch

from hydragnn_tpu_torch.models.base import HydraBase
from hydragnn_tpu_torch.models.bridge import init_params
from hydragnn_tpu_torch.models.egnn import EGCLStack
from hydragnn_tpu_torch.models.gin import GINStack
from hydragnn_tpu_torch.models.pna import PNAStack
from hydragnn_tpu_torch.models.sage import SAGEStack
from hydragnn_tpu_torch.models.schnet import SCFStack
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
    runs the plain PyTorch versions. ``aggregation``: ``"fused"`` (the
    fused message-passing kernels, K3-K7) or ``"segment"`` (a gather in
    PyTorch, then K2 for PNA and K1 for the rest). ``seed`` seeds the
    ``torch.Generator`` the weights are drawn from."""
    dev = resolve_device(device)
    model_type = config["model_type"]
    if model_type not in MODEL_TYPES:
        raise ValueError(f"Unknown model_type: {model_type}")
    if model_type not in ("PNA", "GIN", "SAGE", "SchNet", "EGNN"):
        raise _not_ported(f"the {model_type} stack")
    if config.get("partition_axis") is not None:
        raise _not_ported("partition_axis (graph-partition parallelism)")
    if config.get("conv_checkpointing", False):
        raise _not_ported("conv_checkpointing")
    output_dim = tuple(config["output_dim"])
    common = dict(
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
        equivariance=config.get("equivariance", False),
        loss_function_type=config.get("loss_function_type", "mse"),
        loss_nll=bool(config.get("ilossweights_nll", 0)),
    )
    if model_type == "PNA":
        if config.get("pna_deg") is None:
            raise ValueError("PNA requires degree input.")
        model = PNAStack(deg=tuple(config["pna_deg"]), **common)
    elif model_type == "GIN":
        model = GINStack(**common)
    elif model_type == "SAGE":
        model = SAGEStack(**common)
    elif model_type == "SchNet":
        for key in ("num_gaussians", "num_filters", "radius"):
            if config.get(key) is None:
                raise ValueError(f"SchNet requires {key} input.")
        # the JAX package passes the two widths swapped, for parity with
        # the reference (its models/create.py:118-127): the stack gets
        # num_filters = config["num_gaussians"] and the other way round
        model = SCFStack(
            num_filters=config["num_gaussians"],
            num_gaussians=config["num_filters"],
            radius=config["radius"],
            **common,
        )
    else:
        model = EGCLStack(**{**common, "edge_dim": config.get("edge_dim") or 0})
    init_params(model, torch.Generator().manual_seed(int(seed)))
    return model.eval()


# ---------------------------------------------------------------------------
# compute precision (port of ``resolve_precision``)
# ---------------------------------------------------------------------------

# the stack class -> the JAX package's model key (``ops/autotune.py``)
_STACK_KEYS = {
    "PNAStack": "PNA",
    "GINStack": "GIN",
    "SAGEStack": "SAGE",
    "SCFStack": "SchNet",
    "EGCLStack": "EGNN",
}

# the JAX package's width table: under ``mixed_precision: "auto"`` a stack
# computes in bf16 from this hidden width up (DimeNet stays f32)
BF16_AUTO_MIN_HIDDEN = {
    "PNA": 128,
    "GAT": 128,
    "GIN": 128,
    "SAGE": 128,
    "MFC": 128,
    "CGCNN": 128,
    "SchNet": 128,
    "EGNN": 128,
}


def resolve_precision(model, training_config: dict) -> dict:
    """Whether the forward and backward compute in bf16, decided as the
    JAX package decides it. Order: ``HYDRAGNN_MIXED_PRECISION=0/1``; an
    explicit ``Training.mixed_precision`` true/false; ``"auto"``, bf16 when
    the stack is in :data:`BF16_AUTO_MIN_HIDDEN` and its hidden width
    reaches the threshold; absent, f32. Returns ``{"mixed": bool,
    "source": "env" | "explicit" | "policy" | "default"}``."""
    env = os.getenv("HYDRAGNN_MIXED_PRECISION")
    if env is not None and env.strip() != "":
        off = env.strip().lower() in ("0", "false", "no", "off")
        return {"mixed": not off, "source": "env"}
    flag = training_config.get("mixed_precision", False)
    if isinstance(flag, str) and flag.strip().lower() == "auto":
        name = type(model).__name__
        threshold = BF16_AUTO_MIN_HIDDEN.get(_STACK_KEYS.get(name, name.replace("Stack", "")))
        mixed = threshold is not None and int(getattr(model, "hidden_dim", 0) or 0) >= threshold
        return {"mixed": mixed, "source": "policy"}
    return {
        "mixed": bool(flag),
        "source": "explicit" if "mixed_precision" in training_config else "default",
    }
