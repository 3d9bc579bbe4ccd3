"""Optimizer factory (port of ``train/optimizer.py``) for ``Adam`` and
``AdamW``, with optax's numerics: b1 0.9, b2 0.999, eps 1e-8 added outside
the square root, and for AdamW a weight decay of 0.01 on every parameter
(``optax.adamw`` with no mask). ``torch.optim.AdamW`` decays the parameter
before the Adam update where optax adds ``wd * p`` to the update: the two
are equal in exact arithmetic, not bitwise. The learning rate lives in each
param group, where :func:`set_learning_rate` rewrites it.
"""

import torch
from torch import nn

_NOT_PORTED = (
    "SGD", "Adadelta", "Adagrad", "Adamax", "RMSprop", "FusedLAMB", "LAMB",
)


def select_optimizer(training_config: dict, model: nn.Module,
                     freeze_conv: bool = False) -> torch.optim.Optimizer:
    """``Training.Optimizer.type`` (default ``AdamW``) at
    ``Training.Optimizer.learning_rate`` (default 1e-3) over ``model``'s
    named parameters (the names let ``models/bridge.py`` carry optax's
    state across)."""
    opt_cfg = training_config.get("Optimizer", {})
    opt_type = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("learning_rate", 1e-3))
    if freeze_conv:
        raise NotImplementedError(
            "freeze_conv is not ported yet: see ROADMAP.md, queue 1, item 7"
        )
    params = list(model.named_parameters())
    if opt_type == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    if opt_type == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if opt_type in _NOT_PORTED:
        raise NotImplementedError(
            f"the {opt_type} optimizer is not ported yet: see ROADMAP.md, queue 1, item 7"
        )
    raise ValueError(f"Optimizer type not supported: {opt_type}")


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer
