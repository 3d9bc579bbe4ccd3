"""Optimizer factory (port of ``train/optimizer.py``) for ``Adam`` and
``AdamW``, with optax's numerics: b1 0.9, b2 0.999, eps 1e-8 added outside
the square root, and for AdamW a weight decay of 0.01 on every parameter
(``optax.adamw`` with no mask). ``torch.optim.AdamW`` decays the parameter
before the Adam update where optax adds ``wd * p`` to the update: the two
are equal in exact arithmetic, not bitwise. The learning rate lives in each
param group, where :func:`set_learning_rate` rewrites it.

The learning rate is a 0-d float32 tensor on the parameters' device
(float32, as optax keeps it). On a CUDA device the optimizer is built for
capture (``capturable=True``): its step counts live on the card too, so
that a captured step (``train/capture.py``) reads the rate at every
replay, and a chunk's plateau (``steps.CapturedSteps.fit_dispatch``)
writes it there. :func:`set_learning_rate` writes that tensor in place: a
float ``lr`` would be baked into the captured update, and a plateau's new
rate would never reach it. On the CPU the rate is a CPU tensor, so that a
chunk's arithmetic on it is the code the card runs; the step there is
torch's single-tensor one (``foreach=False``, ``capturable=False``), which
reads a tensor rate as its float value.
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
    device = params[0][1].device if params else torch.device("cpu")
    kw = dict(lr=torch.tensor(lr, dtype=torch.float32, device=device), betas=(0.9, 0.999),
              eps=1e-8)
    if device.type == "cuda":
        kw.update(capturable=True)
    else:
        kw.update(foreach=False)
    if opt_type == "AdamW":
        return torch.optim.AdamW(params, weight_decay=0.01, **kw)
    if opt_type == "Adam":
        return torch.optim.Adam(params, **kw)
    if opt_type in _NOT_PORTED:
        raise NotImplementedError(
            f"the {opt_type} optimizer is not ported yet: see ROADMAP.md, queue 1, item 7"
        )
    raise ValueError(f"Optimizer type not supported: {opt_type}")


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The first param group's rate, read on the host (outside any
    captured region: a device rate is read back)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Every param group's rate, in place where it is a tensor."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return optimizer


def ensure_optimizer_state(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Create Adam's state for every parameter that has none yet, as
    torch's first step would (a zero step count, on the parameter's device
    when capturable, and zero moments): a chunk's snapshot and the guard's
    copies need every tensor of the state before the first step."""
    for group in optimizer.param_groups:
        capturable = group.get("capturable", False) or group.get("fused", False)
        for p in group["params"]:
            if optimizer.state.get(p):
                continue
            optimizer.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if capturable else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
    return optimizer
