"""Optimizer factory (port of ``train/optimizer.py``): every type of the
JAX package's table, with optax's numerics and hyperparameters.

``Adam`` and ``AdamW`` are ``torch.optim``'s, with optax's numbers: b1 0.9,
b2 0.999, eps 1e-8 added outside the square root, and for AdamW a weight
decay of 0.01 on every parameter (``optax.adamw`` with no mask).
``torch.optim.AdamW`` decays the parameter before the Adam update where
optax adds ``wd * p`` to the update: the two are equal in exact
arithmetic, not bitwise.

The other types, and every type under ``freeze_conv``, are
:class:`OptaxOptimizer`: optax's update rules written as plain tensor
functions (:data:`RULES`), because ``torch.optim`` computes something else
for most of them (its Adagrad starts its sum at 0 and puts eps outside the
root, its RMSprop puts eps outside the root, it has no LAMB):

- ``SGD``: ``optax.sgd``, the gradient itself.
- ``Adadelta``: ``optax.adadelta`` (rho 0.9, eps 1e-6).
- ``Adagrad``: ``optax.adagrad`` (the sum starts at 0.1; ``rsqrt(sum +
  1e-10)``, 0 where the sum is 0).
- ``Adamax``: ``optax.adamax`` (b1 0.9, b2 0.999, eps 1e-8).
- ``RMSprop``: ``optax.rmsprop`` (decay 0.99, ``rsqrt(nu + 1e-8)``: eps
  inside the root).
- ``LAMB`` and ``FusedLAMB``: ``optax.lamb`` (Adam at eps 1e-6, weight
  decay 0, then each parameter's trust ratio ``|p| / |u|``, 1 where either
  norm is 0).
- ``Adam``, ``AdamW``: as above, where ``freeze_conv`` needs this class.

``freeze_conv`` is the JAX package's ``freeze_mask_fn`` with
``optax.multi_transform`` and ``set_to_zero``: every parameter under an
``encoder_*`` module is frozen, and gets no update at all, weight decay
included; the heads train. Frozen parameters sit in a param group of
their own (``frozen`` True) with a step count and nothing else.

The learning rate is a 0-d float32 tensor on the parameters' device
(float32, as optax keeps it). On a CUDA device the optimizer is built for
capture (``capturable=True``): its step counts live on the card too, so
that a captured step (``train/capture.py``) reads the rate at every
replay, and a chunk's plateau (``steps.CapturedSteps.fit_dispatch``)
writes it there. :func:`set_learning_rate` writes that tensor in place: a
float ``lr`` would be baked into the captured update, and a plateau's new
rate would never reach it. On the CPU the rate is a CPU tensor, so that a
chunk's arithmetic on it is the code the card runs; ``torch.optim``'s step
there is its single-tensor one (``foreach=False``, ``capturable=False``),
which reads a tensor rate as its float value. :class:`OptaxOptimizer`
keeps every tensor of its state, step counts included, on the parameter's
device, and its step is tensor arithmetic with no host sync, so it
captures as it is. Its state exists from construction (Adagrad's sum at
0.1), so a capture's warm-up restores it like any other state.
"""

from typing import Callable, Dict, Tuple

import torch
from torch import nn

# optax's update rules: (gradient, parameter, state slots, step count) ->
# the update before the learning rate, the slots updated in place


def _moment(g, m, decay, order=1):
    # optax.tree.update_moment
    m.copy_((1 - decay) * g**order + decay * m)
    return m


def _sgd(g, p, st, t):
    return g


def _adadelta(g, p, st, t, rho=0.9, eps=1e-6):
    e_g = _moment(g, st["e_g"], rho, 2)
    u = torch.sqrt(st["e_x"] + eps) / torch.sqrt(e_g + eps) * g
    _moment(u, st["e_x"], rho, 2)
    return u


def _adagrad(g, p, st, t, eps=1e-10):
    s = st["sum_of_squares"]
    s.copy_(g * g + s)
    return torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g


def _adamax(g, p, st, t, b1=0.9, b2=0.999, eps=1e-8):
    mu = _moment(g, st["mu"], b1)
    nu = st["nu"]
    nu.copy_(torch.maximum(torch.abs(g) + eps, b2 * nu))
    return mu / (1 - b1**t) / nu


def _rmsprop(g, p, st, t, decay=0.99, eps=1e-8):
    return g * torch.rsqrt(_moment(g, st["nu"], decay, 2) + eps)


def _adam(g, p, st, t, eps=1e-8, b1=0.9, b2=0.999):
    mu, nu = _moment(g, st["mu"], b1), _moment(g, st["nu"], b2, 2)
    return mu / (1 - b1**t) / (torch.sqrt(nu / (1 - b2**t)) + eps)


def _adamw(g, p, st, t):
    return _adam(g, p, st, t) + 0.01 * p


def _lamb(g, p, st, t):
    u = _adam(g, p, st, t, eps=1e-6)
    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
    return u * ratio


# type -> (rule, its state slots, each slot's initial value)
RULES: Dict[str, Tuple[Callable, Dict[str, float]]] = {
    "SGD": (_sgd, {}),
    "Adadelta": (_adadelta, {"e_g": 0.0, "e_x": 0.0}),
    "Adagrad": (_adagrad, {"sum_of_squares": 0.1}),
    "Adamax": (_adamax, {"mu": 0.0, "nu": 0.0}),
    "RMSprop": (_rmsprop, {"nu": 0.0}),
    "LAMB": (_lamb, {"mu": 0.0, "nu": 0.0}),
    "FusedLAMB": (_lamb, {"mu": 0.0, "nu": 0.0}),
    "Adam": (_adam, {"mu": 0.0, "nu": 0.0}),
    "AdamW": (_adamw, {"mu": 0.0, "nu": 0.0}),
}


class OptaxOptimizer(torch.optim.Optimizer):
    """One of :data:`RULES` over named parameters, as optax applies it:
    ``p <- p + u * -lr``. The names under ``frozen`` form a group of their
    own that takes no update. Every parameter has a float32 ``step``
    (optax's count); the trainable ones also their rule's slots."""

    def __init__(self, named_params, kind: str, lr: torch.Tensor, frozen=frozenset()):
        self.kind = kind
        self.rule, self.slots = RULES[kind]
        groups = []
        for is_frozen in (False, True):
            named = [(n, p) for n, p in named_params if (n in frozen) == is_frozen]
            if named:
                groups.append({"params": [p for _, p in named],
                               "param_names": [n for n, _ in named], "frozen": is_frozen})
        super().__init__(groups, {"lr": lr, "frozen": False, "capturable": True})
        for group in self.param_groups:
            for p in group["params"]:
                st = {"step": torch.zeros((), dtype=torch.float32, device=p.device)}
                if not group["frozen"]:
                    st.update({k: torch.full_like(p, v, memory_format=torch.preserve_format)
                               for k, v in self.slots.items()})
                self.state[p] = st

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                st = self.state[p]
                st["step"].add_(1)
                if group["frozen"]:
                    continue
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.add_(self.rule(g, p, st, st["step"]) * -lr)


def frozen_names(model: nn.Module):
    """The parameters ``freeze_conv`` freezes (JAX ``freeze_mask_fn``):
    those under a top-level module whose name starts with ``encoder_``."""
    return frozenset(n for n, _ in model.named_parameters() if n.startswith("encoder_"))


def select_optimizer(training_config: dict, model: nn.Module,
                     freeze_conv: bool = False) -> torch.optim.Optimizer:
    """``Training.Optimizer.type`` (default ``AdamW``) at
    ``Training.Optimizer.learning_rate`` (default 1e-3) over ``model``'s
    named parameters (the names let ``models/bridge.py`` carry optax's
    state across); ``freeze_conv`` freezes the encoder (the module's
    docstring)."""
    opt_cfg = training_config.get("Optimizer", {})
    opt_type = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("learning_rate", 1e-3))
    if opt_type not in RULES:
        raise ValueError(f"Optimizer type not supported: {opt_type}")
    params = list(model.named_parameters())
    device = params[0][1].device if params else torch.device("cpu")
    lr = torch.tensor(lr, dtype=torch.float32, device=device)
    if freeze_conv or opt_type not in ("Adam", "AdamW"):
        return OptaxOptimizer(params, opt_type, lr,
                              frozen_names(model) if freeze_conv else frozenset())
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if device.type == "cuda":
        kw.update(capturable=True)
    else:
        kw.update(foreach=False)
    if opt_type == "AdamW":
        return torch.optim.AdamW(params, weight_decay=0.01, **kw)
    return torch.optim.Adam(params, **kw)


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
    copies need every tensor of the state before the first step. An
    :class:`OptaxOptimizer` has its state from construction."""
    if isinstance(optimizer, OptaxOptimizer):
        return optimizer
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
