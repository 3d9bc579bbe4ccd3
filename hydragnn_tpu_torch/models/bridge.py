"""Weights for the port's models: seeded init, and the bridge from the JAX
package's variables.

:func:`load_flax_variables` takes the JAX package's ``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays (convert with
``np.asarray`` on the JAX side; this module never sees a JAX type) and
fills the port's parameters and buffers. The port's modules carry the
JAX package's names, so a variable's path is its module's path:

| Flax leaf | Port |
|-----------|------|
| ``.../kernel [in, out]`` of a Dense | ``.../weight [out, in]`` (transposed) |
| ``.../bias`` | ``.../bias`` |
| ``.../final_kernel``, ``.../final_bias`` of an MLP | ``.../final.weight`` (transposed), ``.../final.bias`` |
| ``.../kernel_{k}``, ``.../bias_{k}`` of an MLPNode bank | the same, as they are |
| ``.../scale`` of a BatchNorm | ``.../weight`` |
| ``batch_stats/.../mean``, ``.../var`` | ``.../running_mean``, ``.../running_var`` |
| raw ``self.param`` arrays: GIN's ``eps`` (0-d), SchNet's ``lin1``, ``lin2``, ``bias2``, ``coord_mlp_1`` of SchNet and EGNN; MFC's banks ``w_l``, ``b_l``, ``w_r``; GAT's ``w_l``, ``b_l``, ``w_r``, ``b_r``, ``att``, ``bias``; DimeNet's ``rbf/freq`` | the same name, as they are (the port keeps them in the ``x @ W`` layout) |

DimeNet's ``TorchLinear``s (with and without a bias) and its residual
layers (``before_skip_*/lin1``, ``after_skip_*/lin2``, ...) are the Dense
rows above. A stack without encoder BatchNorm (SchNet, EGNN, DimeNet) has
no ``encoder_bn_*`` on either side. Every parameter and persistent buffer of the port must be
filled, and every variable must land, or the load raises.

:func:`load_optax_adam_state` carries optax's Adam/AdamW state (``mu``,
``nu``, ``count``, and the injected learning rate) into a ``torch.optim``
optimizer built by ``train.optimizer.select_optimizer`` (which names its
parameters), by the same path mapping, and the learning rate that optax keeps in
``opt_state.hyperparams`` (``optax.inject_hyperparams``) into every param
group's ``lr``.

The reverse direction writes the tree the JAX package checkpoints for its
``TrainState`` (``flax.serialization.to_state_dict`` of it):
:func:`flax_variables_of` (the port's parameters and BatchNorm statistics
as ``{"params", "batch_stats"}``), :func:`optax_state_of` (the optimizer
as ``optax.inject_hyperparams(adam or adamw)``'s state: ``count``,
``hyperparams.learning_rate``, ``hyperparams_states`` and
``inner_state``, ``{"0": {count, mu, nu}, "1": {}, ...}`` with one empty
state per transform after ``scale_by_adam``), and :func:`state_dict_of`
for a whole ``TrainState``. :func:`restore_state` loads such a tree
into a ``TrainState``.
"""

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn



def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from ``generator``: torch-style
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for linear layers and MLP banks,
    ones/zeros for BatchNorm (running mean 0, var 1). Children are reset
    before their parent, so a parent may adjust what its children drew."""

    def reset(module: nn.Module):
        for child in module.children():
            reset(child)
        fn = getattr(module, "reset_parameters", None)
        if fn is not None:
            fn(generator)

    reset(model)
    return model


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _target(path: Tuple[str, ...], collection: str):
    """(port parameter or buffer name, transpose?) for one flax leaf. An
    MLPNode bank's ``kernel_{k}``/``bias_{k}`` keep their names and
    layout."""
    *mods, leaf = path
    prefix = ".".join(mods)
    if collection == "batch_stats":
        return f"{prefix}.{ {'mean': 'running_mean', 'var': 'running_var'}[leaf]}", False
    if leaf in ("final_kernel", "final_bias"):
        return f"{prefix}.final.{'weight' if leaf == 'final_kernel' else 'bias'}", leaf == "final_kernel"
    if leaf == "kernel":
        return f"{prefix}.weight", True
    if leaf == "scale":
        return f"{prefix}.weight", False
    return f"{prefix}.{leaf}", False


def load_flax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Fill ``model`` from the JAX package's variables (numpy leaves)."""
    persistent = model.state_dict().keys()
    targets = dict(model.named_parameters())
    targets.update((k, b) for k, b in model.named_buffers() if k in persistent)
    filled = set()
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, transpose = _target(path, collection)
            if name not in targets:
                raise ValueError(f"{collection}/{'/'.join(path)}: the model has no {name}")
            tensor = targets[name]
            value = value.T if transpose else value
            src = _as_tensor(value)
            if tuple(src.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"{collection}/{'/'.join(path)}: shape {tuple(src.shape)} "
                    f"does not fit {name} {tuple(tensor.shape)}"
                )
            with torch.no_grad():
                tensor.copy_(src)
            filled.add(name)
    missing = set(targets) - filled
    if missing:
        raise ValueError(f"not filled from the variables: {sorted(missing)}")
    return model


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf of a checkpoint
        return value
    # a copy: checkpoint leaves are read-only views of the file's bytes
    return torch.from_numpy(np.array(value, copy=True))


def _find_adam_state(tree):
    """The first node of ``tree`` with ``mu``, ``nu`` and ``count`` (optax's
    ``ScaleByAdamState``, or a dict with those keys), searched through
    tuples, lists and dicts."""
    if isinstance(tree, dict):
        if {"mu", "nu", "count"} <= set(tree):
            return tree
        children = list(tree.values())
    elif all(hasattr(tree, k) for k in ("mu", "nu", "count")):
        return {"mu": tree.mu, "nu": tree.nu, "count": tree.count}
    elif isinstance(tree, (tuple, list)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def load_optax_adam_state(optimizer: torch.optim.Optimizer, opt_state) -> torch.optim.Optimizer:
    """Fill ``optimizer`` (``torch.optim.Adam`` or ``AdamW`` over named
    parameters) from optax's Adam state with numpy leaves (convert with
    ``jax.tree_util.tree_map(np.asarray, opt_state)`` on the JAX side):
    ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``, ``count`` -> ``step``
    (both count the updates taken, so the bias corrections agree), and an
    injected ``learning_rate`` -> every group's ``lr``. Every parameter must
    get its moments, or the load raises."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    params = {}
    for group in optimizer.param_groups:
        names = group.get("param_names")
        if names is None:
            raise ValueError("the optimizer must be built over named parameters")
        params.update(zip(names, group["params"]))
    moments = {}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for path, value in _flatten(adam[key]):
            name, transpose = _target(path, "params")
            if name not in params:
                raise ValueError(f"opt_state/{key}/{'/'.join(path)}: no parameter {name}")
            src = _as_tensor(value.T if transpose else value)
            p = params[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(
                    f"opt_state/{key}/{'/'.join(path)}: shape {tuple(src.shape)} "
                    f"does not fit {name} {tuple(p.shape)}"
                )
            moments.setdefault(name, {})[torch_key] = src.to(p.device, p.dtype).clone()
    missing = [n for n in params if len(moments.get(n, {})) != 2]
    if missing:
        raise ValueError(f"no Adam moments for: {sorted(missing)}")
    step = float(np.asarray(adam["count"]))
    for name, p in params.items():
        optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32), **moments[name]}
    hyper = (opt_state.get("hyperparams") if isinstance(opt_state, dict)
             else getattr(opt_state, "hyperparams", None))
    if hyper is not None and "learning_rate" in hyper:
        for group in optimizer.param_groups:
            group["lr"] = float(np.asarray(hyper["learning_rate"]))
    return optimizer


# ---------------------------------------------------------------------------
# the reverse direction: the port's state as the JAX package's tree
# ---------------------------------------------------------------------------

# the transforms optax chains after scale_by_adam, each with an empty state
_EMPTY_STATES = {torch.optim.AdamW: 2, torch.optim.Adam: 1}


def _flax_path(model: nn.Module, name: str, collection: str):
    """``(flax path, transpose?)`` of the port's parameter or buffer
    ``name``: the inverse of :func:`_target`, checked against it."""
    *mods, leaf = name.split(".")
    if collection == "batch_stats":
        leaf = {"running_mean": "mean", "running_var": "var"}[leaf]
    elif mods and mods[-1] == "final" and leaf in ("weight", "bias"):
        mods, leaf = mods[:-1], "final_kernel" if leaf == "weight" else "final_bias"
    elif leaf == "weight":
        from hydragnn_tpu_torch.models.common import MaskedBatchNorm

        owner = model.get_submodule(".".join(mods))
        leaf = "scale" if isinstance(owner, MaskedBatchNorm) else "kernel"
    path = tuple(mods) + (leaf,)
    back, transpose = _target(path, collection)
    if back != name:
        raise ValueError(f"{name} has no flax path (it maps back to {back})")
    return path, transpose


def _nest(tree: Dict, path: Tuple[str, ...], value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _to_numpy(t: torch.Tensor, transpose: bool) -> np.ndarray:
    arr = t.detach().cpu()
    if arr.dtype == torch.bfloat16:
        arr = arr.float()
    arr = arr.numpy()
    arr = arr.T if transpose else arr
    # ascontiguousarray makes a 0-d leaf (GIN's eps) 1-d: reshape back
    return np.ascontiguousarray(arr).reshape(arr.shape)


def flax_variables_of(model: nn.Module) -> Dict:
    """``{"params": ..., "batch_stats": ...}`` of ``model`` in the JAX
    package's names and layouts (numpy leaves): what
    :func:`load_flax_variables` reads back."""
    out = {"params": {}, "batch_stats": {}}
    persistent = model.state_dict().keys()
    for name, p in model.named_parameters():
        path, transpose = _flax_path(model, name, "params")
        _nest(out["params"], path, _to_numpy(p, transpose))
    for name, b in model.named_buffers():
        if name in persistent:
            path, transpose = _flax_path(model, name, "batch_stats")
            _nest(out["batch_stats"], path, _to_numpy(b, transpose))
    return out


def optax_state_of(optimizer: torch.optim.Optimizer, model: nn.Module) -> Dict:
    """The state of ``optax.inject_hyperparams(adamw or adam)`` that the
    JAX package's optimizer holds after as many updates as ``optimizer``
    took: Adam's moments in flax's layout (zeros before the first step),
    both counts, and the learning rate of the first param group, float32
    as optax keeps it."""
    kind = type(optimizer)
    if kind not in _EMPTY_STATES:
        raise ValueError(f"no optax counterpart for {kind.__name__}")
    mu, nu = {}, {}
    count = 0
    for group in optimizer.param_groups:
        names = group.get("param_names")
        if names is None:
            raise ValueError("the optimizer must be built over named parameters")
        for name, p in zip(names, group["params"]):
            path, transpose = _flax_path(model, name, "params")
            state = optimizer.state.get(p, {})
            zeros = torch.zeros_like(p, dtype=torch.float32)
            _nest(mu, path, _to_numpy(state.get("exp_avg", zeros), transpose))
            _nest(nu, path, _to_numpy(state.get("exp_avg_sq", zeros), transpose))
            if "step" in state:
                count = max(count, int(float(state["step"])))
    count = np.asarray(count, np.int32)
    inner = {"0": {"count": count, "mu": mu, "nu": nu}}
    inner.update({str(i): {} for i in range(1, 1 + _EMPTY_STATES[kind])})
    return {
        "count": count,
        "hyperparams": {
            "learning_rate": np.asarray(optimizer.param_groups[0]["lr"], np.float32)
        },
        "hyperparams_states": {},
        "inner_state": inner,
    }


def state_dict_of(state) -> Dict:
    """The tree the JAX package checkpoints for its ``TrainState``
    (``{"params", "batch_stats", "opt_state", "step"}``) of the port's
    ``TrainState``."""
    variables = flax_variables_of(state.model)
    return {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": optax_state_of(state.optimizer, state.model),
        "step": np.asarray(state.step, np.int32),
    }


def restore_state(state, restored: Dict):
    """Load a checkpoint's tree (``params``, ``batch_stats``, and
    ``opt_state`` and ``step`` when present) into ``state`` in place: the
    weights, Adam's moments and count, and the learning rate."""
    load_flax_variables(state.model, {"params": restored["params"],
                                      "batch_stats": restored.get("batch_stats", {})})
    if restored.get("opt_state") is not None:
        load_optax_adam_state(state.optimizer, restored["opt_state"])
    if restored.get("step") is not None:
        state.step = int(np.asarray(restored["step"]))
    return state
