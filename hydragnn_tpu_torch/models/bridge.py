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

Every parameter and buffer of the port must be filled, and every variable
must land, or the load raises.
"""

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from hydragnn_tpu_torch.models.base import MLPNode


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


def _target(model: nn.Module, path: Tuple[str, ...], collection: str):
    """(port parameter or buffer name, transpose?) for one flax leaf."""
    *mods, leaf = path
    prefix = ".".join(mods)
    if collection == "batch_stats":
        return f"{prefix}.{ {'mean': 'running_mean', 'var': 'running_var'}[leaf]}", False
    if leaf in ("final_kernel", "final_bias"):
        return f"{prefix}.final.{'weight' if leaf == 'final_kernel' else 'bias'}", leaf == "final_kernel"
    if isinstance(model.get_submodule(prefix), MLPNode):
        return f"{prefix}.{leaf}", False
    if leaf == "kernel":
        return f"{prefix}.weight", True
    if leaf == "scale":
        return f"{prefix}.weight", False
    return f"{prefix}.{leaf}", False


def load_flax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Fill ``model`` from the JAX package's variables (numpy leaves)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, transpose = _target(model, path, collection)
            if name not in targets:
                raise ValueError(f"{collection}/{'/'.join(path)}: the model has no {name}")
            tensor = targets[name]
            src = torch.from_numpy(np.ascontiguousarray(value.T if transpose else value))
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
