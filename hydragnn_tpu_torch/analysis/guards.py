"""The NaN sentinel (port of ``analysis/guards.py``'s ``NonFiniteError``,
``nonfinite_report``, ``nan_origin`` and ``nan_sentinel``; the module's
other guards are not ported).

With ``HYDRAGNN_NAN_SENTINEL=1`` the trainer's ``train_step`` and
``train_multi`` programs are wrapped (``steps.CapturedSteps``): after each
replay the step's metrics and the whole training state are read back, and
the first non-finite tensor raises :class:`NonFiniteError` naming it. The
check runs outside the captured graph, which is unchanged; it costs a
readback of the state a step, so it is a debugging aid, off by default.

A tree here is a list of ``(name, tensor)`` pairs in the order to search.
The trainer builds it as the JAX sentinel walks its ``(state, metrics)``
output (``steps.sentinel_tree``): the parameters in flax's sorted order,
then the BatchNorm statistics, the optimizer's moments, and the metrics.
Each name is the port's ``state_dict`` key, followed where
``models/bridge.py`` maps the tensor by the JAX sentinel's path for it
(``[0].params['graph_convs_0']['bias']``).
"""

import re
from typing import Dict, List, Optional, Tuple

import torch


class NonFiniteError(FloatingPointError):
    """A sentinel-wrapped region produced NaN or Inf; the message and
    :attr:`origin` name the first offending tensor."""

    def __init__(self, message: str, origin: Dict):
        super().__init__(message)
        self.origin = origin


def nonfinite_report(tree) -> List[Tuple[str, int]]:
    """``(name, non-finite count)`` of every floating tensor of ``tree``
    (``(name, tensor)`` pairs, or a dict) holding a NaN or Inf, in the
    tree's order. Integer and boolean tensors count as finite."""
    items = tree.items() if isinstance(tree, dict) else tree
    bad = []
    for name, t in items:
        if not torch.is_tensor(t) or not (t.is_floating_point() or t.is_complex()):
            continue
        n = int((~torch.isfinite(t.detach())).sum())
        if n:
            bad.append((name, n))
    return bad


def _subtree_of(path: str) -> str:
    """The first named component of a JAX path (bare indices and the
    ``params``/``opt_state``/``state`` containers skipped), or of a port
    key: the group to blame."""
    jax_path = path.split(" = ")[-1]
    parts = [p for p in re.split(r"[\[\].']+", jax_path) if p and p != "<root>" and not p.isdigit()]
    for part in parts:
        if part not in ("params", "opt_state", "state"):
            return part
    return parts[0] if parts else path


def nan_origin(tree, scope: str) -> Optional[Dict]:
    """The first non-finite tensor of ``tree`` as an event payload
    (``scope``, ``origin``, ``subtree``, ``leaves``, ``total``), or None
    when every tensor is finite. Reads the tensors back."""
    bad = nonfinite_report(tree)
    if not bad:
        return None
    items = list(tree.items() if isinstance(tree, dict) else tree)
    first, _ = bad[0]
    return {"scope": scope, "origin": first, "subtree": _subtree_of(first),
            "leaves": len(bad), "total": len(items)}


def nan_sentinel(fn, *, scope: str, tree_of=None):
    """Wrap a step: when the tree of its output (``tree_of(out)``; the
    output itself without it) holds NaN or Inf, raise
    :class:`NonFiniteError` with :func:`nan_origin`'s payload, naming the
    first offending tensor."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if out is None:  # a capture without a replay (``run=False``)
            return out
        origin = nan_origin(out if tree_of is None else tree_of(out), scope)
        if origin is not None:
            raise NonFiniteError(
                f"{scope}: non-finite output at {origin['origin']} "
                f"(subtree `{origin['subtree']}`, "
                f"{origin['leaves']}/{origin['total']} leaf/leaves affected)",
                origin)
        return out

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapped
