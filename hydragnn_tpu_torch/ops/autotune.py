"""Which aggregation a stack's batches take: the static tier of the JAX
package's ``ops/autotune.py`` (``:53-105``).

The JAX package measured where its dense neighbour-list branch overtakes
the segment reductions, per stack and width, on its TPU; these tables are
that policy, copied as it is. The per-bucket measured cache
(``autotune_bucket``) is not ported (``ROADMAP.md``, queue 1).

:func:`fused_choice` is the environment's part of the JAX package's
``use_fused`` (``:348-368``): ``HYDRAGNN_FUSED_MP=0`` forbids the fused
kernels and beats ``HYDRAGNN_AGG=fused``; with ``HYDRAGNN_AGG`` unset,
``HYDRAGNN_FUSED_MP=1`` asks for them where the stack has a fused op. The
JAX package also requires its VMEM guard to pass; the port's kernels have
no such limit, so nothing stands in for it.
"""

import os
from typing import Optional

CHOICES = ("segment", "dense", "fused")

# minimum hidden_dim at which the dense branch is picked, per stack
DENSE_AUTO_MIN_HIDDEN = {
    "PNA": 96,
    "GAT": 96,
    "MFC": 96,
    "DimeNet": 96,
    "GIN": 192,
    "SAGE": 192,
}

# CGCNN's convs run at input_dim width: the dense branch up to this width
DENSE_AUTO_MAX_INPUT_DIM = {
    "CGCNN": 64,
}


def auto_dense_aggregation(arch_config: dict) -> bool:
    """Dense iff the stack's width sits on the dense side of the tables:
    ``hidden_dim`` at or above :data:`DENSE_AUTO_MIN_HIDDEN`, or for CGCNN
    ``input_dim`` in ``[1, 64]``."""
    mt = arch_config.get("model_type")
    th_in = DENSE_AUTO_MAX_INPUT_DIM.get(mt)
    if th_in is not None:
        dim = int(arch_config.get("input_dim") or 0)
        return 1 <= dim <= th_in
    th = DENSE_AUTO_MIN_HIDDEN.get(mt)
    return th is not None and int(arch_config.get("hidden_dim") or 0) >= th


def static_aggregation_choice(arch_config: dict) -> str:
    """``"dense"`` or ``"segment"`` from the tables alone."""
    return "dense" if auto_dense_aggregation(arch_config) else "segment"


def env_force() -> Optional[str]:
    """``HYDRAGNN_AGG`` when it names one of :data:`CHOICES`, else None."""
    v = (os.getenv("HYDRAGNN_AGG") or "").strip().lower()
    return v if v in CHOICES else None


# the stacks with a fused message-passing op (K3-K7)
FUSED_STACKS = ("PNA", "GIN", "SAGE", "SchNet", "EGNN")


def fused_forbidden() -> bool:
    """``HYDRAGNN_FUSED_MP=0``: the fused kill switch."""
    return (os.getenv("HYDRAGNN_FUSED_MP") or "").strip() == "0"


def fused_forced() -> bool:
    return (os.getenv("HYDRAGNN_FUSED_MP") or "").strip() == "1"


def fused_choice(model_type: Optional[str] = None) -> Optional[str]:
    """``"fused"`` or ``"segment"`` as the environment decides the
    model's aggregation, or None when it leaves it open: the kill switch
    first, then ``HYDRAGNN_AGG`` (``fused`` or ``segment``; ``dense`` is a
    layout decision, whose batches take the lists' branch), then
    ``HYDRAGNN_FUSED_MP=1`` for a stack in :data:`FUSED_STACKS`."""
    forced = env_force()
    if forced == "fused" and fused_forbidden():
        return "segment"
    if forced in ("fused", "segment"):
        return forced
    if forced is None and fused_forced() and model_type in FUSED_STACKS:
        return "fused"
    return None
