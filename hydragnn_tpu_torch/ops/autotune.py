"""Which aggregation a stack's batches take: the static tier of the JAX
package's ``ops/autotune.py`` (``:53-105``).

The JAX package measured where its dense neighbour-list branch overtakes
the segment reductions, per stack and width, on its TPU; these tables are
that policy, copied as it is. The per-bucket measured cache
(``autotune_bucket``) is not ported (``ROADMAP.md``, queue 1).
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
