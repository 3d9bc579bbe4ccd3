"""Validated ``HYDRAGNN_*`` environment-knob parsing (a copy of the JAX
package's ``utils/envparse.py``, which the port does not import).

A numeric knob with a typo fails with an error that names the variable and
the offending text, not a bare ``int()`` traceback from deep inside a
thread.
"""

import os
from typing import Optional, Tuple

_FALSY = ("", "0", "false", "no", "off")


def env_int(name: str, default: int, minimum: Optional[int] = 0) -> int:
    """Integer knob: unset/empty -> ``default``; a non-integer or a value
    below ``minimum`` raises ``ValueError`` naming the variable
    (``minimum=None`` skips the range check)."""
    raw = os.getenv(name)
    if raw is None or raw.strip() == "":
        return int(default)
    try:
        value = int(raw.strip())
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    if minimum is not None and value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def env_float(name: str, default: float, minimum: Optional[float] = 0.0) -> float:
    """Float knob: unset/empty -> ``default``; a non-number (NaN included)
    or a value below ``minimum`` raises ``ValueError`` naming the
    variable."""
    raw = os.getenv(name)
    if raw is None or raw.strip() == "":
        return float(default)
    try:
        value = float(raw.strip())
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    if value != value:  # NaN: the comparison below would pass it
        raise ValueError(f"{name} must be a number, got {raw!r}")
    if minimum is not None and value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def env_flag(name: str) -> bool:
    """On/off knob: unset, empty, ``0``, ``false``, ``no`` and ``off``
    (any case) are off, anything else on (the JAX package's
    ``serve/costs.feedback_enabled`` rule)."""
    return os.getenv(name, "").strip().lower() not in _FALSY


def env_mesh(name: str = "HYDRAGNN_MESH") -> Optional[Tuple[Optional[int], int]]:
    """Mesh-shape knob: ``"d,m"`` -> ``(d, m)``, a bare model width ``"m"``
    -> ``(None, m)``, unset/empty -> None; malformed values raise
    ``ValueError`` naming the variable."""
    raw = os.getenv(name)
    if raw is None or raw.strip() == "":
        return None
    parts = [p.strip() for p in raw.split(",")]
    try:
        if len(parts) == 1:
            pair: Tuple[Optional[int], int] = (None, int(parts[0]))
        elif len(parts) == 2:
            pair = (int(parts[0]), int(parts[1]))
        else:
            raise ValueError
        if any(v is not None and v < 1 for v in pair):
            raise ValueError
    except ValueError:
        raise ValueError(
            f'{name}={raw!r} is not "data,model" or a bare model width '
            '(expected e.g. "4,2" or "2", positive integers)'
        ) from None
    return pair
