"""Runtime analysis (port of ``hydragnn_tpu/analysis``): so far only the
NaN sentinel of ``guards.py``."""

from hydragnn_tpu_torch.analysis.guards import (
    NonFiniteError,
    nan_origin,
    nan_sentinel,
    nonfinite_report,
)

__all__ = ["NonFiniteError", "nan_origin", "nan_sentinel", "nonfinite_report"]
