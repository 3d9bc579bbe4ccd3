"""Deprecated shim (port of ``utils/profile.py``): ``Profiler`` and
``record_function`` live in :mod:`hydragnn_tpu_torch.obs.introspect`, beside
the on-demand trace capture (``/profile?steps=N``,
``HYDRAGNN_PROFILE_AT_STEP``). This module re-exports them for the old
import path and warns once, at its first import."""

import warnings

from hydragnn_tpu_torch.obs.introspect import (  # noqa: F401  (re-exported)
    Profiler,
    record_function,
)

warnings.warn(
    "hydragnn_tpu_torch.utils.profile is deprecated: Profiler/record_function "
    "moved to hydragnn_tpu_torch.obs.introspect (on-demand trace capture lives "
    "on the observability endpoint, /profile?steps=N)",
    DeprecationWarning,
    stacklevel=2,
)
