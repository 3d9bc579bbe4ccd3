"""Serving observability endpoint: a re-export of ``obs/http.py`` (the
JAX package's ``serve/http.py`` does the same)."""

from hydragnn_tpu_torch.obs.http import ObservabilityServer  # noqa: F401  (re-exported API)

__all__ = ["ObservabilityServer"]
