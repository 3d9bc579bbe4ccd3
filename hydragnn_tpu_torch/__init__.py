"""hydragnn_tpu_torch — the PyTorch/CUDA port of hydragnn_tpu for one
NVIDIA H100.

The JAX package ``hydragnn_tpu`` is the reference; this package imports
nothing of it, nor JAX. Its kernels are CUDA C++ for ``sm_90a``
(``csrc/``), built at first use (``ops/_build.py``); each has a plain
PyTorch version beside it, which runs for tensors on the CPU. Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: multi-head PNA inference served through
``serve.InferenceServer`` (see ``ROADMAP.md`` for what follows).
"""

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.serve import InferenceServer, ModelRegistry, plan_from_samples
from hydragnn_tpu_torch.utils import resolve_device

__all__ = [
    "GraphData",
    "InferenceServer",
    "ModelRegistry",
    "create_model_config",
    "plan_from_samples",
    "resolve_device",
]
