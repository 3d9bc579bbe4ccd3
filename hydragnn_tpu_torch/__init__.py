"""hydragnn_tpu_torch — the PyTorch/CUDA port of hydragnn_tpu for one
NVIDIA H100.

The JAX package ``hydragnn_tpu`` is the reference; this package imports
nothing of it, nor JAX. Its kernels are CUDA C++ for ``sm_90a``
(``csrc/``), built at first use (``ops/_build.py``); each has a plain
PyTorch version beside it, which runs for tensors on the CPU. Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: the public entry points ``run_training(config)`` and
``run_prediction(config)`` on the single-process path (the ``LSMS`` and
``unit_test`` data formats, the epoch driver with its plateau learning
rate, early stopping and checkpoints in the JAX package's v2 format, which
both packages read); all nine stacks (PNA, GIN, SAGE, SchNet, EGNN, GAT,
MFC, CGCNN, DimeNet) built, served through ``serve.InferenceServer``
(``ModelRegistry.load_checkpoint`` serves a trained run) and trained
through ``train.Trainer``, in f32 or bf16 mixed precision, in the
``fused``, ``segment`` and dense neighbour-list branches;
``benchmarks.model_bench`` times the step (see ``ROADMAP.md`` for what
follows).
"""

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.run_prediction import run_prediction
from hydragnn_tpu_torch.run_training import run_training
from hydragnn_tpu_torch.serve import InferenceServer, ModelRegistry, plan_from_samples
from hydragnn_tpu_torch.utils import resolve_device

__all__ = [
    "GraphData",
    "InferenceServer",
    "ModelRegistry",
    "create_model_config",
    "plan_from_samples",
    "resolve_device",
    "run_prediction",
    "run_training",
]
