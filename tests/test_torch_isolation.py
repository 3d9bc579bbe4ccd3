"""The port stands alone: ``hydragnn_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax, optax or the JAX package, and the entry
points refuse to run on the CPU unless asked to by name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hydragnn_tpu_torch import run_prediction, run_training
from hydragnn_tpu_torch.benchmarks.model_bench import bench_model
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.serve import InferenceServer, ModelRegistry, plan_from_samples
from hydragnn_tpu_torch.utils import resolve_device

from test_torch_pna import arch
from test_torch_serve import PLAN_SIZES, _graphs

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "hydragnn_tpu")


def _port_files():
    files = sorted((REPO / "hydragnn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    assert REPO / "hydragnn_tpu_torch" / "train" / "trainer.py" in files
    for new in ("ops/dense_agg.py", "ops/autotune.py", "benchmarks/model_bench.py",
                "run_training.py", "run_prediction.py", "train/driver.py",
                "train/epoch_driver.py", "train/checkpoint.py", "train/msgpack_codec.py",
                "train/scheduler.py", "train/predict.py", "data/loaders.py", "data/raw.py",
                "data/lsms.py", "data/radius_graph.py", "data/transforms.py",
                "data/serialized.py", "data/split.py", "utils/config.py"):
        assert REPO / "hydragnn_tpu_torch" / new in files
    return files


def _forbidden(module: str) -> bool:
    """True for ``jax``, ``jax.numpy``, ``hydragnn_tpu``, ``hydragnn_tpu.ops``
    ... but not for ``hydragnn_tpu_torch`` (the prefix is not the package)."""
    return module.split(".")[0] in FORBIDDEN


def pytest_forbidden_matcher_tells_the_packages_apart():
    assert _forbidden("jax.numpy") and _forbidden("hydragnn_tpu.ops.fused_mp")
    assert not _forbidden("hydragnn_tpu_torch.ops") and not _forbidden("jaxtyping_free")


def pytest_port_sources_import_nothing_of_jax():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def pytest_importing_the_port_loads_no_jax():
    code = (
        "import sys, hydragnn_tpu_torch, hydragnn_tpu_torch.serve, hydragnn_tpu_torch.ops\n"
        "import hydragnn_tpu_torch.train, hydragnn_tpu_torch.benchmarks.model_bench\n"
        "import hydragnn_tpu_torch.ops.dense_agg, hydragnn_tpu_torch.ops.autotune\n"
        "import hydragnn_tpu_torch.train.driver, hydragnn_tpu_torch.data.loaders\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'hydragnn_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def pytest_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model_config(arch())
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(ModelRegistry(), plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_model(hidden=16, num_graphs=2, nodes=8, degree=4, layers=1, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training({"NeuralNetwork": {"Architecture": {}}, "Dataset": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_prediction({"NeuralNetwork": {"Architecture": {}}, "Dataset": {}})
    with pytest.raises(TypeError, match="use_devices"):
        run_training({}, use_devices=True)
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


class _Outside:
    """A class no serialized dataset may name."""


def pytest_serialized_unpickler_refuses_other_classes(tmp_path):
    """The unpickler of serialized splits builds numpy arrays, builtin
    containers and ``GraphData`` (the JAX package's name read as the
    port's class) and refuses every other class before constructing it."""
    import pickle

    import numpy as np

    from hydragnn_tpu_torch.data.serialized import read_serialized

    path = tmp_path / "split.pkl"
    with open(path, "wb") as f:
        pickle.dump(np.zeros((2, 1)), f)
        pickle.dump(np.zeros((2, 1)), f)
        pickle.dump([GraphData(x=np.ones((2, 1), np.float32))], f)
    *_, samples = read_serialized(str(path))
    assert type(samples[0]) is GraphData
    # a pickle of the JAX package's GraphData loads as the port's
    from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData

    with open(path, "wb") as f:
        pickle.dump(np.zeros((2, 1)), f)
        pickle.dump(np.zeros((2, 1)), f)
        pickle.dump([JaxGraphData(x=np.ones((2, 1), np.float32))], f)
    assert b"hydragnn_tpu.data.dataobj" in path.read_bytes()
    (sample,) = read_serialized(str(path))[2]
    assert type(sample) is GraphData and sample.num_nodes == 2
    for bad in (_Outside(), os.system):
        with open(path, "wb") as f:
            pickle.dump(np.zeros(1), f)
            pickle.dump(np.zeros(1), f)
            pickle.dump([bad], f)
        with pytest.raises(pickle.UnpicklingError, match="refusing to load"):
            read_serialized(str(path))
