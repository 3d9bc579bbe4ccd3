"""The port stands alone: ``hydragnn_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax, optax or the JAX package, the processes the
fleet and the canary spawn run the port's module, and the entry points
refuse to run on the CPU unless asked to by name."""

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
                "data/serialized.py", "data/split.py", "utils/config.py",
                "analysis/guards.py", "utils/faults.py", "utils/retry.py",
                "parallel/distributed.py", "train/guard.py", "utils/envparse.py",
                "obs/__init__.py", "obs/metrics.py", "obs/events.py", "obs/http.py",
                "obs/trace.py", "obs/drift.py", "serve/http.py", "serve/cache.py",
                "serve/tenants.py", "serve/costs.py", "serve/quality.py", "coord.py",
                "serve/fleet.py", "serve/router.py", "serve/canary.py", "serve/autoscale.py",
                "data/elements.py", "data/cfg.py", "data/xyz.py", "data/extxyz.py",
                "data/mptrj.py", "data/qm9_raw.py", "train/transfer.py",
                "obs/runtime.py", "obs/scalars.py", "obs/introspect.py", "obs/ledger.py",
                "obs/report.py", "obs/__main__.py", "utils/timers.py", "utils/tracer.py",
                "utils/profile.py", "native/build.py", "native/graphpack.py",
                "native/regiontimer.py", "data/shard_store.py", "data/distdataset.py",
                "data/pickledataset.py", "data/stream/source.py", "data/stream/mix.py",
                "data/stream/planner.py", "data/stream/loader.py", "data/stream/config.py"):
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
        "import hydragnn_tpu_torch.obs, hydragnn_tpu_torch.serve.quality\n"
        "import hydragnn_tpu_torch.coord, hydragnn_tpu_torch.serve.fleet\n"
        "import hydragnn_tpu_torch.serve.router, hydragnn_tpu_torch.serve.canary\n"
        "import hydragnn_tpu_torch.serve.autoscale, hydragnn_tpu_torch.obs.drift\n"
        "import hydragnn_tpu_torch.data, hydragnn_tpu_torch.data.cfg, hydragnn_tpu_torch.data.xyz\n"
        "import hydragnn_tpu_torch.train.transfer, hydragnn_tpu_torch.obs.runtime\n"
        "import hydragnn_tpu_torch.obs.ledger, hydragnn_tpu_torch.obs.report\n"
        "import hydragnn_tpu_torch.obs.introspect, hydragnn_tpu_torch.obs.scalars\n"
        "import hydragnn_tpu_torch.obs.__main__, hydragnn_tpu_torch.utils.tracer\n"
        "import hydragnn_tpu_torch.utils.timers, hydragnn_tpu_torch.data.stream\n"
        "import hydragnn_tpu_torch.data.shard_store, hydragnn_tpu_torch.data.distdataset\n"
        "import hydragnn_tpu_torch.data.pickledataset, hydragnn_tpu_torch.native.graphpack\n"
        "import hydragnn_tpu_torch.native.regiontimer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'hydragnn_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def pytest_port_names_no_source_of_the_jax_package():
    """No string in the port names the JAX package's directory as a path
    (``hydragnn_tpu/native``, or ``"hydragnn_tpu"`` as a path component):
    the port keeps its own copies of the C++ it builds."""
    bad = []
    for path in _port_files():
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                s = node.value
                if s == "hydragnn_tpu" or "hydragnn_tpu/native" in s or \
                        "hydragnn_tpu\\native" in s:
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno}: {s[:60]!r}")
    assert not bad, bad


def pytest_builders_compile_only_the_ports_sources(monkeypatch, tmp_path):
    """The g++ build (``native/build.py``) and the nvcc build
    (``ops/_build.py``) hand their compilers sources inside
    ``hydragnn_tpu_torch/`` only."""
    from hydragnn_tpu_torch.native import build
    from hydragnn_tpu_torch.ops import _build

    port = (REPO / "hydragnn_tpu_torch").resolve()
    commands = []

    def run(cmd, **kw):
        commands.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        Path(out).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "REPO_ROOT", tmp_path)
    monkeypatch.setattr(build.subprocess, "run", run)
    for name, sources in (("graphpack", ["graphpack.cpp"]), ("diststore", ["diststore.cpp"]),
                          ("regiontimer", ["regiontimer.cpp"])):
        assert build.build_library(name, sources).startswith(str(tmp_path))

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "", ""

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    _build.build_all()
    compiled = [Path(a).resolve() for cmd in commands for a in cmd
                if a.endswith((".cpp", ".cu", ".cc", ".c"))]
    assert len(compiled) == 6, commands
    outside = [str(c) for c in compiled if port not in c.parents]
    assert not outside, outside


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


@pytest.mark.parametrize("who", ["fleet", "fleet_worker_cmd", "canary", "canary_controller"])
def pytest_spawned_replicas_run_the_port(monkeypatch, tmp_path, who):
    """``ServingFleet`` (its spawns, its resize and the command it keeps),
    the canary's ``_SubprocessCanary`` and the ``CanaryController`` that
    makes one spawn ``python -m hydragnn_tpu_torch.serve.fleet``, never the
    JAX module; a canary is told its role, its id and its incarnation."""
    from types import SimpleNamespace

    from hydragnn_tpu_torch.serve import canary, fleet

    seen = []

    class _Proc:
        pid = 1

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", lambda cmd, env: seen.append((cmd, env)) or _Proc())
    if who in ("fleet", "fleet_worker_cmd"):
        sup = fleet.ServingFleet(str(tmp_path), 2, spec_path="spec.json")
        if who == "fleet":
            sup._spawn(sup._replicas[0])
            sup.resize(3)
        else:
            seen.append((sup.worker_cmd, None))
        sup.events.close()
    else:
        if who == "canary":
            canary._SubprocessCanary("spec.json", str(tmp_path), 3, 1, 0.25)
        else:
            spec = tmp_path / "spec.json"
            spec.write_text("{}")
            stub = SimpleNamespace(coord_dir=str(tmp_path), lease_s=2.0, spec_path=str(spec))
            ctl = canary.CanaryController(stub, str(tmp_path / "chan"))
            ctl._spawn_subprocess(str(spec), 3, 1)
        ((_, env),) = seen
        assert env["HYDRAGNN_FLEET_CANARY"] == "1" and env["HYDRAGNN_FLEET_REPLICA"] == "3"
        assert env["HYDRAGNN_FLEET_GEN"] == "1" and env["HYDRAGNN_FLEET_DIR"] == str(tmp_path)
    assert seen and all(cmd[:3] == [sys.executable, "-m", "hydragnn_tpu_torch.serve.fleet"]
                        for cmd, _ in seen)
    assert not any(part.startswith("hydragnn_tpu.") for cmd, _ in seen for part in cmd)
