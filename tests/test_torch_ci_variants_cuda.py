"""``tests/test_graphs.py``'s accuracy runs through the port's
``run_training`` and ``run_prediction`` on the card (``ROADMAP.md``, queue
1, item 7a); marker ``cuda``, skipped inside the test without one. Run on
the card with
``python -m pytest tests/test_torch_ci_variants_cuda.py -q -s -p no:randomly --noconftest``.

The cases are ``test_graphs.py``'s (``:139-170``) that the smoke does not
already run: ``ci_multihead.json`` for the eight stacks other than PNA,
the ``lengths`` runs (PNA, CGCNN, SchNet, EGNN), the equivariant runs
(EGNN, SchNet), PNA's ``vectoroutput`` run and the ``conv_head`` runs of
all eight stacks that take one. Each trains on 500 configurations written
by ``chip_smoke.write_unit_test_data`` (``tests/synthetic.py``'s generator
without scikit-learn, which the card's host lacks) exactly as
``test_graphs.py:unittest_train_model`` configures it, and is held to that
file's ``THRESHOLDS`` (``:24-34``) with its per-variant changes: every
head's RMSE and the total below the first ceiling, every head's sample
MAE below the second. Each case prints one JSON line with its errors
beside its ceilings (``-s``).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
THRESHOLDS = {
    "SAGE": [0.20, 0.20], "PNA": [0.20, 0.20], "MFC": [0.20, 0.20], "GIN": [0.25, 0.20],
    "GAT": [0.60, 0.70], "CGCNN": [0.50, 0.40], "SchNet": [0.20, 0.20],
    "DimeNet": [0.50, 0.50], "EGNN": [0.20, 0.20],
}
NUM_SAMPLES = 500
MULTIHEAD = ["GIN", "SAGE", "MFC", "GAT", "CGCNN", "SchNet", "DimeNet", "EGNN"]
CONV_HEAD = ["SAGE", "GIN", "GAT", "MFC", "PNA", "SchNet", "DimeNet", "EGNN"]
CASES = ([(m, "ci_multihead.json", False) for m in MULTIHEAD]
         + [(m, "ci.json", True) for m in ("PNA", "CGCNN", "SchNet", "EGNN")]
         + [(m, "ci_equivariant.json", False) for m in ("EGNN", "SchNet")]
         + [("PNA", "ci_vectoroutput.json", True)]
         + [(m, "ci_conv_head.json", False) for m in CONV_HEAD])


def thresholds(model_type, ci_input, use_lengths):
    """``test_graphs.py``'s ceilings for one case (``:91-98``)."""
    t = dict(THRESHOLDS)
    if use_lengths and "vector" not in ci_input:
        t["CGCNN"] = [0.175, 0.175]
        t["PNA"] = [0.10, 0.10]
    if use_lengths and "vector" in ci_input:
        t["PNA"] = [0.2, 0.15]
    if ci_input == "ci_conv_head.json":
        t["GIN"] = [0.25, 0.40]
    return t[model_type]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("ci_variants")


def _config(model_type, ci_input, use_lengths, workdir):
    """``test_graphs.py:unittest_train_model``'s config, its data written
    once per directory."""
    import chip_smoke

    with open(REPO / "tests" / "inputs" / ci_input) as f:
        config = json.load(f)
    config["NeuralNetwork"]["Architecture"]["model_type"] = model_type
    if use_lengths:
        config["NeuralNetwork"]["Architecture"]["edge_features"] = ["lengths"]
    if model_type == "MFC" and ci_input == "ci_multihead.json":
        config["NeuralNetwork"]["Architecture"]["task_weights"][0] = 2
    perc = config["NeuralNetwork"]["Training"]["perc_train"]
    for name, rel in config["Dataset"]["path"].items():
        num = (NUM_SAMPLES if name == "total" else int(NUM_SAMPLES * perc) if name == "train"
               else int(NUM_SAMPLES * (1 - perc) * 0.5))
        path = workdir / f"{rel}_{num}"
        if not path.exists():
            chip_smoke.write_unit_test_data(str(path), num)
        config["Dataset"]["path"][name] = str(path)
    return config


@pytest.mark.parametrize("model_type,ci_input,use_lengths", CASES)
def pytest_ci_variant_meets_its_ceilings(model_type, ci_input, use_lengths, workdir,
                                         monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's entry points run there")
    import hydragnn_tpu_torch

    config = _config(model_type, ci_input, use_lengths, workdir)
    run = workdir / f"{model_type}_{ci_input.split('.')[0]}_{int(use_lengths)}"
    run.mkdir()
    monkeypatch.chdir(run)
    monkeypatch.setenv("SERIALIZED_DATA_PATH", str(run))
    state = hydragnn_tpu_torch.run_training(copy.deepcopy(config))
    error, rmse, true_values, predicted = hydragnn_tpu_torch.run_prediction(
        copy.deepcopy(config))
    ceiling = thresholds(model_type, ci_input, use_lengths)
    mae = [float(np.abs(np.asarray(t) - np.asarray(p)).mean())
           for t, p in zip(true_values, predicted)]
    line = {"ci_variant": {"model": model_type, "config": ci_input, "lengths": use_lengths,
                           "epochs": len(state.info["history"]), "error": float(error),
                           "head_rmse": [float(r) for r in rmse], "sample_mae": mae,
                           "ceilings": ceiling, "card": torch.cuda.get_device_name(0)}}
    print(json.dumps(line), flush=True)
    assert all(r < ceiling[0] for r in rmse), line
    assert all(m < ceiling[1] for m in mae), line
    assert error < ceiling[0], line
