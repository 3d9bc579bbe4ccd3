"""The streaming data plane on the card; marker ``cuda``, skipped inside the
test without one. Run on the card with
``python -m pytest tests/test_torch_stream_cuda.py -q -p no:randomly --noconftest``.

- A tiny ``Dataset.streaming`` ``run_training`` on the card in ``fused``
  mode (PNA, hidden 8, 2 layers, 2 epochs, two shard-store families):
  finite losses, K3 and K1 launched exactly (train steps and evaluation
  forwards, the warm-ups included), the cursor in the checkpoint's
  ``train_meta`` and the tracer's ``native`` backend registered.
- ``PackReader.read_all``'s view into the mmap is read-only; copied, it
  pins and reaches the card equal to the per-sample reads.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.shard_store import ShardWriter
from hydragnn_tpu_torch.native.graphpack import PackReader
from hydragnn_tpu_torch.ops import launch_counts, reset_launch_counts
from hydragnn_tpu_torch.train import capture_counts, reset_capture_counts

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_stream_data import stream_config, write_stores  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def pytest_streaming_run_training_on_the_card(card, tmp_path, monkeypatch):
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.train import trainer as trainer_mod
    from hydragnn_tpu_torch.train.checkpoint import load_state_dict, pop_train_meta
    from hydragnn_tpu_torch.utils import tracer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_AGG", "fused")
    stores = write_stores(tmp_path / "dataset", ShardWriter, GraphData)
    counted = {"train": 0, "eval": 0}
    orig = trainer_mod.Trainer._batches

    def batches(self, loader, nbatch=None):
        kind = "train" if getattr(loader, "reports_stream_stats", False) else "eval"
        for b in orig(self, loader, nbatch):
            counted[kind] += 1
            yield b

    monkeypatch.setattr(trainer_mod.Trainer, "_batches", batches)
    reset_launch_counts()
    reset_capture_counts()
    state = hydragnn_tpu_torch.run_training(copy.deepcopy(stream_config(stores)))
    counts, programs = launch_counts(), capture_counts()
    history = state.info["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in history)
    # PNA fused, 2 layers: a step launches K3 twice and K1 3 times (the
    # pool and K3's rule), a forward K3 twice and K1 once
    steps = counted["train"] + programs["warm_steps"]
    forwards = counted["eval"] + programs["warm_forwards"]
    assert counts["fused_gather_moments"] == 2 * (steps + forwards)
    assert counts["segment_sum"] == 3 * steps + forwards
    assert counts["segment_moments"] == 0
    meta = pop_train_meta(load_state_dict(state.info["log_name"]))
    assert int(np.asarray(meta["stream"]["mix"]["seed"])) == 5
    assert tracer.has("native")


def pytest_read_all_view_copies_before_pinning(card, tmp_path):
    from _torch_stream_data import family_samples

    samples = family_samples(GraphData, 3, 12, 4, 9)
    w = ShardWriter(str(tmp_path / "store"), rank=0)
    w.add(samples)
    w.save()
    r = PackReader(str(tmp_path / "store" / "shard.00000.gpk"))
    view = r.read_all("x")
    assert not view.flags.writeable
    with pytest.raises(ValueError):
        view[0, 0] = 1.0
    pinned = torch.from_numpy(np.array(view)).pin_memory()
    on_card = pinned.to(card, non_blocking=True)
    torch.cuda.synchronize()
    want = np.concatenate([r.read("x", i) for i in range(r.num_samples)])
    assert torch.equal(on_card.cpu(), torch.from_numpy(want))
    r.close()
