"""Worker for the port's kill-and-resume tests (not a pytest module):
``tests/_resilience_worker.py``'s run through ``hydragnn_tpu_torch`` on the
CPU, streaming or in chunks.

    python _torch_resilience_worker.py <workdir> run|resume stream|chunk

It trains GIN (hidden 8, 2 layers) on 24 closed-form graphs through the
port's epoch driver with a resumable checkpoint every epoch (every chunk
of 2 epochs with ``chunk``: device-resident, ``fit_chunk_epochs`` 2), under
whatever ``HYDRAGNN_FAULT_*`` the parent set, and at a clean exit writes
``result.json`` with the run's trajectory. A run that
``HYDRAGNN_FAULT_KILL_AT_STEP`` kills leaves only its checkpoints.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NUM_EPOCH = 5
LOG_NAME = "resil"
ARCH = {
    "model_type": "GIN", "input_dim": 1, "hidden_dim": 8, "num_conv_layers": 2,
    "output_dim": [1, 1], "output_type": ["graph", "node"],
    "output_heads": {
        "graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8, "num_headlayers": 1,
                  "dim_headlayers": [8]},
        "node": {"num_headlayers": 1, "dim_headlayers": [8], "type": "mlp"},
    },
    "task_weights": [1.0, 1.0],
}


def make_samples(cls, num=24, seed=11):
    """``_resilience_worker.make_samples`` with the given ``GraphData``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        n = 6
        g = cls()
        g.x = rng.random((n, 1)).astype(np.float32)
        g.pos = rng.random((n, 3)).astype(np.float32)
        src = np.arange(n)
        dst = (src + 1) % n
        g.edge_index = np.stack([np.concatenate([src, dst]),
                                 np.concatenate([dst, src])]).astype(np.int64)
        g.edge_attr = None
        g.targets = [np.array([g.x.sum()], np.float32), g.x.copy()]
        g.target_types = ["graph", "node"]
        out.append(g)
    return out


def build(chunk: bool):
    from hydragnn_tpu_torch.data import GraphData
    from hydragnn_tpu_torch.data.loaders import GraphLoader, compute_layout
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train import Trainer

    training = {"num_epoch": NUM_EPOCH, "perc_train": 0.7,
                "Optimizer": {"type": "AdamW", "learning_rate": 1e-2},
                "resume_every": 1, "checkpoint_keep_last": 4}
    if chunk:
        training.update(device_resident_dataset=True, fit_chunk_epochs=2)
    samples = make_samples(GraphData)
    layout = compute_layout([samples], batch_size=4)
    loaders = (GraphLoader(samples[:16], 4, layout, shuffle=True, seed=7),
               GraphLoader(samples[16:20], 4, layout, shuffle=False),
               GraphLoader(samples[20:], 4, layout, shuffle=False))
    torch.manual_seed(0)
    trainer = Trainer(create_model_config(ARCH, device="cpu", aggregation="segment"), training)
    return trainer, trainer.init_state(next(iter(loaders[0]))), loaders, training


def main():
    workdir, mode, kind = sys.argv[1], sys.argv[2], sys.argv[3]
    os.chdir(workdir)
    from hydragnn_tpu_torch.models.bridge import restore_state
    from hydragnn_tpu_torch.train import checkpoint as ckpt
    from hydragnn_tpu_torch.train.epoch_driver import train_validate_test
    from hydragnn_tpu_torch.train.optimizer import get_learning_rate

    trainer, state, loaders, training = build(kind == "chunk")
    resume_meta = None
    if mode == "resume":
        restored = ckpt.load_state_dict(LOG_NAME)
        resume_meta = ckpt.pop_train_meta(restored)
        state = trainer.place_state(restore_state(state, restored))
    state = train_validate_test(trainer, state, *loaders, {"Training": training}, LOG_NAME,
                                resume_meta=resume_meta)
    result = {
        "resumed_from_epoch": None if resume_meta is None else int(resume_meta["epoch"]) + 1,
        "epochs_run": [h["epoch"] for h in trainer.history],
        "final_lr": get_learning_rate(state.optimizer),
        "final_params": {k: v.detach().numpy().tolist() for k, v in state.model.state_dict().items()},
    }
    with open("result.json", "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
