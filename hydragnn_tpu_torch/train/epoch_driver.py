"""The epoch driver (port of ``train/epoch_driver.py``'s host path):
train, validate and test once an epoch, the plateau learning rate, early
stopping, the best checkpoint ``<name>-best``, and the resumable
checkpoint with its ``train_meta`` every ``resume_every`` epochs (keeping
``checkpoint_keep_last`` rolling copies).

``train_meta`` is the JAX package's format-2 section: ``format``,
``epoch``, ``rng``, and the ``state_dict``s of the plateau, early-stopping
and best-checkpoint trackers. ``rng`` is a JAX PRNG key, ``uint32[2]``.
The port draws nothing from it (its stochastic layers draw from
``Trainer.generator``) and cannot split it without JAX, so it carries the
key unchanged: the one it read when resuming, else
``jax.random.PRNGKey(seed)`` of the run's seed (``HYDRAGNN_SEED`` >
``Training.random_seed`` > 1337), which is ``[seed >> 32, seed & 0xffffffff]``
for the threefry key. The JAX package accepts either on resume.

With ``device_resident_dataset`` (or ``HYDRAGNN_DEVICE_RESIDENT``) the
training set is staged on the device once and every epoch runs
``Trainer.train_epoch_staged``; the validation and test sets are staged at
the first evaluation and run by ``evaluate_staged`` (the JAX package's
``epoch_driver.py:336-348`` and ``:590-661``). Batches of more than one
shape cannot stack: the driver prints the JAX package's message and
streams, its documented rule for bucketed layouts. Evaluation sets that
cannot stage (ragged, empty, or out of memory) stream from then on.

``fit_chunk_epochs`` (``fit_staged``), streaming data, the divergence
guard's restore, candidate publication, elastic runs and plots raise
where a config or the environment asks for them (``ROADMAP.md``, queue 1).
"""

import os
import time

import numpy as np

from hydragnn_tpu_torch.train.checkpoint import drain_async, resolve_async_writer, save_model
from hydragnn_tpu_torch.train.common import _env_flag, _is_oom
from hydragnn_tpu_torch.train.optimizer import get_learning_rate, set_learning_rate
from hydragnn_tpu_torch.train.scheduler import BestCheckpoint, EarlyStopping, ReduceLROnPlateau


def print_distributed(verbosity: int, *args):
    """Print at verbosity 2 and above (one process)."""
    if verbosity >= 2:
        print(*args, flush=True)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of the default threefry
    implementation: ``uint32[2]``, the seed's high and low 32 bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, queue 1, item {item}")


def _check_supported(training: dict, create_plots: bool):
    if int(os.getenv("HYDRAGNN_FIT_CHUNK", str(training.get("fit_chunk_epochs", 0)))) > 0:
        raise _not_ported("fit_chunk_epochs (fit_staged, with the plateau, early stop and "
                          "best state on the device)", 5)
    if os.getenv("HYDRAGNN_PUBLISH_DIR", training.get("publish_dir") or ""):
        raise _not_ported("publish_dir (the canary's candidate channel)", 5)
    if os.getenv("HYDRAGNN_ELASTIC_DIR") or os.getenv("HYDRAGNN_HEARTBEAT_FILE"):
        raise _not_ported("elastic runs", 8)
    if create_plots:
        raise _not_ported("Visualization.create_plots", 7)


def build_train_meta(epoch, rng, scheduler, early, ckpt):
    """The format-2 training-loop state after epoch ``epoch``."""
    meta = {"format": 2, "epoch": int(epoch), "rng": np.asarray(rng, np.uint32),
            "plateau": scheduler.state_dict()}
    if early is not None:
        meta["early"] = early.state_dict()
    if ckpt is not None:
        meta["best_ckpt"] = ckpt.state_dict()
    return meta


def train_validate_test(trainer, state, train_loader, val_loader, test_loader,
                        config_nn: dict, log_name: str, verbosity: int = 0,
                        create_plots: bool = False, resume_meta=None):
    """Run the epochs of ``config_nn["Training"]`` from epoch 0, or from the
    epoch after ``resume_meta["epoch"]`` with its trackers when resuming.
    Returns the state; ``trainer.history`` holds each epoch's losses,
    walls and host collation seconds, ``trainer.final_train_meta`` the last ``train_meta`` and
    ``trainer.final_state_saved`` whether the state is already in the
    primary checkpoint."""
    training = config_nn["Training"]
    _check_supported(training, create_plots)
    num_epoch = training["num_epoch"]
    early = EarlyStopping(training.get("patience", 5)) if training.get("EarlyStopping", False) else None
    ckpt = (BestCheckpoint(log_name + "-best", warmup=training.get("checkpoint_warmup", 10))
            if training.get("Checkpoint", False) else None)
    scheduler = ReduceLROnPlateau(lr=get_learning_rate(state.optimizer))
    seed = int(os.getenv("HYDRAGNN_SEED", str(training.get("random_seed", 1337))))
    rng = prng_key(seed)
    resume_every = int(os.getenv("HYDRAGNN_RESUME_EVERY", str(training.get("resume_every", 1))))
    keep_last = int(os.getenv("HYDRAGNN_CKPT_KEEP", str(training.get("checkpoint_keep_last", 3))))
    writer = resolve_async_writer(training)

    trainer.final_train_meta = resume_meta
    trainer.final_state_saved = False
    trainer.history = []
    start_epoch = 0
    if resume_meta:
        start_epoch = int(resume_meta["epoch"]) + 1
        if resume_meta.get("rng") is not None:
            rng = np.asarray(resume_meta["rng"], np.uint32)
        if resume_meta.get("plateau") is not None:
            scheduler.load_state_dict(resume_meta["plateau"])
        if early is not None and resume_meta.get("early") is not None:
            early.load_state_dict(resume_meta["early"])
        if ckpt is not None and resume_meta.get("best_ckpt") is not None:
            ckpt.load_state_dict(resume_meta["best_ckpt"])
        if early is not None and early.early_stop:
            print_distributed(verbosity, "Resume: early stopping had already triggered")
            start_epoch = num_epoch
        print_distributed(verbosity, f"Resuming training at epoch {start_epoch} "
                                     f"(lr {scheduler.lr:.3e})")
        trainer.final_state_saved = start_epoch >= num_epoch

    def save_resumable(epoch):
        meta = build_train_meta(epoch, rng, scheduler, early, ckpt)
        trainer.last_save = save_model(state, log_name, train_meta=meta, keep_last=keep_last,
                                       writer=writer)
        trainer.final_train_meta = meta
        trainer.final_state_saved = True

    staged = None
    if _env_flag("HYDRAGNN_DEVICE_RESIDENT", training, "device_resident_dataset"):
        try:
            staged = trainer.stage_batches(list(train_loader))
        except ValueError:
            print_distributed(
                verbosity,
                "device_resident_dataset: batches are not shape-uniform "
                "(bucketed layout?) — falling back to streaming")
    staged_evals = None

    def evaluate_both():
        nonlocal staged_evals
        if staged is not None and staged_evals is None:
            try:
                vb, tb = list(val_loader), list(test_loader)
                if not vb or not tb:
                    raise ValueError("empty eval loader")
                staged_evals = (trainer.stage_batches(vb), trainer.stage_batches(tb))
            except Exception as e:
                if not (isinstance(e, ValueError) or _is_oom(e)):
                    raise
                staged_evals = False
        if staged_evals:
            try:
                return (trainer.evaluate_staged(state, staged_evals[0])[0],
                        trainer.evaluate_staged(state, staged_evals[1])[0])
            except Exception as e:
                if not _is_oom(e):
                    raise
                staged_evals = False
        return trainer.evaluate(state, val_loader)[0], trainer.evaluate(state, test_loader)[0]

    for epoch in range(start_epoch, num_epoch):
        t0 = time.time()
        trainer.final_state_saved = False
        train_loader.set_epoch(epoch)
        collate0 = trainer.collate_s
        if staged is not None:
            state, train_loss, train_tasks = trainer.train_epoch_staged(state, staged)
        else:
            state, train_loss, train_tasks = trainer.train_epoch(state, train_loader)
        t_train = time.time() - t0
        collate_s = trainer.collate_s - collate0
        val_loss, test_loss = evaluate_both()
        new_lr = scheduler.step(val_loss)
        if abs(new_lr - get_learning_rate(state.optimizer)) > 1e-12:
            set_learning_rate(state.optimizer, new_lr)
        print_distributed(
            verbosity,
            f"Epoch: {epoch:04d}, Train Loss: {train_loss:.8f}, Val Loss: {val_loss:.8f}, "
            f"Test Loss: {test_loss:.8f}, Train Time: {t_train:.2f}s, "
            f"{len(train_loader.dataset) / max(t_train, 1e-9):.0f} graphs/sec")
        if ckpt is not None:
            ckpt(state, epoch, val_loss, save_model)
        stopping = early is not None and early(val_loss)
        if resume_every > 0 and ((epoch + 1) % resume_every == 0 or stopping
                                 or epoch == num_epoch - 1):
            save_resumable(epoch)
        trainer.history.append({
            "epoch": epoch, "train_loss": float(train_loss), "val_loss": float(val_loss),
            "test_loss": float(test_loss), "train_tasks": np.atleast_1d(train_tasks).tolist(),
            "train_s": t_train, "train_collate_s": collate_s, "epoch_s": time.time() - t0,
            "lr": float(get_learning_rate(state.optimizer)),
        })
        if stopping:
            print_distributed(verbosity, f"Early stopping at epoch {epoch}")
            break
    drain_async()
    return state
