"""``run_training`` and ``run_prediction`` (port of ``train/driver.py``'s
single-process, non-streaming path).

``run_training_impl``: the data path (``data/loaders.py``), the derived
config (``utils/config.py``), the model on the card (``aggregation``:
:func:`~hydragnn_tpu_torch.utils.config.model_aggregation`; the batches
carry the dense lists where the config's branch says so) and its
``Trainer``, a warm start from ``Training.startfrom`` or a resume of the
run itself (``Training.continue``), the epochs (``train/epoch_driver.py``)
and the final checkpoint ``./logs/<name>/<name>.pk`` beside the saved
``config.json``.

``run_prediction_impl`` rebuilds the model from the same config, loads
the run's checkpoint strictly (no rolling fallback: a prediction never
reports older weights), and returns ``(error, per-head errors, true
values, predicted values)`` of the test split, denormalised when the
config asks.

Both run on the card unless ``device="cpu"`` is passed.
"""

import time

import numpy as np

from hydragnn_tpu_torch.data.loaders import dataset_loading_and_splitting
from hydragnn_tpu_torch.models.bridge import restore_state
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    drain_async,
    load_state_dict,
    pop_train_meta,
    rolling_checkpoints,
    save_model,
)
from hydragnn_tpu_torch.train.epoch_driver import train_validate_test
from hydragnn_tpu_torch.train.trainer import Trainer
from hydragnn_tpu_torch.utils.config import (
    get_log_name_config,
    model_aggregation,
    save_config,
    update_config,
)
from hydragnn_tpu_torch.utils.device import resolve_device


def _arch_for_factory(config) -> dict:
    arch = dict(config["NeuralNetwork"]["Architecture"])
    training = config["NeuralNetwork"]["Training"]
    arch["loss_function_type"] = training.get("loss_function_type", "mse")
    arch["conv_checkpointing"] = training.get("conv_checkpointing", False)
    return arch


def _check_supported(config):
    if config.get("Dataset", {}).get("streaming"):
        raise NotImplementedError(
            "streaming datasets are not ported yet: see ROADMAP.md, queue 1, item 9")


def build_model_and_trainer(config, train_loader, device):
    """The model of ``config``'s derived Architecture on ``device``, its
    ``Trainer`` and a fresh state (from the loader's first batch)."""
    arch = _arch_for_factory(config)
    model = create_model_config(arch, device=device, aggregation=model_aggregation())
    trainer = Trainer(model, config["NeuralNetwork"]["Training"],
                      freeze_conv=arch.get("freeze_conv_layers", False))
    state = trainer.init_state(next(iter(train_loader)))
    return model, trainer, state


def _prepare(config, device):
    _check_supported(config)
    dev = resolve_device(device)
    verbosity = config.get("Verbosity", {}).get("level", 0)
    loaders = dataset_loading_and_splitting(config)
    config = update_config(config, *loaders)
    return dev, verbosity, loaders, config


def run_training_impl(config, device=None):
    """Train the run of ``config``; returns the final ``TrainState``, with
    the run's name, per-epoch history and last checkpoint write in its
    ``info``."""
    t0 = time.perf_counter()
    dev, verbosity, (train_loader, val_loader, test_loader), config = _prepare(config, device)
    log_name = get_log_name_config(config)
    save_config(config, log_name)
    _, trainer, state = build_model_and_trainer(config, train_loader, dev)
    training = config["NeuralNetwork"]["Training"]
    resume_meta = None
    if training.get("continue"):
        model_name = training.get("startfrom", log_name)
        if checkpoint_exists(model_name) or rolling_checkpoints(model_name):
            restored = load_state_dict(model_name)
            # a startfrom of another run is a warm start at epoch 0: its
            # loop state is dropped; a resume of this run keeps it
            meta = pop_train_meta(restored)
            if model_name == log_name:
                resume_meta = meta
            state = trainer.place_state(restore_state(state, restored))
    try:
        state = train_validate_test(
            trainer, state, train_loader, val_loader, test_loader, config["NeuralNetwork"],
            log_name, verbosity,
            create_plots=config.get("Visualization", {}).get("create_plots", False),
            resume_meta=resume_meta)
        if not trainer.final_state_saved:
            trainer.last_save = save_model(state, log_name, train_meta=trainer.final_train_meta)
    except BaseException:
        try:
            drain_async(timeout=60.0)
        except Exception:
            pass  # the original failure is the one to raise
        raise
    state.info.update(log_name=log_name, history=trainer.history,
                      last_save=getattr(trainer, "last_save", None),
                      wall_s=time.perf_counter() - t0)
    return state


def run_prediction_impl(config, device=None):
    dev, _, (train_loader, _, test_loader), config = _prepare(config, device)
    log_name = get_log_name_config(config)
    _, trainer, state = build_model_and_trainer(config, train_loader, dev)
    if not checkpoint_exists(log_name):
        raise FileNotFoundError(f"No trained model found: {log_name}")
    restored = load_state_dict(log_name, fallback=False)
    pop_train_meta(restored)
    state = trainer.place_state(restore_state(state, restored))
    error, tasks_error, true_values, predicted_values = trainer.predict(state, test_loader)
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    if voi.get("denormalize_output") and "y_minmax" in voi:
        for ihead, (ymin, ymax) in enumerate(voi["y_minmax"]):
            for values in (predicted_values, true_values):
                values[ihead] = np.asarray(values[ihead]) * (ymax - ymin) + ymin
    return error, list(np.atleast_1d(tasks_error)), true_values, predicted_values
