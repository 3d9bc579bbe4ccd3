"""``run_training`` and ``run_prediction`` (port of ``train/driver.py``'s
single-process path).

``run_training_impl``: the data path (``data/loaders.py``, or for a
``Dataset.streaming`` section the streaming data plane,
``data/stream/``: the train split streams through the weighted mix and
the auto bucket plan, the evaluation splits are loaded, and the config is
derived over the stream's probe window), the derived
config (``utils/config.py``), the model on the card (``aggregation``:
:func:`~hydragnn_tpu_torch.utils.config.model_aggregation`; the batches
carry the dense lists where the config's branch says so) and its
``Trainer``, a warm start from ``Training.startfrom`` or a resume of the
run itself (``Training.continue``), the epochs (``train/epoch_driver.py``)
and the final checkpoint ``./logs/<name>/<name>.pk`` beside the saved
``config.json``.

The run records its telemetry (``obs/runtime.py``): ``events.jsonl``
(manifest, epochs, checkpoints, guard, compiles, goodput, ``tracer_totals``
and ``run_end``, ``failed`` when anything raised), the per-epoch scalars
(``obs/scalars.py``), the tracer's regions under ``./logs/<name>/trace``,
and the live endpoint when a port is asked for.

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
from hydragnn_tpu_torch.obs import runtime as obs
from hydragnn_tpu_torch.obs.scalars import ScalarWriter
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
from hydragnn_tpu_torch.utils import tracer as tr
from hydragnn_tpu_torch.utils.device import resolve_device
from hydragnn_tpu_torch.utils.timers import Timer, print_timers


def _arch_for_factory(config) -> dict:
    arch = dict(config["NeuralNetwork"]["Architecture"])
    training = config["NeuralNetwork"]["Training"]
    arch["loss_function_type"] = training.get("loss_function_type", "mse")
    arch["conv_checkpointing"] = training.get("conv_checkpointing", False)
    return arch


def build_model_and_trainer(config, train_loader, device):
    """The model of ``config``'s derived Architecture on ``device``, its
    ``Trainer`` and a fresh state (from the loader's first batch: for a
    streaming run, the probe loader's, which consumes no stream)."""
    arch = _arch_for_factory(config)
    model = create_model_config(arch, device=device,
                                aggregation=model_aggregation(arch.get("model_type")))
    trainer = Trainer(model, config["NeuralNetwork"]["Training"],
                      freeze_conv=arch.get("freeze_conv_layers", False))
    state = trainer.init_state(next(iter(train_loader)))
    return model, trainer, state


def _prepare(config, device):
    """``(device, verbosity, (train, val, test loaders), derived config,
    probe loader)``. A ``Dataset.streaming`` config never materialises its
    train split: the config is derived over the stream's cursor-neutral
    probe window (JAX ``driver.py:232-249``), whose loader is returned
    for the trainer's example batch; otherwise the probe is None."""
    from hydragnn_tpu_torch.data.stream import build_stream_loaders, streaming_requested

    dev = resolve_device(device)
    verbosity = config.get("Verbosity", {}).get("level", 0)
    if streaming_requested(config):
        train_loader, val_loader, test_loader, probe = build_stream_loaders(config)
        config = update_config(config, probe, val_loader, test_loader)
        return dev, verbosity, (train_loader, val_loader, test_loader), config, probe
    loaders = dataset_loading_and_splitting(config)
    config = update_config(config, *loaders)
    return dev, verbosity, loaders, config, None


def run_training_impl(config, device=None, telemetry_port=None):
    """Train the run of ``config``; returns the final ``TrainState``, with
    the run's name, per-epoch history, last checkpoint write, the chunks'
    readbacks and the divergence guard's counters in its ``info``.
    ``telemetry_port``: the live endpoint's port (beats
    ``HYDRAGNN_OBS_PORT`` and ``Telemetry.port``; 0 an ephemeral one)."""
    t0 = time.perf_counter()
    timer = Timer("run_training")
    timer.start()
    tr.initialize()
    dev, verbosity, (train_loader, val_loader, test_loader), config, probe = _prepare(
        config, device)
    tr.set_device(dev)
    log_name = get_log_name_config(config)
    save_config(config, log_name)
    # the run's telemetry: events.jsonl and the training metrics, and the
    # live endpoint when a port is asked for; HYDRAGNN_TELEMETRY=0 disables
    telemetry = obs.init_run_telemetry(config, log_name, port=telemetry_port, device=dev)
    if getattr(train_loader, "plan_event", None):
        obs.emit("bucket_plan", **train_loader.plan_event)
    writer = None
    try:
        _, trainer, state = build_model_and_trainer(config, probe or train_loader, dev)
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
        writer = ScalarWriter.for_run(log_name)
        state = train_validate_test(
            trainer, state, train_loader, val_loader, test_loader, config["NeuralNetwork"],
            log_name, verbosity, writer=writer,
            create_plots=config.get("Visualization", {}).get("create_plots", False),
            resume_meta=resume_meta)
        if not trainer.final_state_saved:
            trainer.last_save = save_model(state, log_name, train_meta=trainer.final_train_meta)
        timer.stop()
        if verbosity:
            print_timers(verbosity)
        tr.save(f"./logs/{log_name}/trace")
        # the region totals: always to the scalars, to the events with a run
        regions = tr.totals()
        if regions:
            if writer is not None:
                writer.add_regions(regions, step=training["num_epoch"])
            if telemetry is not None:
                telemetry.emit("tracer_totals",
                               regions={k: round(v, 6) for k, v in regions.items()})
    except BaseException:
        # the stream records that the run died: run_end "failed"
        try:
            try:
                drain_async(timeout=60.0)
            except Exception:
                pass  # the original failure is the one to raise
            if writer is not None:
                writer.close()
        finally:
            obs.deactivate(status="failed")
        raise
    try:
        if writer is not None:
            writer.close()
    finally:
        obs.deactivate(status="complete")  # run_end, even if a backend fails to close
    state.info.update(log_name=log_name, history=trainer.history,
                      last_save=getattr(trainer, "last_save", None),
                      wall_s=time.perf_counter() - t0, fit_readbacks=trainer.fit_readbacks,
                      guard=None if trainer.guard is None else trainer.guard.state_dict())
    return state


def run_prediction_impl(config, device=None):
    dev, _, (train_loader, _, test_loader), config, probe = _prepare(config, device)
    log_name = get_log_name_config(config)
    _, trainer, state = build_model_and_trainer(config, probe or train_loader, dev)
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
