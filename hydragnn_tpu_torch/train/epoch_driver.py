"""The epoch driver (port of ``train/epoch_driver.py``'s host path):
train, validate and test once an epoch, the plateau learning rate, early
stopping, the best checkpoint ``<name>-best``, and the resumable
checkpoint with its ``train_meta`` every ``resume_every`` epochs (keeping
``checkpoint_keep_last`` rolling copies).

``train_meta`` is the JAX package's format-2 section: ``format``,
``epoch``, ``rng``, and the ``state_dict``s of the plateau, early-stopping
and best-checkpoint trackers (and of the divergence guard, and a chunked
run's ``fit_sched``). ``rng`` is a JAX PRNG key, ``uint32[2]``. The port
draws nothing from it (its stochastic layers draw from
``Trainer.generator``) and cannot split it without JAX, so it carries the
key unchanged: the one it read when resuming, else
``jax.random.PRNGKey(seed)`` of the run's seed (``HYDRAGNN_SEED`` >
``Training.random_seed`` > 1337), which is ``[seed >> 32, seed & 0xffffffff]``
for the threefry key. The JAX package accepts either on resume. The port
adds ``perm_rng``, the state of ``Trainer.perm_generator`` (the staged
epochs' microbatch order, uint8), which the JAX package does not read: a
resumed staged or chunked run then draws the orders the uninterrupted run
would have. A streaming train loader (``data/stream/``) adds ``stream``,
its mix cursor, which a resumed run restores before its first epoch; such a
loader is never staged (``device_resident_dataset`` streams it).

With ``device_resident_dataset`` (or ``HYDRAGNN_DEVICE_RESIDENT``) the
training set is staged on the device once and every epoch runs
``Trainer.train_epoch_staged``; the validation and test sets are staged at
the first evaluation and run by ``evaluate_staged`` (the JAX package's
``epoch_driver.py:336-348`` and ``:590-661``). Batches of more than one
shape cannot stack: the driver prints the JAX package's message and
streams, its documented rule for bucketed layouts. Evaluation sets that
cannot stage (ragged, empty, or out of memory) stream from then on.

With ``fit_chunk_epochs`` (or ``HYDRAGNN_FIT_CHUNK``) > 0 and a staged
training set, the run goes in chunks of that many epochs, each one
``Trainer.fit_staged`` (the JAX package's ``epoch_driver.py:337-590``):
the plateau rate, early stopping and the best state on the device, one
readback a chunk, every chunk padded to the same length so that the last
one replays the same programs. Between chunks the host logs the epochs,
saves ``<name>-best`` when the chunk improved it, writes the resumable
checkpoint with ``train_meta``'s ``fit_sched`` section (and the host
trackers mirrored from the device's state), stops after an early stop
or when the job's wall clock (``parallel.check_remaining``) has no room
for another chunk. ``restage_per_chunk`` (``HYDRAGNN_RESTAGE_PER_CHUNK``)
stages the training set again, in the next epoch's sample order, before
each chunk, into the staged stack's own tensors (``Trainer.restage``), so
that the captured programs bound to them stay valid. A resumed chunked run takes its ``fit_sched`` with
``best_val`` reset (the resumed weights did not earn it).

The divergence guard (``trainer.guard``): on host epochs last-good is
seeded with the starting state, an epoch whose training or validation
loss is not finite restores it with the rate lowered and is not logged,
and a finite epoch commits; on chunks, a chunk whose last epoch is NaN
without an early stop restores and runs again. Its counters go into
``train_meta``'s ``guard`` section and come back on resume.

Candidate publication (``publish_dir`` or ``HYDRAGNN_PUBLISH_DIR``): each
resumable save is also snapshotted into the serving side's
``CandidateChannel`` (``serve/registry.publish_candidate``) every
``publish_every`` saves' epochs (``HYDRAGNN_PUBLISH_EVERY``, default 1;
0: every save), keeping the newest ``publish_keep_last``
(``HYDRAGNN_PUBLISH_KEEP``, default 4) besides the pinned ones, with the
epoch and the validation loss in the manifest. With the async writer the
snapshot rides the writer's queue behind the save, so only a durable
checkpoint is published. A publish that fails with ``OSError`` is printed
and the run goes on; a published one is a ``candidate_published`` event.

Telemetry (``obs/runtime.py``; no-ops without an active run): each epoch
(or chunk) opens a goodput window (``epoch_start``), the evaluation is
its eval span, each logged epoch is an ``epoch`` event with its throughput
and padding waste (and its losses go to ``writer``, the run's scalars),
and a resume, a chunk, an early stop and a wall-clock stop are events; a
chunk or a staged epoch ticks the trace capture.

Elastic runs and plots raise where a config or the environment asks for
them (``ROADMAP.md``, queue 1).
"""

import os
import time

import numpy as np
import torch

from hydragnn_tpu_torch.obs import runtime as obs
from hydragnn_tpu_torch.parallel.distributed import check_remaining
from hydragnn_tpu_torch.train.checkpoint import drain_async, resolve_async_writer, save_model
from hydragnn_tpu_torch.train.common import FIT_SCHED_FIELDS, SchedState, _env_flag, _is_oom
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
    if os.getenv("HYDRAGNN_ELASTIC_DIR") or os.getenv("HYDRAGNN_HEARTBEAT_FILE"):
        raise _not_ported("elastic runs", 8)
    if create_plots:
        raise _not_ported("Visualization.create_plots", 7)


def _candidate_publisher(training: dict, log_name: str, writer, verbosity: int):
    """``publish(epoch, val_loss)`` for the run's resumable saves (module
    docstring; JAX ``epoch_driver.py:174-238``), or None without a
    ``publish_dir``."""
    publish_dir = os.getenv("HYDRAGNN_PUBLISH_DIR", training.get("publish_dir") or "") or None
    if publish_dir is None:
        return None
    every = int(os.getenv("HYDRAGNN_PUBLISH_EVERY", str(training.get("publish_every", 1))))
    keep = int(os.getenv("HYDRAGNN_PUBLISH_KEEP", str(training.get("publish_keep_last", 4))))

    def publish(epoch, val_loss=None):
        if every > 0 and (epoch + 1) % every != 0:
            return

        def job():
            from hydragnn_tpu_torch.serve.registry import publish_candidate

            try:
                manifest = publish_candidate(
                    publish_dir, log_name, "./logs/", keep_last=keep, epoch=int(epoch),
                    val_loss=None if val_loss is None else float(val_loss))
            except OSError as e:
                # an unwritable channel must not end a run that would finish
                print_distributed(verbosity, f"candidate publish failed: {e}")
                return
            obs.emit("candidate_published", candidate=int(manifest["seq"]),
                     checkpoint=manifest["checkpoint"], epoch=int(epoch))

        # behind the save on the writer's queue: only a durable file is copied
        if writer is not None:
            writer.submit(job)
        else:
            job()

    return publish


def _epoch_complete(train_loader, epoch, train_loss, val_loss, test_loss, t_train, mode):
    """The epoch's record for the active run: throughput and padding waste
    from the loader's epoch plan (JAX ``epoch_driver.py:387-415``)."""
    graphs_per_sec = nodes_per_sec = waste = None
    stats = None
    if hasattr(train_loader, "epoch_padding_stats"):
        try:
            stats = train_loader.epoch_padding_stats()
        except Exception:
            stats = None
    if stats is not None and stats[1]:
        waste = 1.0 - stats[0] / stats[1]
    if t_train:
        try:
            n = len(train_loader.dataset)
        except TypeError:
            n = 0
        if n:
            graphs_per_sec = n / t_train
        if stats is not None:
            nodes_per_sec = stats[0] / t_train
    obs.epoch_complete(epoch, train_loss, val_loss, test_loss, seconds=t_train,
                       graphs_per_sec=graphs_per_sec, nodes_per_sec=nodes_per_sec,
                       padding_waste=waste, mode=mode)


def build_train_meta(epoch, rng, scheduler, early, ckpt, guard=None, sched=None,
                     perm_rng=None, stream=None):
    """The format-2 training-loop state after epoch ``epoch``; ``guard``
    adds the guard's counters, ``sched`` (a chunk's ``fit_sched``: numpy
    0-d arrays by JAX's field names) the device schedulers' state,
    ``perm_rng`` the order generator's state and ``stream`` the streaming
    loader's mix cursor (JAX ``epoch_driver.py:57-73``), so that a resumed
    streaming run draws the samples the uninterrupted run would have."""
    meta = {"format": 2, "epoch": int(epoch), "rng": np.asarray(rng, np.uint32),
            "plateau": scheduler.state_dict()}
    if stream is not None:
        meta["stream"] = stream
    if perm_rng is not None:
        meta["perm_rng"] = np.asarray(perm_rng.numpy(), np.uint8)
    if early is not None:
        meta["early"] = early.state_dict()
    if ckpt is not None:
        meta["best_ckpt"] = ckpt.state_dict()
    if guard is not None:
        meta["guard"] = guard.state_dict()
    if sched is not None:
        meta["fit_sched"] = {k: np.asarray(sched[k]) for k in FIT_SCHED_FIELDS}
    return meta


def mirror_sched(sched: dict, scheduler, early, lr: float):
    """The host trackers set from a chunk's ``fit_sched`` (JAX
    ``epoch_driver.py:544-557``), so that a checkpoint's ``plateau`` and
    ``early`` sections stay true for a resumed run on the host path."""
    scheduler.lr = float(lr)
    pb = float(sched["plateau_best"])
    scheduler.best = pb if np.isfinite(pb) else None
    scheduler.num_bad_epochs = int(sched["plateau_bad"])
    if early is not None:
        eb = float(sched["early_best"])
        early.best = eb if np.isfinite(eb) else None
        early.counter = int(sched["early_count"])
        early.early_stop = bool(sched["stopped"])


def train_validate_test(trainer, state, train_loader, val_loader, test_loader,
                        config_nn: dict, log_name: str, verbosity: int = 0, writer=None,
                        create_plots: bool = False, resume_meta=None):
    """Run the epochs of ``config_nn["Training"]`` from epoch 0, or from the
    epoch after ``resume_meta["epoch"]`` with its trackers when resuming.
    Returns the state; ``trainer.history`` holds each epoch's losses,
    walls and host collation seconds, ``trainer.final_train_meta`` the last ``train_meta`` and
    ``trainer.final_state_saved`` whether the state is already in the
    primary checkpoint. ``writer`` (``add_scalar(tag, value, step)``, the
    run's ``obs.scalars.ScalarWriter``) takes each epoch's losses."""
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
    ckpt_writer = resolve_async_writer(training)

    guard = getattr(trainer, "guard", None)
    skip_valtest = int(os.getenv("HYDRAGNN_VALTEST", "1")) == 0
    fit_chunk = int(os.getenv("HYDRAGNN_FIT_CHUNK", str(training.get("fit_chunk_epochs", 0))))

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
        if guard is not None and resume_meta.get("guard") is not None:
            guard.load_state_dict(resume_meta["guard"])
        if resume_meta.get("perm_rng") is not None:
            trainer.perm_generator.set_state(
                torch.from_numpy(np.array(resume_meta["perm_rng"], np.uint8)))
        if early is not None and early.early_stop:
            print_distributed(verbosity, "Resume: early stopping had already triggered")
            start_epoch = num_epoch
        if resume_meta.get("stream") is not None and hasattr(train_loader, "load_state_dict"):
            # the mix cursor before the first epoch: the resumed run draws
            # the sample sequence the uninterrupted one would have
            train_loader.load_state_dict(resume_meta["stream"])
        print_distributed(verbosity, f"Resuming training at epoch {start_epoch} "
                                     f"(lr {scheduler.lr:.3e})")
        obs.emit("resume", start_epoch=int(start_epoch), lr=float(scheduler.lr))
        trainer.final_state_saved = start_epoch >= num_epoch

    publish = _candidate_publisher(training, log_name, ckpt_writer, verbosity)

    def stream_state():
        """A streaming loader's mix cursor; None for any other loader."""
        sd = getattr(train_loader, "state_dict", None)
        return sd() if callable(sd) else None

    def save_resumable(epoch, sched=None, val_loss=None):
        meta = build_train_meta(epoch, rng, scheduler, early, ckpt, guard, sched,
                                trainer.perm_generator.get_state(), stream=stream_state())
        trainer.last_save = save_model(state, log_name, train_meta=meta, keep_last=keep_last,
                                       writer=ckpt_writer)
        trainer.final_train_meta = meta
        trainer.final_state_saved = True
        if publish is not None:
            publish(epoch, val_loss)

    def log_epoch(epoch, train_loss, val_loss, test_loss, train_tasks, t_train, extra,
                  mode="stream"):
        try:
            rate = f", {len(train_loader.dataset) / max(t_train, 1e-9):.0f} graphs/sec"
        except TypeError:  # a streaming loader has no dataset to count
            rate = ""
        print_distributed(
            verbosity,
            f"Epoch: {epoch:04d}, Train Loss: {train_loss:.8f}, Val Loss: {val_loss:.8f}, "
            f"Test Loss: {test_loss:.8f}, Train Time: {t_train:.2f}s{rate}")
        trainer.history.append({
            "epoch": epoch, "train_loss": float(train_loss), "val_loss": float(val_loss),
            "test_loss": float(test_loss), "train_tasks": np.atleast_1d(train_tasks).tolist(),
            "train_s": t_train, **extra,
        })
        if writer is not None:
            writer.add_scalar("train error", train_loss, epoch)
            writer.add_scalar("validate error", val_loss, epoch)
            writer.add_scalar("test error", test_loss, epoch)
            for itask, tl in enumerate(np.atleast_1d(train_tasks)):
                writer.add_scalar(f"train error of task {itask}", float(tl), epoch)
        if obs.active() is not None:
            _epoch_complete(train_loader, epoch, train_loss, val_loss, test_loss, t_train, mode)

    staged = None
    if _env_flag("HYDRAGNN_DEVICE_RESIDENT", training, "device_resident_dataset"):
        if getattr(train_loader, "reports_stream_stats", False):
            # a stream never materialises: staging would read a whole
            # epoch off the cursor before the first one trains
            print_distributed(verbosity, "device_resident_dataset: a streaming train split "
                                         "does not stage — streaming")
        else:
            try:
                staged = trainer.stage_batches(list(train_loader))
            except ValueError:
                print_distributed(
                    verbosity,
                    "device_resident_dataset: batches are not shape-uniform "
                    "(bucketed layout?) — falling back to streaming")

    ran_fit = staged is not None and fit_chunk > 0
    if ran_fit:
        state = _fit_chunks(trainer, state, staged, train_loader, val_loader, test_loader,
                            training, fit_chunk, num_epoch, start_epoch, resume_meta,
                            skip_valtest, scheduler, early, ckpt, guard, resume_every,
                            save_resumable, log_epoch, verbosity)

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

    if guard is not None and guard.last_good is None:
        # a non-finite first epoch is then a bounded restore (the streaming
        # path also seeds inside train_epoch)
        guard.commit(state)
    for epoch in range(start_epoch, num_epoch) if not ran_fit else ():
        t0 = time.time()
        trainer.final_state_saved = False
        # the goodput window and HYDRAGNN_PROFILE_AT_STEP's <epoch>:<step>
        obs.epoch_start(epoch)
        train_loader.set_epoch(epoch)
        collate0 = trainer.collate_s
        if staged is not None:
            state, train_loss, train_tasks = trainer.train_epoch_staged(state, staged)
        else:
            state, train_loss, train_tasks = trainer.train_epoch(state, train_loader)
        t_train = time.time() - t0
        collate_s = trainer.collate_s - collate0
        if skip_valtest:
            val_loss = test_loss = train_loss
        else:
            obs.eval_start()  # the goodput ledger's eval span
            try:
                val_loss, test_loss = evaluate_both()
            finally:
                obs.eval_complete()
        if guard is not None:
            if not (np.isfinite(train_loss) and np.isfinite(val_loss)):
                print_distributed(
                    verbosity, f"Epoch {epoch:04d}: non-finite loss (train {train_loss}, "
                               f"val {val_loss}) — restoring last-good state with halved LR")
                state = guard.on_bad_epoch(state)
                continue
            guard.commit(state)
            # a restore lowered the rate in place: the plateau must not raise it
            scheduler.lr = get_learning_rate(state.optimizer)
        new_lr = scheduler.step(val_loss)
        if abs(new_lr - get_learning_rate(state.optimizer)) > 1e-12:
            set_learning_rate(state.optimizer, new_lr)
        if ckpt is not None:
            ckpt(state, epoch, val_loss, save_model)
        stopping = early is not None and early(val_loss)
        if resume_every > 0 and ((epoch + 1) % resume_every == 0 or stopping
                                 or epoch == num_epoch - 1):
            save_resumable(epoch, val_loss=val_loss)
        log_epoch(epoch, train_loss, val_loss, test_loss, train_tasks, t_train, {
            "train_collate_s": collate_s, "epoch_s": time.time() - t0,
            "lr": float(get_learning_rate(state.optimizer))},
            mode="staged" if staged is not None else "stream")
        if stopping:
            print_distributed(verbosity, f"Early stopping at epoch {epoch}")
            obs.emit("early_stop", epoch=int(epoch))
            break
        if not check_remaining(time.time() - t0):
            # a wall-clock stop is when a resumable checkpoint matters
            if resume_every > 0 and not trainer.final_state_saved:
                save_resumable(epoch, val_loss=val_loss)
            print_distributed(verbosity, "Stopping: not enough job wall-clock time left")
            obs.emit("wallclock_stop", epoch=int(epoch))
            break
    drain_async()
    return state


def _fit_chunks(trainer, state, staged, train_loader, val_loader, test_loader, training,
                fit_chunk, num_epoch, start_epoch, resume_meta, skip_valtest, scheduler, early,
                ckpt, guard, resume_every, save_resumable, log_epoch, verbosity):
    """The chunked run (module docstring; JAX ``epoch_driver.py:337-590``).
    Returns the state."""
    staged_val = None if skip_valtest else trainer.stage_batches(list(val_loader))
    staged_test = None if skip_valtest else trainer.stage_batches(list(test_loader))
    sched = best_state = None
    # the best already on disk: a worse epoch after a resume must not replace it
    best_saved = float(ckpt.best) if ckpt is not None and ckpt.best is not None else np.inf
    if resume_meta and resume_meta.get("fit_sched") is not None:
        section = dict(resume_meta["fit_sched"])
        # the resumed weights did not earn the saved best_val: track anew
        section["best_val"] = np.asarray(np.inf, np.float32)
        sched = SchedState.from_host(section, trainer.device)
    restage = _env_flag("HYDRAGNN_RESTAGE_PER_CHUNK", training, "restage_per_chunk")
    if guard is not None and guard.last_good is None:
        guard.commit(state)
    epoch0 = start_epoch
    while epoch0 < num_epoch:
        n = min(fit_chunk, num_epoch - epoch0)
        # a chunk is one dispatch: its goodput window and profile arming
        obs.epoch_start(epoch0)
        if restage and epoch0 > 0:
            train_loader.set_epoch(epoch0)
            # in place: the chunk's graphs are bound to the stack's addresses
            staged = trainer.restage(staged, list(train_loader))
        trainer.final_state_saved = False
        t0 = time.time()
        state, best_state, sched, series = trainer.fit_staged(
            state, staged, n, staged_val=staged_val, staged_test=staged_test, sched=sched,
            best_state=best_state, pad_to=fit_chunk)
        chunk_time = time.time() - t0
        obs.emit("fit_chunk", epoch_start=int(epoch0), epochs=int(n),
                 wall_time_s=round(chunk_time, 6))
        # the trace capture ticks per chunk (no per-step hook inside one)
        obs.dispatch_boundary()
        host = series["sched"]
        for i in range(n):
            if np.isnan(series["train_loss"][i]):
                continue
            # the chunk is one dispatch: chunk_time / n is each epoch's share
            log_epoch(epoch0 + i, series["train_loss"][i], series["val_loss"][i],
                      series["test_loss"][i], series["train_tasks"][i], chunk_time / n,
                      {"train_collate_s": 0.0, "epoch_s": chunk_time / n,
                       "lr": float(series["lr"][i]), "chunk": epoch0}, mode="fit")
        if guard is not None:
            # a trailing NaN row with no early stop: the chunk diverged
            if not bool(host["stopped"]) and not np.isfinite(series["train_loss"][n - 1]):
                print_distributed(verbosity, f"Chunk at epoch {epoch0}: non-finite loss — "
                                             "restoring last-good state with halved LR")
                state = guard.on_bad_epoch(state)
                continue
            guard.commit(state)
        if ckpt is not None:
            bv = float(host["best_val"])
            if np.isfinite(bv) and bv < best_saved:
                save_model(best_state, ckpt.name, ckpt.path)
                best_saved = bv
                ckpt.best = bv  # the resume meta carries the best on disk
        epoch0 += n
        if resume_every > 0:
            mirror_sched(host, scheduler, early, series["lr"][n - 1])
            save_resumable(epoch0 - 1, sched=host, val_loss=series["val_loss"][n - 1])
        if bool(host["stopped"]):
            ep_stop = epoch0 - n + int(np.argmax(series["stopped"]))
            print_distributed(verbosity, f"Early stopping at epoch {ep_stop}")
            obs.emit("early_stop", epoch=int(ep_stop))
            break
        # the next chunk is indivisible: it needs a whole chunk's time
        if not check_remaining(chunk_time):
            print_distributed(verbosity, "Stopping: not enough job wall-clock time left")
            obs.emit("wallclock_stop", epoch=int(epoch0 - 1))
            break
    return state
