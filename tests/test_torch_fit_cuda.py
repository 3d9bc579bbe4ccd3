"""Whole-run chunks and the divergence guard on the card; marker ``cuda``,
skipped inside the test without one. Run on the card with
``python -m pytest tests/test_torch_fit_cuda.py -q -p no:randomly --noconftest``.

- A captured chunk (``Trainer.fit_staged``: 4 epochs of 3 staged PNA
  batches, a validation stack, padded to 6) against the same chunk run
  eagerly on the card (every program's body called directly) from the
  same weights, twice: the series' losses at rtol 1e-4 and its rates and
  stop flags exactly; the parameters and statistics as
  ``test_torch_capture_cuda.py`` holds a captured step against eager ones,
  each per-step term times the 12 steps, plus 4 times the two eager
  chunks' own spread (the kernels' atomics sum in a run-dependent order);
  the step counts and the rate exactly.
- After an early stop in the middle of a chunk, the rows after it are
  NaN, and a further chunk carrying the stopped ``SchedState`` (every
  epoch's replays run, every epoch skipped) leaves the state bit for bit
  as it was and its step count unchanged.
- The guard's in-place restore reaches the captured ``train_step``: after
  a step, a commit, a second step and a restore (``guard_max_bad_steps``
  1), a replay from the restored state at the halved rate is an eager
  step from the committed state at that rate, held as
  ``test_torch_capture_cuda.py`` holds a captured step.
- ``Trainer.restage`` writes a new stack into the staged one in place:
  two restaged chunks capture no program and leave
  ``torch.cuda.memory_allocated`` where the first chunk left it (a new
  stack would be bound anew by every chunk program and kept by its
  graphs), and the stack then holds the new batches exactly, in the
  compact wire format the trainer ships (``train/transfer.py``).
"""

import copy

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.benchmarks.model_bench import _collate, make_graphs
from hydragnn_tpu_torch.graph.batch import stack_batches
from hydragnn_tpu_torch.train import Trainer, capture, get_learning_rate, set_learning_rate
from hydragnn_tpu_torch.train.capture import state_tensors

from test_torch_capture_cuda import ADAMW, LR, ZERO_GRAD, _eager_steps, _hold_step, _setup

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured programs have no CPU mode")
    return torch.device("cuda")


def _staged(card, training, contrary=False, seeds=(0, 1, 2)):
    """A PNA trainer on the card, its state, three staged batches and a
    staged validation batch (with ``contrary``, targets the training
    moves away from)."""
    batches = [_setup("PNA", card, seed=s)[2] for s in seeds]
    trainer, state, _ = _setup("PNA", card)
    trainer = Trainer(state.model, training)
    state = trainer.init_state(batches[0])
    val = copy.deepcopy(batches[0])
    if contrary:
        val.targets = [-3.0 - t for t in val.targets]
    return trainer, state, trainer.stage_batches(batches), trainer.stage_batches([val])


def _twin(trainer, state, card):
    """A trainer over a copy of ``state`` (weights, moments, step counts
    and rate), with the same staged data semantics."""
    model, optimizer = copy.deepcopy((state.model, state.optimizer))
    twin = Trainer(model, trainer.training_config)
    tstate = copy.copy(state)
    tstate.model, tstate.optimizer = model, optimizer
    return twin, tstate


def _hold_chunk(cap, e, f, start, steps, lr=LR):
    """The captured chunk's state against the eager chunk ``e`` (``f``:
    the second eager chunk, for the spread), as ``_hold_step`` holds one
    step, with its per-step terms times ``steps``: each parameter's change
    within ``1e-3`` of the eager one relative plus ``1e-2 lr`` a step plus
    4 times the eager spread where the last gradient is above ``1e-3`` of
    its max, within ``2 lr`` a step elsewhere and where the whole gradient
    is rounding noise (a bias BatchNorm cancels); the BatchNorm statistics
    within ``1e-4`` of their largest plus ``1e-3`` relative plus the
    spread; the step counts and the rate exactly."""
    eager, other = dict(e.model.named_parameters()), dict(f.model.named_parameters())
    top = max(float(q.grad.abs().max()) for q in eager.values())
    for name, p in cap.model.named_parameters():
        q, r = eager[name], other[name]
        du, de = (p - start[name]).double(), (q - start[name]).double()
        uspread = float((de - (r - start[name]).double()).abs().max())
        ge = q.grad.double()
        gmax = float(ge.abs().max())
        loose = (du - de).abs() <= 2 * lr * steps
        if gmax <= ZERO_GRAD * top:
            assert bool(loose.all()), f"param {name} (zero grad)"
            continue
        sure = ge.abs() > 1e-3 * gmax
        bound = 1e-3 * de.abs() + 1e-2 * lr * steps + 4 * uspread
        assert bool(((du - de).abs() <= bound)[sure].all()), f"param {name}"
        assert bool(loose[~sure].all()), f"param {name} (near-zero grad)"
    eager_b, other_b = dict(e.model.named_buffers()), dict(f.model.named_buffers())
    for name, b in cap.model.named_buffers():
        if b.is_floating_point():
            x = eager_b[name].double()
            spread = float((x - other_b[name].double()).abs().max())
            bound = 1e-4 * float(x.abs().max()) + 1e-3 * x.abs() + 1e-7 + 4 * spread
            assert bool(((b.double() - x).abs() <= bound).all()), f"buffer {name}"
    for p, q in zip(cap.model.parameters(), e.model.parameters()):
        assert float(cap.optimizer.state[p]["step"]) == float(e.optimizer.state[q]["step"])
    assert get_learning_rate(cap.optimizer) == get_learning_rate(e.optimizer)


def _eager(monkeypatch):
    """Every program's body called directly (on the card, no graph)."""
    monkeypatch.setattr(capture.Program, "__call__", lambda self, *args: self.body(*args))


def pytest_captured_chunk_matches_the_eager_chunk(card, monkeypatch):
    trainer, state, staged, val = _staged(card, dict(ADAMW))
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    twins = [_twin(trainer, state, card) for _ in range(2)]
    runs = []
    with monkeypatch.context() as m:
        _eager(m)
        for twin, tstate in twins:
            runs.append(twin.fit_staged(tstate, staged, 4, staged_val=val, shuffle=False,
                                        pad_to=6))
    state, _, _, series = trainer.fit_staged(state, staged, 4, staged_val=val, shuffle=False,
                                             pad_to=6)
    assert trainer.programs(state).counts()["fit_tail/10"]["captures"] == 1
    (e_state, _, _, e_series), (f_state, _, _, _) = runs
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(series[key], e_series[key], rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(series["lr"], e_series["lr"])
    np.testing.assert_array_equal(series["stopped"], e_series["stopped"])
    assert state.step == e_state.step == 12
    _hold_chunk(state, e_state, f_state, start, steps=12)


def pytest_state_after_an_early_stop_stays_unchanged(card):
    training = dict(ADAMW, EarlyStopping=True, patience=1)
    trainer, state, staged, val = _staged(card, training, contrary=True)
    state, best, sched, series = trainer.fit_staged(state, staged, 5, staged_val=val, pad_to=6)
    stop = int(np.argmax(series["stopped"]))
    assert series["stopped"].any() and stop < 4, series
    assert np.isnan(series["train_loss"][stop + 1:]).all()
    assert state.step == 3 * (stop + 1) and int(sched.epoch) == stop + 1
    before = [t.detach().clone() for t in state_tensors(state.model, state.optimizer)]
    state, best, sched, series = trainer.fit_staged(state, staged, 5, staged_val=val,
                                                    sched=sched, best_state=best, pad_to=6)
    assert np.isnan(series["train_loss"]).all() and series["stopped"].all()
    assert state.step == 3 * (stop + 1) and int(sched.epoch) == stop + 1
    for a, b in zip(before, state_tensors(state.model, state.optimizer)):
        assert torch.equal(a, b.detach())


def pytest_guard_restore_in_place_reaches_the_replays(card):
    training = dict(ADAMW, divergence_guard=True, guard_max_bad_steps=1)
    trainer, state, batch = _setup("PNA", card)
    trainer = Trainer(state.model, training)
    state = trainer.init_state(batch)
    guard = trainer.guard
    state, _ = trainer.train_step(state, batch)  # capture, then step 1
    guard.commit(state)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    set_learning_rate(state.optimizer, LR / 2)
    eagers = _eager_steps(trainer, state, batch)  # from the commit, at the halved rate
    set_learning_rate(state.optimizer, LR)
    state, _ = trainer.train_step(state, batch)  # step 2, then undone
    state = guard.on_bad_step(state, guard.snapshot(state))
    assert guard.restores == 1 and get_learning_rate(state.optimizer) == pytest.approx(LR / 2)
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), start[name]), name
    state, met = trainer.train_step(state, batch)
    assert trainer.programs(state).counts()["train_step"] == {"captures": 1, "replays": 3}
    _hold_step(state, eagers, met["loss"], start, lr=LR / 2)


def pytest_restage_in_place_keeps_programs_and_memory(card):
    trainer, state, staged, val = _staged(card, dict(ADAMW))
    # the new stacks are made first: the check counts what the chunks keep
    restacks = [[_collate(make_graphs(8, 20, 6, seed=s, input_dim=1), 8, 20, 6)
                 for s in seeds] for seeds in ((3, 4, 5), (6, 7, 8))]
    state, best, sched, _ = trainer.fit_staged(state, staged, 2, staged_val=val, pad_to=2)
    torch.cuda.synchronize(card)
    captures, mem = capture.capture_counts()["captures"], torch.cuda.memory_allocated(card)
    for batches in restacks:
        assert trainer.restage(staged, batches) is staged
        state, best, sched, series = trainer.fit_staged(
            state, staged, 2, staged_val=val, sched=sched, best_state=best, pad_to=2)
        assert np.isfinite(series["train_loss"]).all()
    torch.cuda.synchronize(card)
    assert capture.capture_counts()["captures"] == captures
    assert torch.cuda.memory_allocated(card) == mem, (torch.cuda.memory_allocated(card), mem)
    want = trainer.compact(stack_batches(restacks[-1]))  # as the trainer ships a stack
    for name, a, b in zip(want.leaves()[0], staged.stack.leaves()[1], want.leaves()[1]):
        assert torch.equal(a.cpu(), b), name
    assert state.step == 18
