"""The captured programs on the card (``train/capture.py``), against the
same bodies run eagerly on the card; marker ``cuda``, skipped inside the
test without one. Run on the card with
``python -m pytest tests/test_torch_capture_cuda.py -q -p no:randomly --noconftest``.

- Step 1 of each of the nine stacks (``segment`` f32, and ``fused`` for the
  five with fused kernels: SchNet's K6 is a programmatic dependent launch,
  an edge of the captured graph; a small batch of
  ``benchmarks/model_bench.make_graphs`` graphs, GAT without dropout), the
  captured ``Trainer.train_step`` against two runs of ``steps.train_step``
  taken eagerly from the same weights: the loss at rtol 1e-4; a gradient
  below 1e-6 of the largest is zero (the biases BatchNorm cancels:
  rounding noise on either side) and must stay so; each other gradient
  within ``1e-4 * max|g| + 1e-3 * |g|``, each parameter's update within
  ``1e-3`` of the eager one relative plus ``1e-2 lr`` where the gradient
  is above ``1e-3 * max|g|``, and within ``2 lr`` below it (Adam's update
  there is ``lr`` times a sign that rounding can flip), the BatchNorm
  statistics within ``1e-4`` of their largest plus ``1e-3`` relative:
  each bound plus 4 times the two eager runs' own spread on the tensor
  (the kernels' atomics sum in a run-dependent order; GAT's
  attention-logit gradients, the residue of a cancelling sum, spread
  most).
- Replays of PNA in ``fused``, ``segment`` and dense bf16, from a host
  batch and a device batch, under ``torch.cuda.set_sync_debug_mode
  ("error")``: no host sync inside a replay.
- The capture count stays flat after warmup; a second shape captures once.
- A learning rate set after capture (``set_learning_rate``) reaches the
  replays: no parameter moves by half the old rate, and the update is the
  eager steps' at the new rate, as above.
- GAT's attention dropout captured with ``Trainer.generator`` registered:
  each replay draws new masks, each at the keep rate within 3 sigma, the
  kept entries scaled exactly.
- ``ops.launch_counts()`` after N replays is N times the capture's
  recorded delta, which equals one eager step's launches.
- The bridge round trip (``models/bridge.py``) of a trainer that has
  replayed: its optax state (device step counts and rate read back) loads
  into a CPU copy, and back into the card's optimizer in place (over
  scrambled moments), after which the replay steps as eager steps from
  the state before it do.
"""

import copy
import threading

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch import ops
from hydragnn_tpu_torch.benchmarks.model_bench import _arch, _collate, make_graphs
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.models.bridge import (
    flax_variables_of,
    load_flax_variables,
    load_optax_adam_state,
    optax_state_of,
)
from hydragnn_tpu_torch.models.gat import attention_dropout
from hydragnn_tpu_torch.ops.dense_agg import attach_neighbor_lists
from hydragnn_tpu_torch.train import (
    Trainer,
    get_learning_rate,
    select_optimizer,
    set_learning_rate,
    steps,
)
from hydragnn_tpu_torch.train import capture
from hydragnn_tpu_torch.train.capture import ProgramSet

pytestmark = pytest.mark.cuda

STACKS = ("PNA", "GIN", "SAGE", "SchNet", "EGNN", "GAT", "MFC", "CGCNN", "DimeNet")
FUSED_STACKS = STACKS[:5]  # K3-K7: SchNet's K6 launches as a programmatic dependent
LR = 1e-3
ZERO_GRAD = 1e-6  # a gradient below this share of the largest is zero (chip_smoke.ZERO_GRAD)
ADAMW = {"Optimizer": {"type": "AdamW", "learning_rate": LR}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured programs have no CPU mode")
    return torch.device("cuda")


def _setup(model_type, card, aggregation="segment", dense=False, bf16=False, graphs=8,
           hidden=32, seed=0):
    """A model of ``model_type`` on the card and a host batch for it."""
    input_dim = 16 if model_type == "CGCNN" else 1
    samples = make_graphs(graphs, 20, 6, seed=seed, input_dim=input_dim)
    batch = _collate(samples, graphs, 20, 6, with_triplets=model_type == "DimeNet")
    if dense:
        batch = attach_neighbor_lists(batch)
    cfg = _arch(model_type, 16 if model_type == "CGCNN" else hidden, 2, 20, input_dim=input_dim)
    model = create_model_config(cfg, device=card, aggregation=aggregation, seed=seed)
    model.set_dropout(0.0)
    trainer = Trainer(model, {**ADAMW, "mixed_precision": bool(bf16)})
    return trainer, trainer.init_state(batch), batch


def _eager_twin(trainer, state):
    """A copy of ``trainer``'s model and optimizer (moments, step counts
    and rate) that steps eagerly through ``steps.train_step``."""
    model = copy.deepcopy(state.model)
    twin = Trainer(model, trainer.training_config)
    tstate = copy.copy(state)
    tstate.model = model
    tstate.optimizer = select_optimizer(trainer.training_config, model)
    for p, q in zip(state.model.parameters(), model.parameters()):
        if p in state.optimizer.state:
            tstate.optimizer.state[q] = {k: v.clone() for k, v in state.optimizer.state[p].items()}
    set_learning_rate(tstate.optimizer, get_learning_rate(state.optimizer))
    return twin, tstate


def _eager_step(trainer, state, batch):
    return steps.train_step(state, trainer.put_batch(batch), guarded=trainer.guarded,
                            mixed=trainer.precision["mixed"], generator=trainer.generator)


def _hold_step(cap_state, eagers, cap_loss, start, lr=LR):
    """The captured step against eager ones from the same state
    (``eagers``: ``[(state, loss)]``, two runs): each tensor within its
    bound plus 4 times the two eager runs' own spread on it (the atomics'
    order; GAT's attention-logit gradients are the residue of a
    cancelling sum and spread most)."""
    (e_state, e_loss), (f_state, _) = eagers
    np.testing.assert_allclose(float(cap_loss), float(e_loss), rtol=1e-4)
    eager_p = dict(e_state.model.named_parameters())
    other_p = dict(f_state.model.named_parameters())
    top = max(float(q.grad.abs().max()) for q in eager_p.values())
    for name, p in cap_state.model.named_parameters():
        q, r = eager_p[name], other_p[name]
        g, ge = p.grad.double(), q.grad.double()
        du, de = (p - start[name]).double(), (q - start[name]).double()
        gspread = float((ge - r.grad.double()).abs().max())
        uspread = float((de - (r - start[name]).double()).abs().max())
        gmax = float(ge.abs().max())
        if gmax <= ZERO_GRAD * top:  # rounding noise (a bias BatchNorm cancels)
            assert float(g.abs().max()) <= ZERO_GRAD * top, f"grad {name}"
            assert bool(((du - de).abs() <= 2 * lr).all()), f"param {name} (zero grad)"
            continue
        assert bool(((g - ge).abs() <= 1e-4 * gmax + 1e-3 * ge.abs() + 4 * gspread).all()), \
            f"grad {name}"
        sure = ge.abs() > 1e-3 * gmax
        bound = 1e-3 * de.abs() + 1e-2 * lr + 4 * uspread
        assert bool(((du - de).abs() <= bound)[sure].all()), f"param {name}"
        assert bool(((du - de).abs()[~sure] <= 2 * lr).all()), f"param {name} (near-zero grad)"
    eager_b = dict(e_state.model.named_buffers())
    other_b = dict(f_state.model.named_buffers())
    for name, b in cap_state.model.named_buffers():
        if b.is_floating_point():
            e = eager_b[name].double()
            spread = float((e - other_b[name].double()).abs().max())
            bound = 1e-4 * float(e.abs().max()) + 1e-3 * e.abs() + 1e-7 + 4 * spread
            assert bool(((b.double() - e).abs() <= bound).all()), f"buffer {name}"


def _eager_steps(trainer, state, batch):
    """Two eager twins of ``state``, each stepped once on ``batch``."""
    out = []
    for _ in range(2):
        twin, tstate = _eager_twin(trainer, state)
        tstate, met = _eager_step(twin, tstate, batch)
        out.append((tstate, met["loss"]))
    return out


@pytest.mark.parametrize("model_type,mode", [(m, "segment") for m in STACKS]
                         + [(m, "fused") for m in FUSED_STACKS])
def pytest_captured_step_one_is_the_eager_step_one(card, model_type, mode):
    trainer, state, batch = _setup(model_type, card, aggregation=mode)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    eagers = _eager_steps(trainer, state, batch)
    state, met = trainer.train_step(state, batch)
    assert trainer.programs(state).counts()["train_step"] == {"captures": 1, "replays": 1}
    _hold_step(state, eagers, met["loss"], start)


@pytest.mark.parametrize("mode", ["fused", "segment", "dense_bf16"])
def pytest_replays_make_no_host_sync(card, mode):
    dense = mode == "dense_bf16"
    trainer, state, batch = _setup("PNA", card, aggregation="segment" if dense else mode,
                                   dense=dense, bf16=dense)
    state, _ = trainer.train_step(state, batch)  # capture
    trainer.eval_step(state, batch)
    dev = trainer.put_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in (batch, dev, batch):
            state, met = trainer.train_step(state, b)
            trainer.eval_step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(met["loss"]))


def pytest_capture_count_stays_flat_after_warmup(card):
    trainer, state, batch = _setup("PNA", card)
    for _ in range(4):
        state, _ = trainer.train_step(state, batch)
    counts = trainer.programs(state).counts()["train_step"]
    assert counts == {"captures": 1, "replays": 4}
    _, _, other = _setup("PNA", card, graphs=4)
    state, _ = trainer.train_step(state, other)
    state, _ = trainer.train_step(state, batch)
    assert trainer.programs(state).counts()["train_step"] == {"captures": 2, "replays": 6}


def pytest_a_new_learning_rate_reaches_the_replays(card):
    trainer, state, batch = _setup("PNA", card)
    state, _ = trainer.train_step(state, batch)  # capture and step 1 at LR
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    set_learning_rate(state.optimizer, LR / 10)  # the twins copy the new rate
    eagers = _eager_steps(trainer, state, batch)
    state, met = trainer.train_step(state, batch)
    moved = max(float((p - start[n]).abs().max()) for n, p in state.model.named_parameters())
    assert moved < LR / 2, f"the replay moved a parameter by {moved}: the old rate"
    _hold_step(state, eagers, met["loss"], start, lr=LR / 10)


def pytest_captured_dropout_draws_new_masks_each_replay(card):
    rate = 0.25
    gen = torch.Generator(device=card).manual_seed(0)
    programs = ProgramSet(card, generator=gen)
    x = torch.rand((4096, 6), device=card) + 0.5
    prog = programs.program("dropout", lambda t: attention_dropout(t, rate, gen))
    masks = [prog(x) != 0 for _ in range(3)]
    sigma = float(np.sqrt(rate * (1 - rate) / x.numel()))
    for i, m in enumerate(masks):
        share = float(m.double().mean())
        assert abs(share - (1 - rate)) <= 3 * sigma, share
        if i:
            assert not torch.equal(m, masks[i - 1])
    y = prog(x)
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    # the whole GAT step with its dropout, captured: replays differ from each other
    trainer, state, batch = _setup("GAT", card)
    state.model.set_dropout(rate)
    trainer.release()
    snap = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = []
    for _ in range(2):
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(snap[n])
        state, met = trainer.train_step(state, batch)
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def pytest_launch_counts_after_replays_are_the_capture_delta(card):
    trainer, state, batch = _setup("PNA", card, aggregation="fused")
    twin, tstate = _eager_twin(trainer, state)
    ops.reset_launch_counts()
    _eager_step(twin, tstate, batch)  # one eager step's launches
    eager = ops.launch_counts()
    trainer.prepare_step(state, batch)
    (entry,) = trainer.programs(state).programs["train_step"].graphs.values()
    assert entry.launches == eager and any(eager.values())
    ops.reset_launch_counts()
    for _ in range(5):
        state, _ = trainer.train_step(state, batch)
    assert ops.launch_counts() == {k: 5 * v for k, v in eager.items()}


def pytest_bridge_round_trip_of_a_replayed_trainer(card):
    trainer, state, batch = _setup("PNA", card)
    for _ in range(3):
        state, _ = trainer.train_step(state, batch)
    opt_state = optax_state_of(state.optimizer, state.model)
    assert int(opt_state["count"]) == 3
    np.testing.assert_allclose(float(opt_state["hyperparams"]["learning_rate"]), LR, rtol=1e-7)
    # into a CPU copy
    cpu_model = create_model_config(_arch("PNA", 32, 2, 20), device="cpu", aggregation="segment")
    load_flax_variables(cpu_model, flax_variables_of(state.model))
    cpu_trainer = Trainer(cpu_model, ADAMW)
    cpu_state = cpu_trainer.init_state(batch)
    load_optax_adam_state(cpu_state.optimizer, opt_state)
    for (n, p), q in zip(state.model.named_parameters(), cpu_model.parameters()):
        assert torch.equal(p.detach().cpu(), q.detach()), n
    assert all(float(s["step"]) == 3.0 for s in cpu_state.optimizer.state.values())
    # back into the card's optimizer in place: the captured step still holds it
    held = [s["exp_avg"].data_ptr() for s in state.optimizer.state.values()]
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    eagers = _eager_steps(trainer, state, batch)
    with torch.no_grad():  # scramble the moments, then load them back in place
        for s in state.optimizer.state.values():
            s["exp_avg"].mul_(-3.0)
    load_optax_adam_state(state.optimizer, opt_state)
    assert [s["exp_avg"].data_ptr() for s in state.optimizer.state.values()] == held
    assert all(s["step"].device.type == "cuda" for s in state.optimizer.state.values())
    state, met = trainer.train_step(state, batch)
    assert trainer.programs(state).counts()["train_step"]["captures"] == 1
    _hold_step(state, eagers, met["loss"], start)


def _sync_from_another_thread():
    """A device-wide synchronisation on another thread: it breaks a capture
    under way on this one (``capture_error_mode="thread_local"`` included)."""
    def other():
        try:
            torch.cuda.synchronize()
        except RuntimeError:
            pass
    t = threading.Thread(target=other)
    t.start()
    t.join()


def pytest_a_capture_invalidated_from_outside_is_recorded_again(card, monkeypatch):
    clean, clean_state, batch = _setup("PNA", card)
    trainer, state, _ = _setup("PNA", card)
    left = {"n": 1}
    body = steps.eval_body

    def broken_once(model, b):
        out = body(model, b)
        if torch.cuda.is_current_stream_capturing() and left["n"]:
            left["n"] -= 1
            _sync_from_another_thread()
        return out

    before = ops.launch_counts()
    want = clean.eval_step(clean_state, batch)
    clean_launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    monkeypatch.setattr(steps, "eval_body", broken_once)
    invalidated = capture.invalidated_captures()
    before = ops.launch_counts()
    with pytest.warns(RuntimeWarning, match="capture was invalidated"):
        got = trainer.eval_step(state, batch)
    assert capture.invalidated_captures() == invalidated + 1
    assert left["n"] == 0
    # the warm-up and one replay, as a capture that went through the first time
    assert {k: v - before[k] for k, v in ops.launch_counts().items()} == clean_launches
    assert trainer.programs(state).counts()["eval_step"] == {"captures": 1, "replays": 1}
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
    for k in ("loss", "tasks"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    again = trainer.eval_step(state, batch)  # a replay of the graph recorded again
    torch.testing.assert_close(again["loss"], got["loss"], rtol=1e-5, atol=1e-6)


def pytest_two_invalidated_captures_in_a_row_raise(card):
    programs = ProgramSet(card)

    def body(t):
        y = t.sin()
        if torch.cuda.is_current_stream_capturing():
            _sync_from_another_thread()
        return y

    prog = programs.program("always_broken", body)
    x = torch.randn(1024, device=card)
    with pytest.warns(RuntimeWarning, match="capture was invalidated"):
        with pytest.raises(RuntimeError, match="always_broken: 2 captures in a row"):
            prog(x)
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
    # the set captures again afterwards, into its new pool
    ok = programs.program("after", lambda t: t.cos())
    torch.testing.assert_close(ok(x), x.cos())
    programs.release()
