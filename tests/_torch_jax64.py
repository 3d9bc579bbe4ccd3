"""The JAX package's float64 training trajectory: the exact state that a
float32 parity test holds an element to where the port's float32 state and
JAX's part beyond their tolerance (``test_torch_train.hold_final_state``).

:func:`jax_float64` runs the JAX package in float64: ``jax.enable_x64``,
and the float32 casts of its shared layers, its dense branch's gathers,
its segment sums and GAT's attention product read as float64.

A ReLU input within float32's rounding of zero may take either side of
the kink in a float32 run, and then the exact step's derivative is either
one-sided value. :func:`trajectories` gives two float64 trajectories of
the JAX package's own step from the same start, each step on the side of
the kinks that one float32 run took within float32's reach
(``chip_smoke.kink_flips``): the port's side (``exact``, the state the
port's float32 run is held to) and JAX's side (``own``, the state JAX's
float32 distance, the rule's level, is read from). The reach at a step is
read from the *other* framework's float32 forward at that step's float64
state, so no float32 run is its own witness. :class:`_Relus` stands in for
the JAX model's ReLU activations, in call order (``jax.nn.relu``, which
the stacks' and heads' activations read), as ``chip_smoke.KinkReLUs`` does
for the port's (its ``act`` modules; neither takes GIN's MLP's inner ReLU);
the two orders are asserted equal by shape.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hydragnn_tpu.graph import segment as jsegment
from hydragnn_tpu.models import common as jcommon
from hydragnn_tpu.models import gat as jgat
from hydragnn_tpu.ops import dense_agg as jdense

import chip_smoke

_PLAIN_RELU = jax.nn.relu


class _Jnp64:
    """``jax.numpy``, with ``float32`` meaning ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


_CASTING = (jcommon, jdense, jsegment, jgat)  # the modules that cast to float32 by name


@contextlib.contextmanager
def jax_float64():
    """The JAX package in float64 (the module's doc)."""
    old = [m.jnp for m in _CASTING]
    for m in _CASTING:
        m.jnp = _Jnp64()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m, j in zip(_CASTING, old):
            m.jnp = j


def to64(tree):
    """``tree``'s floating leaves as float64 JAX arrays (inside
    :func:`jax_float64`)."""
    def conv(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if np.issubdtype(a.dtype, np.floating) else a.dtype)
    return jax.tree_util.tree_map(conv, tree)


def to32(tree):
    """``tree``'s floating leaves rounded to float32, as numpy."""
    def conv(a):
        a = np.asarray(a)
        return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a
    return jax.tree_util.tree_map(conv, tree)


@jax.custom_vjp
def _flip_relu(x, flip):
    return jnp.maximum(x, 0)


def _flip_fwd(x, flip):
    return jnp.maximum(x, 0), (x, flip)


def _flip_bwd(res, g):
    x, flip = res
    return g * ((x > 0) ^ flip).astype(g.dtype), None


_flip_relu.defvjp(_flip_fwd, _flip_bwd)


class _Relus:
    """The ReLU activations of the JAX model while a trace is open: records each
    call's input, and with ``flips`` (one bool array a call) takes the
    derivative on the other side of the kink at the set entries."""

    def __init__(self):
        self.inputs, self.flips = None, None

    def __call__(self, x):
        if self.inputs is None:
            return _PLAIN_RELU(x)
        site = len(self.inputs)
        self.inputs.append(x)
        return _PLAIN_RELU(x) if self.flips is None else _flip_relu(x, self.flips[site])

    @contextlib.contextmanager
    def open(self, flips=None):
        old = jax.nn.relu
        jax.nn.relu = self
        self.inputs, self.flips = [], flips
        try:
            yield self.inputs
        finally:
            jax.nn.relu = old
            self.inputs, self.flips = None, None


def _torch64(arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def trajectories(jtrainer, first, host, rng, port_cards, jax_steps, port_inputs, carry=None):
    """``(exact, own, counts)``: the JAX package's float64 trajectories
    (its ``train_step``'s own body) from ``first`` (JAX's start state as
    numpy) on ``host``, ``len(port_cards)`` steps each, with a fresh
    optimizer state, as ``{"params", "batch_stats"}`` numpy trees; and the
    kinks each took on the other side, a step at a time.

    ``port_cards[k]`` is the ReLU inputs (float64 tensors, in call order)
    of step ``k`` of the port's float32 run, ``jax_steps[k]`` the
    variables (numpy) that JAX's float32 run took step ``k`` from;
    ``port_inputs(variables)`` gives the port's float32 ReLU inputs at
    ``variables`` (numpy, float32): the witness of JAX's run.
    ``carry(k, params)``, where given, gives the parameters after step
    ``k`` with what the float32 runs carried in after it."""
    model, body = jtrainer.model, jtrainer._train_step.__wrapped__
    relus = _Relus()

    def forward(variables, batch, r):
        with relus.open() as inputs:
            model.apply(variables, batch, train=True, mutable=["batch_stats"],
                        rngs={"dropout": r})
            return list(inputs)

    def steered(state, batch, r, flips):
        with relus.open(flips):
            return body(state, batch, r)

    record, step = jax.jit(forward), jax.jit(steered)
    variables = lambda s: {"params": s.params, "batch_stats": s.batch_stats}  # noqa: E731
    host32 = jax.tree_util.tree_map(jnp.asarray, host)
    jax_inputs = lambda v: _torch64(record(v, host32, rng))  # noqa: E731

    def run(cards, witness):
        with jax_float64():
            state = to64(first)
            state = state.replace(opt_state=jtrainer.tx.init(state.params))
            host64 = to64(host)
        counts = []
        for k, card in enumerate(cards):
            with jax_float64():
                z64 = _torch64(record(variables(state), host64, rng))
            z32 = witness(to32(jax.tree_util.tree_map(np.asarray, variables(state))))
            shapes = [[tuple(t.shape) for t in z] for z in (z32, z64, card)]
            assert shapes[0] == shapes[1] == shapes[2], shapes
            kinks = chip_smoke.kink_flips(z32, z64, card)
            assert kinks["count"] <= chip_smoke.KINK_FLIPS_MAX, kinks
            flips = [np.asarray(kinks["masks"][i]) if i in kinks["masks"]
                     else np.zeros(tuple(t.shape), bool) for i, t in enumerate(z64)]
            with jax_float64():
                state, _ = step(state, host64, rng, flips)
                if carry is not None:
                    state = state.replace(params=to64(carry(k, state.params)))
            counts.append(kinks["count"])
        return jax.tree_util.tree_map(np.asarray, variables(state)), counts

    exact, port_counts = run(port_cards, jax_inputs)
    own, jax_counts = run([jax_inputs(v) for v in jax_steps], port_inputs)
    return exact, own, {"port": port_counts, "jax": jax_counts}

