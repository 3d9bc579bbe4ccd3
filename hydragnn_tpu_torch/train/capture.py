"""Captured programs: the port's counterpart of the JAX package's compiled
programs (one ``jax.jit`` executable per shape signature).

A :class:`Program` wraps one Python body. On a CUDA device it keeps one
CUDA graph (``torch.cuda.CUDAGraph``) per shape key, every input tensor's
name, shape and dtype, and replays it: the first call with a new key
captures, every later call refills the graph's input buffers and replays.
On the CPU the same body runs eagerly, with the same key cache and
counters: a "program" there is the body itself. A capture or a replay that
fails raises; nothing runs the body eagerly on the card instead.

The capture recipe, per new key:

1. The inputs go into static buffers: one device byte buffer per key,
   which every call refills (a host batch in one copy from pinned memory,
   a device batch tensor by tensor).
2. Warm-up: the body runs once eagerly on a side stream. That builds every
   kernel (``ops/_build.py`` runs ``nvcc`` at first launch, and K7's
   source sets its shared-memory attribute once per device), creates
   AdamW's lazy state and fills the allocator.
3. For a body that changes the training state, the state is restored in
   place after the warm-up (:class:`ProgramSet` ``snapshot``/``restore``:
   :func:`state_tensors`, that is parameters, BatchNorm statistics,
   optimizer moments and step counts and the rates, and the dropout
   generator's offset), so that the first replay is the eager step 1,
   not step 2.
4. Capture on the side stream into the program set's one memory pool,
   with the set's generator registered with the graph (GAT's dropout).
   The tensors a graph writes and keeps beyond one replay (its outputs,
   the parameters' gradients) are held with the graph, so that no later
   capture in the shared pool takes their memory. A capture that CUDA
   invalidates from outside the body (another thread's device-wide
   synchronisation does that) is recorded once more, into a new pool
   (:meth:`Program._record`).

A replay copies its outputs out (a clone of each), so that the next
replay cannot overwrite what a caller holds.

A program of ``kind="tail"`` is bookkeeping between the steps of a run
(the chunk's epoch head and tail, ``steps.CapturedSteps.fit_dispatch``):
it runs no training step and no forward, and writes the state in place
with the buffers it is bound to (the epoch-start snapshot, the best state,
the schedulers' state and the series), all of which its capture's warm-up
restores.

:func:`state_tensors` lists the training state in one fixed order
(parameters, buffers, the optimizer's per-parameter tensors, the rates
held as tensors): what a capture's warm-up restores, a chunk snapshots
and selects and the divergence guard copies, always in place, since a captured graph reads these very
tensors and a tensor rebound in Python would leave it reading stale
memory.

Telemetry (``obs/``): a program marked by ``obs.introspect.instrument``
records each novel shape key once (``Program.records``: the warm-up's
FLOPs under ``FlopCounterMode``, the argument, output and peak bytes, the
capture's seconds; on the CPU, at its first run, the bytes); every capture adds
its seconds to the run's compile signal (``obs.runtime.note_compile``, a
kernel source's first-launch build in its warm-up included); and while a pass is timed (``ProgramSet.timer``, an
``obs.runtime.StepTimer``) each training program marks its input copy and
replay with a pair of CUDA events.

Launch accounting (``ops.launch_counts``): a capture records the kernel
wrappers' launch counts of its capture pass and takes them back off (the
capture launched nothing); each replay adds them again. The warm-up's
launches are real and stay counted; :func:`capture_counts` tallies the
step and forward bodies that warm-ups ran, beside captures and replays,
process-wide as the launch counts are.
"""

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import record_function
from torch.utils._pytree import tree_leaves, tree_map

from hydragnn_tpu_torch import ops
from hydragnn_tpu_torch.graph.batch import GraphBatch, stage_bytes, unstage_bytes
from hydragnn_tpu_torch.obs import introspect
from hydragnn_tpu_torch.obs import runtime as obs_runtime

# process-wide, as ops.launch_counts(): graphs captured, replays, and the
# training-step and forward bodies that capture warm-ups ran on the card
_TALLY = {"captures": 0, "replays": 0, "warm_steps": 0, "warm_forwards": 0}

# a capture recorded at most this many times in a row (Program._record)
CAPTURE_ATTEMPTS = 2

# the graphs of invalidated captures, kept alive: the allocator's routing of
# the capture's allocations into the pool may still refer to its graph
_FAILED_GRAPHS: list = []


def capture_counts() -> Dict[str, int]:
    """``{"captures", "replays", "warm_steps", "warm_forwards"}`` so far."""
    return dict(_TALLY)


def invalidated_captures() -> int:
    """Captures that CUDA invalidated in this process, each recorded again
    (:meth:`Program._record`); never reset."""
    return len(_FAILED_GRAPHS)


def _take_back(before: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches since ``before``, taken back off the counts."""
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    ops.add_launches({k: -v for k, v in launches.items()})
    return launches


def _invalidated(error: BaseException) -> bool:
    """``error`` and every error it was raised while handling are
    ``cudaErrorStreamCaptureInvalidated``: the capture was broken from
    outside, and neither the body nor anything else failed on its own."""
    while error is not None:
        text = str(error)
        if not ("cudaErrorStreamCaptureInvalidated" in text
                or "operation failed due to a previous error during capture" in text):
            return False
        error = error.__cause__ or error.__context__
    return True


def _end_pool_routing(owner: "ProgramSet"):
    """Stop routing allocations into ``owner``'s pool after a capture whose
    end failed: its ``capture_end`` raised before it stopped the routing (a
    no-op where none is left)."""
    try:
        torch._C._cuda_endAllocateToPool(owner.device.index, owner.pool)
    except RuntimeError:
        pass


def reset_capture_counts():
    for key in _TALLY:
        _TALLY[key] = 0


def state_tensors(model, optimizer=None, strict: bool = True) -> List[torch.Tensor]:
    """The training state, in a fixed order: every parameter, every
    buffer, each parameter's optimizer tensors (by key: moments and step
    count) and each param group's rate where it is a tensor (shared
    tensors once). Two models of one architecture with optimizers of one
    kind give lists that align tensor for tensor. The optimizer's state
    must exist (``optimizer.ensure_optimizer_state``); ``strict=False``
    skips the parameters that have none yet."""
    out = [p for p in model.parameters()] + [b for b in model.buffers()]
    if optimizer is None:
        return out
    for p in model.parameters():
        per = optimizer.state.get(p)
        if per is None:
            if strict:
                raise ValueError("the optimizer has no state for a parameter yet")
            continue
        out += [per[k] for k in sorted(per) if torch.is_tensor(per[k])]
    return out + rate_tensors(optimizer)


def rate_tensors(optimizer) -> List[torch.Tensor]:
    """The param groups' rates held as tensors, each shared one once: the
    tail of :func:`state_tensors`."""
    out = []
    for group in optimizer.param_groups:
        lr = group["lr"]
        if torch.is_tensor(lr) and all(lr is not t for t in out):
            out.append(lr)
    return out


def copy_state(dst: List[torch.Tensor], src: List[torch.Tensor]):
    """``dst[i] <- src[i]`` in place (one multi-tensor copy)."""
    with torch.no_grad():
        torch._foreach_copy_(dst, src)


def _flatten(args):
    """``(leaves, rebuild)``: the tensors of ``args`` (``GraphBatch``es and
    tensors) in order, and the function that rebuilds ``args`` from such
    a list."""
    leaves, parts = [], []
    for a in args:
        if isinstance(a, GraphBatch):
            _, ts = a.leaves()
            parts.append((a, len(ts)))
            leaves += ts
        else:
            parts.append((None, 1))
            leaves.append(a)

    def rebuild(tensors):
        out, i = [], 0
        for template, n in parts:
            out.append(tensors[i] if template is None else template.from_leaves(tensors[i : i + n]))
            i += n
        return tuple(out)

    return leaves, rebuild


def shape_key(args):
    """Every input tensor's name, shape and dtype (``extras`` included)."""
    key = []
    for a in args:
        if isinstance(a, GraphBatch):
            key.append(a.shape_key())
        else:
            key.append((tuple(a.shape), a.dtype))
    return tuple(key)


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    static: List[torch.Tensor]  # the input leaves, views of ``buffer``
    buffer: Optional[torch.Tensor]
    out: object  # the body's outputs as captured
    launches: Dict[str, int]  # kernel launches of one replay
    keep: list  # tensors the graph writes and keeps beyond a replay

    def stage(self, leaves):
        """The host work of a refill: host ``leaves`` packed into one pinned
        buffer (None for device leaves, which copy as they are)."""
        if self.buffer is not None and all(t.device.type == "cpu" for t in leaves):
            return stage_bytes(leaves, pin_memory=True)[0]  # the key fixed the layout
        return None

    def fill(self, leaves, host=None):
        """Refill the static inputs from ``leaves`` (same shapes), from
        :meth:`stage`'s ``host`` buffer where there is one."""
        if host is not None:
            self.buffer.copy_(host, non_blocking=True)
            return
        for s, t in zip(self.static, leaves):
            s.copy_(t, non_blocking=True)


KINDS = ("step", "forward", "tail")


class Program:
    """One body, one captured graph per shape key (see the module's
    docstring). ``bodies``: how many training steps (``kind="step"``) or
    forwards (``kind="forward"``) one call runs (``kind="tail"``: none,
    bookkeeping between them); ``mutates``: the body
    changes the training state, which capture then restores after its
    warm-up. ``bound=True``: the inputs are device tensors the graph
    reads in place (a staged stack, its cursor and its result buffers),
    not copied into static buffers: the key then holds their addresses,
    the graph keeps them alive, and it may write the tensor arguments
    (not a ``GraphBatch``)."""

    def __init__(self, owner: "ProgramSet", name: str, body: Callable, kind: str,
                 mutates: bool, bodies: Callable = lambda args: 1, bound: bool = False):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        self.owner, self.name, self.body = owner, name, body
        self.kind, self.mutates, self.bodies, self.bound = kind, mutates, bodies, bound
        self.graphs: Dict[tuple, object] = {}  # key -> _Graph (CPU: None)
        self.captures = 0
        self.replays = 0
        # introspection (obs/introspect.instrument): the records by bucket
        # label, and the CPU keys prepared before their first call
        self.instrumented = False
        self.records: Dict[str, dict] = {}
        self._unrecorded = set()

    def key(self, args):
        key = shape_key(args)
        if self.bound:
            key += tuple(t.data_ptr() for t in _flatten(args)[0])
        return key

    def __call__(self, *args):
        key = self.key(args)
        novel = key not in self.graphs
        if self.owner.device.type != "cuda":
            if novel:
                self.graphs[key] = None
                self._count_capture()
            timer = self.owner.timer if self.kind == "step" else None
            mark = None if timer is None else timer.start()
            if (novel or key in self._unrecorded) and introspect.wants(self):
                self._unrecorded.discard(key)
                out = self._run_accounted(args)
            else:
                out = self.body(*args)
            if timer is not None:
                timer.stop(mark, self.bodies(args))
            return out
        leaves, _ = _flatten(args)
        if any(t.device.type == "cuda" and t.device != self.owner.device for t in leaves):
            raise RuntimeError(f"{self.name}: inputs on another device than {self.owner.device}")
        entry = self._capture(args) if novel else self.graphs[key]
        host = None
        if novel:
            self.graphs[key] = entry
        elif not self.bound:
            host = entry.stage(leaves)
        # a training step's device time: the refill's copy and the replay,
        # not the host's packing before them nor a capture (obs/runtime.py)
        timer = self.owner.timer if self.kind == "step" else None
        mark = None if timer is None else timer.start()
        if not novel and not self.bound:
            entry.fill(leaves, host)
        with record_function(f"replay.{self.name}"):
            entry.graph.replay()
        if timer is not None:
            timer.stop(mark, self.bodies(args))
        ops.add_launches(entry.launches)
        self.replays += 1
        _TALLY["replays"] += 1
        return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, entry.out)

    def prepare(self, *args):
        """Capture the graph for ``args``' key, if new, without replaying
        it: the state is as before the call."""
        key = self.key(args)
        if key in self.graphs:
            return
        if self.owner.device.type != "cuda":
            self.graphs[key] = None
            self._count_capture()
            if introspect.wants(self):
                if self.instrumented == "always" and not self.mutates:
                    self._run_accounted(args)  # a forward that bills its FLOPs
                else:  # accounted at its first call
                    self._unrecorded.add(key)
            return
        self.graphs[key] = self._capture(args)

    def _probe(self, args, leaves):
        """An introspection probe for a capture of ``args`` when this
        program is accounted and the shape key has no record yet."""
        if not introspect.wants(self):
            return None
        sig = introspect.signature_key(args)
        if introspect.bucket_label(self.name, sig) in self.records:
            return None
        return introspect.Probe(self, sig, leaves, self.owner.device)

    def _run_accounted(self, args):
        """The CPU's run of a novel key: no capture, so no warm-up to count;
        its record holds the bytes, and the FLOPs only where the program
        bills them (``instrument(always=True)``: the server's forward)."""
        probe = self._probe(args, _flatten(args)[0])
        if probe is None:
            return self.body(*args)
        with probe.counting() if self.instrumented == "always" else contextlib.nullcontext():
            out = self.body(*args)
        probe.finish(out)
        return out

    def _count_capture(self):
        self.captures += 1
        _TALLY["captures"] += 1

    def _capture(self, args) -> _Graph:
        owner = self.owner
        leaves, rebuild = _flatten(args)
        if self.bound:
            buffer, static = None, list(leaves)
        else:
            host, spans = stage_bytes([t.detach().cpu() for t in leaves])
            buffer = host.to(owner.device)
            static = unstage_bytes(buffer, spans)
        static_args = rebuild(static)
        probe = self._probe(args, static)
        counting = probe.counting() if probe is not None else contextlib.nullcontext()
        t0 = time.perf_counter()
        with probe.measure() if probe is not None else contextlib.nullcontext():
            snap = owner.snapshot() if self.mutates else None
            # a bound program's tensor arguments (a cursor, result rows) are
            # the graph's to write: the warm-up's writes to them are undone too
            written = ([(t, t.detach().clone()) for t in args if torch.is_tensor(t)]
                       if self.bound else [])
            stream = owner.stream
            stream.wait_stream(torch.cuda.current_stream(owner.device))
            with torch.cuda.stream(stream):
                with counting:
                    self.body(*static_args)  # warm-up: builds kernels, lazy state
                if snap is not None:
                    owner.restore(snap)
                with torch.no_grad():  # a tail's arguments include the parameters
                    for t, before in written:
                        t.copy_(before)
            torch.cuda.current_stream(owner.device).wait_stream(stream)
            if self.kind != "tail":
                _TALLY["warm_steps" if self.kind == "step" else "warm_forwards"] += self.bodies(args)
            graph, out, launches = self._record(static_args, stream)
        self._count_capture()
        # the run's compile signal: the capture's seconds, the kernels'
        # first-launch builds in the warm-up included
        obs_runtime.note_compile(time.perf_counter() - t0)
        if probe is not None:
            probe.finish(out)
        keep = [t for t in tree_leaves(out) if torch.is_tensor(t)] + owner.persistent()
        if self.bound:
            keep += static
        return _Graph(graph, static, buffer, out, launches, keep)

    def _record(self, static_args, stream):
        """``(graph, out, launches)``: the body captured on ``stream`` into
        a new graph in the set's pool, and the kernel launches of the
        capture pass (taken back off the counts: a capture launches
        nothing).

        A capture that CUDA invalidated from outside the body (another
        thread's device-wide synchronisation does that) fails with
        ``cudaErrorStreamCaptureInvalidated`` at the body's next launch or
        at the capture's end; it is recorded once more into a new graph, and
        a second such failure raises. An error of the body's own (an
        operation a capture does not permit, anything else) is never
        retried."""
        owner = self.owner
        current = torch.cuda.current_stream(owner.device)
        try:
            for attempt in range(CAPTURE_ATTEMPTS):
                graph = torch.cuda.CUDAGraph()
                if owner.generator is not None:
                    graph.register_generator_state(owner.generator)
                before = ops.launch_counts()
                try:
                    with torch.cuda.graph(graph, pool=owner.pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        out = self.body(*static_args)
                    return graph, out, _take_back(before)
                except RuntimeError as e:
                    _take_back(before)
                    if not _invalidated(e):
                        raise
                    _end_pool_routing(owner)
                    # the allocator still counts the failed capture as
                    # recording to its pool, which then takes no other
                    # capture: the set's later captures go to a new pool
                    owner.pool = torch.cuda.graph_pool_handle()
                    _FAILED_GRAPHS.append(graph)
                    if attempt + 1 == CAPTURE_ATTEMPTS:
                        raise RuntimeError(f"{self.name}: {CAPTURE_ATTEMPTS} captures in a row "
                                           f"were invalidated: {e}") from e
                    threads = [t.name for t in threading.enumerate()]
                    warnings.warn(f"{self.name}: the capture was invalidated ({e}; the "
                                  f"process's threads {threads}); capturing again",
                                  RuntimeWarning, stacklevel=3)
        finally:
            # a failed capture_end leaves the capture's stream current
            torch.cuda.set_stream(current)


class ProgramSet:
    """The programs of one owner (a ``Trainer`` bound to one model and
    optimizer, or a server's model version) on one device: one memory pool,
    one side stream for warm-ups and captures, and the state a mutating
    body restores after its warm-up. ``release()`` frees every graph."""

    def __init__(self, device, model=None, optimizer=None, generator=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.programs: Dict[str, Program] = {}
        # an obs.runtime.StepTimer while a pass is timed: each training
        # step's replay is marked with a pair of CUDA events
        self.timer = None
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        else:
            self.pool = self.stream = None

    def program(self, name: str, body: Callable, kind: str = "forward", mutates: bool = False,
                bodies: Callable = lambda args: 1, bound: bool = False) -> Program:
        prog = self.programs.get(name)
        if prog is None:
            prog = self.programs[name] = Program(self, name, body, kind, mutates, bodies, bound)
        return prog

    def counts(self) -> Dict[str, Dict[str, int]]:
        """``{program: {"captures", "replays"}}``."""
        return {name: {"captures": p.captures, "replays": p.replays}
                for name, p in self.programs.items()}

    def release(self):
        """Drop every captured graph (and the memory they hold)."""
        for prog in self.programs.values():
            prog.graphs.clear()
        self.programs.clear()

    # ---- the training state a mutating body changes ----------------------

    def persistent(self) -> list:
        """Tensors a training graph writes and keeps beyond one replay:
        the parameters' gradients."""
        if self.model is None:
            return []
        return [p.grad for p in self.model.parameters() if p.grad is not None]

    def snapshot(self):
        """A copy of the training state (:func:`state_tensors`, over the
        optimizer state that exists) and of the generator state."""
        tensors = state_tensors(self.model, self.optimizer, strict=False)
        with torch.no_grad():
            copies = [t.detach().clone() for t in tensors]
        gen = None if self.generator is None else self.generator.get_state()
        return tensors, copies, gen

    def restore(self, snap):
        """Put ``snap`` back in place. Optimizer state created since (a
        fresh optimizer's lazy moments and step) goes back to zero, as it
        was before its first step."""
        tensors, copies, gen = snap
        copy_state(tensors, copies)
        if self.optimizer is not None:
            known = {id(t) for t in tensors}
            with torch.no_grad():
                for st in self.optimizer.state.values():
                    for v in st.values():
                        if torch.is_tensor(v) and id(v) not in known:
                            v.zero_()
        if gen is not None:
            self.generator.set_state(gen)
