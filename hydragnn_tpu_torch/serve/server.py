"""The in-process predict server: micro-batched, bucketed inference on the
card (port of ``serve/server.py``).

Request lifecycle::

    submit(graph) --admission--> bounded queue --batcher thread-->
      group by (model version, bucket) --max-wait / budget-full flush-->
        pack into the bucket's static pads on the host -->
          one transfer into the bucket's captured forward, a replay -->
            outputs back in one copy, split per request --> future resolves

- **One program per (model version, bucket)**: ``warmup`` captures the
  forward of every registered version at every bucket's pads as a CUDA
  graph (``train/capture.py``; on the CPU the forward runs eagerly), and
  every batch replays its bucket's graph. ``metrics.compiles_total``
  counts the novel (version, shape) keys: the buckets at warmup, none
  after, unless a shape leaked past the plan. :meth:`InferenceServer.
  warm_version` warms a newly registered version through the running
  batcher and verifies that its second pass compiled nothing. ``stop``
  frees the graphs.

- **Micro-batching trades a bounded wait for throughput**: requests wait at
  most ``max_wait_s`` for co-riders; a full budget flushes at once.
- **Graceful degradation**: a full queue sheds new work at submit time with
  a retry-after hint; expired deadlines resolve with
  :class:`DeadlineExceeded` before a dispatch; graphs denser than their
  node-natural bucket fall through to the next larger one.
- **Failure isolation**: a dispatch error fails only that batch's
  requests; the batcher thread keeps serving.

One batcher thread uses the device. Tenants, the response cache, cost
accounting, uncertainty scoring, tracing and the HTTP endpoint are not
ported (see ``ROADMAP.md``).
"""

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.serve.buckets import ServingBucketPlan
from hydragnn_tpu_torch.serve.metrics import ServeMetrics
from hydragnn_tpu_torch.serve.registry import ModelEntry, ModelRegistry
from hydragnn_tpu_torch.train.capture import ProgramSet
from hydragnn_tpu_torch.utils.device import resolve_device


class ServerOverloaded(RuntimeError):
    """Queue full — the request was shed, retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"predict queue full; retry after {retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before its batch dispatched."""


class ServeFuture:
    """Minimal future resolved by the batcher thread.

    ``version`` and ``batch_seq`` are stamped by the dispatching batch just
    before the result lands: which model version computed the answer and
    which micro-batch carried it. ``done_at`` is the monotonic time of the
    resolution."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None
        self.version: Optional[int] = None
        self.model_name: Optional[str] = None
        self.batch_seq: Optional[int] = None
        self.done_at: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, result, error) -> bool:
        # first resolution wins: a shutdown sweep racing a completed
        # dispatch must not overwrite a result with an error
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._error = error
            self.done_at = time.monotonic()
            self._event.set()
        return True

    def set_result(self, result) -> bool:
        return self._resolve(result, None)

    def set_exception(self, error: BaseException) -> bool:
        return self._resolve(None, error)

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not ready")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("graph", "entry", "bucket", "sizes", "future", "enqueued_at",
                 "deadline", "fallback")

    def __init__(self, graph, entry, bucket, sizes, deadline, fallback):
        self.graph = graph
        self.entry = entry
        self.bucket = bucket
        self.sizes = sizes  # (nodes, edges, triplets)
        self.future = ServeFuture()
        self.enqueued_at = time.monotonic()
        self.deadline = deadline  # absolute monotonic time or None
        self.fallback = fallback  # served above its node-natural bucket

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class InferenceServer:
    """Micro-batching predict server over a :class:`ModelRegistry` and a
    :class:`ServingBucketPlan`, on one device.

    ``device``: ``None`` means the card (raises without one); ``"cpu"``
    runs the plain PyTorch versions. Every registered model must live on
    that device. Thread-safe: any number of caller threads ``submit``; one
    batcher thread packs and dispatches."""

    def __init__(
        self,
        registry: ModelRegistry,
        plan: ServingBucketPlan,
        default_model: Optional[str] = None,
        max_wait_s: float = 0.005,
        queue_capacity: int = 256,
        default_deadline_s: Optional[float] = None,
        metrics: Optional[ServeMetrics] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.registry = registry
        self.plan = plan
        self.default_model = default_model
        self.max_wait_s = float(max_wait_s)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_s = default_deadline_s
        self.metrics = metrics or ServeMetrics()
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=self.queue_capacity)
        # mutated only by the batcher thread; the lock covers the cross-
        # thread reads (_depth from submitters, the sweep in stop)
        self._pending_lock = threading.Lock()
        self._pending: Dict[Tuple[str, int, int], List[_Request]] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._batch_seq = 0  # mutated only by the dispatching thread
        # guards the stopped-check + enqueue pair in submit() against stop()
        self._submit_lock = threading.Lock()
        self._stopped = False
        self._programs: Optional[ProgramSet] = None  # one forward per model version

    # ---- lifecycle -----------------------------------------------------
    def start(self, warmup: bool = True):
        """Warm every (registered model, bucket) once, then start the
        batcher thread."""
        if self._running.is_set():
            return self
        with self._submit_lock:
            self._stopped = False
        if warmup:
            self.warmup()
        self._running.set()
        # daemon=True is only the crashed-caller backstop: the orderly path
        # is stop(), which drains, joins with a timeout and fails the rest
        thread = threading.Thread(
            target=self._batcher_loop, name="hydragnn-torch-serve-batcher", daemon=True
        )
        thread.start()
        with self._submit_lock:
            self._thread = thread
        return self

    def stop(self, drain: bool = True, timeout: float = 10.0):
        """Stop the batcher; ``drain=True`` serves already-queued work
        first, otherwise queued requests fail with a shutdown error.
        Idempotent."""
        with self._submit_lock:
            already_stopped = self._stopped
            self._stopped = True
            thread, self._thread = self._thread, None
        if already_stopped and thread is None:
            return
        if self._running.is_set():
            if drain:
                deadline = time.monotonic() + timeout
                while self._depth() and time.monotonic() < deadline:
                    time.sleep(0.005)
            self._running.clear()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                with self._submit_lock:
                    self._thread = thread
        stranded: List[_Request] = []
        while True:
            try:
                stranded.append(self._queue.get_nowait())
            except queue.Empty:
                break
        with self._pending_lock:
            for group in self._pending.values():
                stranded.extend(group)
            self._pending.clear()
        failed = sum(
            req.future.set_exception(RuntimeError("server stopped")) for req in stranded
        )
        if failed:
            self.metrics.on_error(failed)
        if thread is None or not thread.is_alive():
            self._release()

    def _release(self):
        """Free every captured forward (a later start captures again)."""
        if self._programs is not None:
            self._programs.release()
            self._programs = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- warmup --------------------------------------------------------
    def warmup(self):
        """Capture every (registered model version, bucket) forward before
        traffic, on the plan's warmup sample packed at each bucket's pads
        (one eager forward each on the card, which builds the kernels,
        then the capture). After this, any request the plan admits
        replays a captured graph."""
        for name in self.registry.names():
            self.warmup_entry(self.registry.get(name))

    def warmup_entry(self, entry: ModelEntry):
        """Capture one model version at every bucket, directly (the
        batcher is not running yet); a running server warms a new version
        with :meth:`warm_version`."""
        sample = self._warmup_sample()
        for b in range(self.plan.num_buckets):
            batch, _ = self.plan.pack([sample], b)
            self._compiled(entry, batch, run=False)

    def _warmup_sample(self):
        sample = self.plan.warmup_sample
        if sample is None:
            raise ValueError(
                "plan has no warmup_sample; pass one (a small GraphData) or "
                "build the plan via plan_from_samples"
            )
        return sample

    def warm_version(self, name: str, version: Optional[int] = None, timeout: float = 120.0,
                     passes: int = 2) -> Dict[str, int]:
        """Warm a (newly registered) model version through the running
        batcher: one warmup request pinned to each bucket per pass,
        between live traffic. Returns the passes' compile counts: pass 1
        must compile ``num_buckets`` novel shapes, every later pass none
        (``verified``); a later compile means the version's programs did
        not stay captured."""
        if not self._running.is_set():
            raise RuntimeError(
                "warm_version needs a running batcher; call start() first "
                "(startup warmup uses warmup_entry directly)"
            )
        entry = self.registry.get(name, version)
        sample = self._warmup_sample()
        deltas: List[int] = []
        for _ in range(max(int(passes), 1)):
            before = self.metrics.compiles_total
            futures = [self._submit_pinned(sample, entry, b) for b in range(self.plan.num_buckets)]
            for fut in futures:
                fut.result(timeout)  # a dispatch error propagates
            deltas.append(self.metrics.compiles_total - before)
        return {
            "buckets": self.plan.num_buckets,
            "first_pass_compiles": deltas[0],
            "later_pass_compiles": sum(deltas[1:]),
            "verified": deltas[0] == self.plan.num_buckets and sum(deltas[1:]) == 0,
        }

    def _submit_pinned(self, graph, entry: ModelEntry, bucket: int) -> ServeFuture:
        """Enqueue one request pinned to ``(entry, bucket)`` (the
        warm-version path), counted like any other request."""
        sizes = self.plan.request_sizes(graph)
        req = _Request(graph, entry, bucket, sizes, None, fallback=False)
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("server stopped; submits are refused")
            self._queue.put_nowait(req)  # queue.Full propagates: a warm must not vanish
        self.metrics.on_submit()
        return req.future

    # ---- submission ----------------------------------------------------
    def submit(self, graph: GraphData, model: Optional[str] = None,
               deadline_s: Optional[float] = None) -> ServeFuture:
        """Enqueue one graph; returns a future resolving to a list of
        per-head numpy outputs (graph head ``[dim]``, node head
        ``[num_nodes, dim]``). Raises :class:`ServerOverloaded` when the
        queue is full and :class:`GraphTooLarge` when no bucket admits the
        graph, both before queueing."""
        name = model or self.default_model
        if name is None:
            names = self.registry.names()
            if len(names) != 1:
                raise ValueError(
                    "no model= given and no default_model set with "
                    f"{len(names)} models registered"
                )
            name = names[0]
        entry = self.registry.get(name)
        bucket, sizes = self.plan.admit(graph)  # GraphTooLarge propagates
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        req = _Request(
            graph, entry, bucket, sizes, deadline,
            fallback=bucket > self.plan.natural_bucket(graph.num_nodes),
        )
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("server stopped; submits are refused")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.metrics.on_shed()
                raise ServerOverloaded(retry_after_s=max(self.max_wait_s, 0.001))
        self.metrics.on_submit()
        self.metrics.set_queue_depth(self._depth())
        return req.future

    def predict(self, graph: GraphData, model: Optional[str] = None,
                timeout: Optional[float] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(graph, model=model, deadline_s=timeout).result(timeout)

    def _depth(self) -> int:
        with self._pending_lock:
            pending = sum(len(g) for g in self._pending.values())
        return self._queue.qsize() + pending

    # ---- batcher -------------------------------------------------------
    def _batcher_loop(self):
        tick = max(self.max_wait_s / 4, 0.0005)
        while self._running.is_set():
            try:
                req = self._queue.get(timeout=tick)
            except queue.Empty:
                req = None
            if req is not None:
                self._admit_pending(req)
                # greedy drain: one wakeup packs the whole burst
                while True:
                    try:
                        more = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    self._admit_pending(more)
            self._flush_due()
            self.metrics.set_queue_depth(self._depth())
        # shutdown flush: stop(drain=True) never strands accepted work
        with self._pending_lock:
            keys = list(self._pending)
        for key in keys:
            self._flush_group(key)

    def _admit_pending(self, req: _Request):
        key = (req.entry.name, req.entry.version, req.bucket)
        with self._pending_lock:
            self._pending.setdefault(key, []).append(req)

    def _flush_due(self):
        now = time.monotonic()
        with self._pending_lock:
            keys = list(self._pending)
        for key in keys:
            with self._pending_lock:
                group = self._pending.get(key)
            if not group:
                with self._pending_lock:
                    self._pending.pop(key, None)
                continue
            if self._group_full(key, group) or now - group[0].enqueued_at >= self.max_wait_s:
                self._flush_group(key)

    def _group_full(self, key, group) -> bool:
        """Full = adding the last request's sizes again would overflow the
        bucket (exact for same-size streams; at worst one early flush)."""
        n = sum(r.sizes[0] for r in group)
        e = sum(r.sizes[1] for r in group)
        t = sum(r.sizes[2] for r in group)
        return not self.plan.fits_batch(key[2], n, e, len(group), group[-1].sizes, acc_trips=t)

    def _flush_group(self, key) -> int:
        """Dispatch one pending group as one or more full batches; returns
        how many requests went to the device."""
        with self._pending_lock:
            group = self._pending.pop(key, None)
        if not group:
            return 0
        now = time.monotonic()
        live: List[_Request] = []
        expired = 0
        for req in group:
            if req.expired(now):
                req.future.set_exception(DeadlineExceeded(
                    f"deadline expired after {now - req.enqueued_at:.3f}s in queue"
                ))
                expired += 1
            else:
                live.append(req)
        if expired:
            self.metrics.on_timeout(expired)
        bucket = key[2]
        served = len(live)
        while live:
            take: List[_Request] = []
            n = e = t = 0
            for req in live:
                if take and not self.plan.fits_batch(bucket, n, e, len(take), req.sizes,
                                                     acc_trips=t):
                    break
                take.append(req)
                n += req.sizes[0]
                e += req.sizes[1]
                t += req.sizes[2]
            live = live[len(take):]
            self._dispatch_batch(take, bucket, real_nodes=n)
        return served

    def _dispatch_batch(self, requests: List[_Request], bucket: int, real_nodes: int):
        entry = requests[0].entry
        t0 = time.monotonic()
        try:
            batch, coords = self.plan.pack([r.graph for r in requests], bucket)
            outputs = self._forward(entry, batch)
        except Exception as e:  # fail the batch, keep the server alive
            self.metrics.on_error(len(requests))
            for req in requests:
                req.future.set_exception(e)
            return
        now = time.monotonic()
        self._batch_seq += 1
        for req, (g, off, n) in zip(requests, coords):
            per_head = [
                outputs[ihead][g] if kind == "graph" else outputs[ihead][off : off + n]
                for ihead, kind in enumerate(entry.output_type)
            ]
            # stamped before resolution: a waiter reads a consistent pair
            req.future.version = entry.version
            req.future.model_name = entry.name
            req.future.batch_seq = self._batch_seq
            req.future.set_result(per_head)
            self.metrics.on_response_latency(now - req.enqueued_at)
            if req.deadline is not None:
                self.metrics.on_deadline(now <= req.deadline)
        self.metrics.on_batch(
            bucket,
            len(requests),
            real_nodes=real_nodes,
            padded_nodes=self.plan.layouts[bucket].n_pad,
            batch_seconds=now - t0,
            fallbacks=sum(1 for r in requests if r.fallback),
        )

    # ---- device dispatch -----------------------------------------------
    def _compiled(self, entry: ModelEntry, batch, run: bool = True):
        """``entry``'s forward program on one host batch: captured, and
        counted in ``compiles_total``, when its (version, shape) key is new;
        replayed with ``run``. Returns the per-head outputs (on the
        device) with ``run``."""
        if entry.device != self.device:
            raise RuntimeError(
                f"model {entry.name!r} v{entry.version} lives on {entry.device}, "
                f"the server on {self.device}"
            )
        if self._programs is None:
            self._programs = ProgramSet(self.device)
        model = entry.model

        def forward(b):
            with torch.inference_mode():
                return [o.to(torch.float32) for o in model(b)]

        prog = self._programs.program(f"serve:{entry.name}:v{entry.version}", forward)
        before = prog.captures
        outputs = prog(batch) if run else prog.prepare(batch)
        if prog.captures != before:
            self.metrics.on_compile()
        return outputs

    def _forward(self, entry: ModelEntry, batch) -> List[np.ndarray]:
        """Run ``entry``'s model on one host batch through its captured
        forward: one transfer in, a replay, one copy of every head's
        output back. Returns the per-head outputs as numpy arrays."""
        outputs = self._compiled(entry, batch)
        host = torch.cat([o.reshape(-1) for o in outputs]).cpu().numpy()
        out, off = [], 0
        for o in outputs:
            out.append(host[off : off + o.numel()].reshape(tuple(o.shape)))
            off += o.numel()
        return out
