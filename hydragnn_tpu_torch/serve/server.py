"""The in-process predict server: micro-batched, bucketed inference on the
card (port of ``serve/server.py``).

Request lifecycle::

    submit(graph) --cache lookup (a hit answers at once)--> tenant quota -->
      bounded queue --batcher thread--> group by (tenant, model version,
        bucket) --max-wait / budget-full flush, tenants in DWRR order-->
          pack into the bucket's static pads on the host -->
            one transfer into the bucket's captured forward, a replay -->
              (the uncertainty scorer's captured K-sample program) -->
                outputs back in one copy, split per request -->
                  cache filled, costs noted --> future resolves

- **One program per (model version, bucket)**: ``warmup`` captures the
  forward of every registered version at every bucket's pads as a CUDA
  graph (``train/capture.py``; on the CPU the forward runs eagerly), and
  every batch replays its bucket's graph. With an uncertainty scorer
  (``serve/quality.py``) each (version or member set, bucket) has a second
  program, captured in the same warmup. ``metrics.compiles_total`` counts
  the novel keys: two per bucket and version with a scorer, one without,
  at warmup, and none after unless a shape leaked past the plan.
  :meth:`InferenceServer.warm_version` warms a newly registered version
  through the running batcher and verifies that its second pass compiled
  nothing. ``stop`` frees the graphs.
- **Tenants** (``serve/tenants.py``): a tenant resolves its model, counts
  against its admission quota (a flood is shed with ``TenantOverQuota``
  before the shared queue), and never shares a micro-batch with another
  tenant; groups that are due flush in deficit-weighted round-robin order.
- **Response cache** (``serve/cache.py``): looked up at submit on the raw
  graph's canonical key and the active version, before the quota (a hit
  uses no quota and no device); filled before the future resolves, with
  copies of the request's arrays; a promote or rollback invalidates the
  model's entries through the registry's activation listener.
- **Costs** (``serve/costs.py``): every batch's host wall from packing to
  readback, and its bucket's matmul FLOPs (counted once per version and
  bucket by ``FlopCounterMode`` over the capture's eager warm-up,
  ``obs/introspect.py``; the hand-written kernels add 0), go to the
  batch's tenant.
- **Tracing** (``obs/trace.py``): a request submitted with ``trace=``
  records ``queue_wait``, ``batch_form``, ``dispatch`` and ``readback``
  (the span starts from one ``time.time()`` read per batch), or
  ``cache_lookup`` for a hit.
- **Observability**: ``observability_port`` (0: an ephemeral port) starts
  ``/healthz`` and ``/metrics`` (``obs/http.py``) with the server; the
  metrics text is the serving series (the JAX package's text), then the
  port's ``scorer_errors_total``, the cost ledger's and the scorer's
  families.
- **Graceful degradation**: a full queue sheds new work at submit time
  with a retry-after hint; expired deadlines resolve with
  :class:`DeadlineExceeded` before a dispatch; graphs denser than their
  node-natural bucket fall through to the next larger one. Scoring is
  advisory: a batch whose scoring program fails is answered unscored, as
  in the JAX package, and counted in ``metrics.scorer_errors``.
- **Failure isolation**: a dispatch error fails only that batch's
  requests; the batcher thread keeps serving.

One batcher thread uses the device.
"""

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.obs import introspect
from hydragnn_tpu_torch.serve.buckets import ServingBucketPlan
from hydragnn_tpu_torch.serve.cache import ResponseCache, canonical_graph_key
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
    which micro-batch carried it. ``uncertainty`` holds the per-head
    variance scalars when the server scores (None for a cache hit, which
    ran no sample). ``done_at`` is the monotonic time of the resolution.
    ``_on_done`` fires once, on the winning resolution, outside the lock:
    the tenant's quota release."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None
        self.version: Optional[int] = None
        self.model_name: Optional[str] = None
        self.batch_seq: Optional[int] = None
        self.uncertainty: Optional[List[float]] = None
        self.done_at: Optional[float] = None
        self._on_done = None

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
        cb, self._on_done = self._on_done, None  # only the winner gets here
        if cb is not None:
            try:
                cb()
            except Exception:
                pass  # bookkeeping never fails a resolution
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
                 "deadline", "fallback", "tenant", "cache_key", "trace")

    def __init__(self, graph, entry, bucket, sizes, deadline, fallback, tenant=None,
                 cache_key=None, trace=None):
        self.graph = graph
        self.entry = entry
        self.bucket = bucket
        self.sizes = sizes  # (nodes, edges, triplets)
        self.future = ServeFuture()
        self.enqueued_at = time.monotonic()
        self.deadline = deadline  # absolute monotonic time or None
        self.fallback = fallback  # served above its node-natural bucket
        self.tenant = tenant  # admission and packing identity (None: untenanted)
        self.cache_key = cache_key  # fill the response cache at dispatch
        self.trace = trace  # a TraceContext or RequestTrace (obs/trace.py), or None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class _Exposition:
    """The ``/metrics`` provider of one server: ``health()`` and
    ``metrics.render_prometheus()`` (``obs/http.py``'s protocol)."""

    def __init__(self, server: "InferenceServer"):
        self.health = server.health
        self.metrics = self
        self._server = server

    def render_prometheus(self) -> str:
        return self._server.render_prometheus()


class InferenceServer:
    """Micro-batching predict server over a :class:`ModelRegistry` and a
    :class:`ServingBucketPlan`, on one device.

    ``device``: ``None`` means the card (raises without one); ``"cpu"``
    runs the plain PyTorch versions. Every registered model, and the
    scorer, must live on that device. ``tenants`` (a ``TenantManager``)
    loads its models into the registry on that device. Thread-safe: any
    number of caller threads ``submit``; one batcher thread packs and
    dispatches."""

    def __init__(
        self,
        registry: ModelRegistry,
        plan: ServingBucketPlan,
        default_model: Optional[str] = None,
        max_wait_s: float = 0.005,
        queue_capacity: int = 256,
        default_deadline_s: Optional[float] = None,
        observability_port: Optional[int] = None,
        metrics: Optional[ServeMetrics] = None,
        tenants=None,
        cache=None,
        costs=None,
        scorer=None,
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
        self.tenants = tenants
        if tenants is not None:
            tenants.load_models(registry, device=self.device)
        self.cache = cache
        if cache is not None:
            if cache.metrics is None:
                cache.metrics = self.metrics
            registry.add_activation_listener(lambda name, version: cache.invalidate(model=name))
        self.costs = costs
        if scorer is not None and scorer.device != self.device:
            raise RuntimeError(f"the scorer runs on {scorer.device}, the server on {self.device}")
        self.scorer = scorer
        # per (model version, bucket): the forward's matmul FLOPs, counted
        # at its capture when a cost ledger bills them
        self._shape_flops: Dict[Tuple, float] = {}
        # per thread, the capture being counted (``.counting``): the batcher and
        # a caller's warm-up may capture at once
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=self.queue_capacity)
        # mutated only by the batcher thread; the lock covers the cross-
        # thread reads (_depth from submitters, the sweep in stop)
        self._pending_lock = threading.Lock()
        self._pending: Dict[Tuple[Optional[str], str, int, int], List[_Request]] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._batch_seq = 0  # mutated only by the dispatching thread
        # guards the stopped-check + enqueue pair in submit() against stop()
        self._submit_lock = threading.Lock()
        self._stopped = False
        self._warm = False
        self._programs: Optional[ProgramSet] = None  # one forward per model version
        self._observability_port = observability_port
        self._http = None

    # ---- lifecycle -----------------------------------------------------
    def start(self, warmup: bool = True):
        """Warm every (registered model, bucket) once, then start the
        batcher thread and, when asked, the observability endpoint."""
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
        http = None
        if self._observability_port is not None:
            from hydragnn_tpu_torch.serve.http import ObservabilityServer

            http = ObservabilityServer(_Exposition(self), port=self._observability_port)
            http.start()
        with self._submit_lock:
            self._thread = thread
            self._http = http
        return self

    def stop(self, drain: bool = True, timeout: float = 10.0):
        """Stop the batcher; ``drain=True`` serves already-queued work
        first, otherwise queued requests fail with a shutdown error.
        Idempotent."""
        with self._submit_lock:
            already_stopped = self._stopped
            self._stopped = True
            thread, self._thread = self._thread, None
            http, self._http = self._http, None
        if already_stopped and thread is None and http is None:
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
        if http is not None:
            http.stop()
        if thread is None or not thread.is_alive():
            self._release()

    def _release(self):
        """Free every captured program (a later start captures again)."""
        if self._programs is not None:
            self._programs.release()
            self._programs = None
        if self.scorer is not None:
            self.scorer.release()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def observability_address(self) -> Optional[Tuple[str, int]]:
        return None if self._http is None else self._http.address

    # ---- warmup --------------------------------------------------------
    def warmup(self):
        """Capture every (registered model version, bucket) program before
        traffic (the forward, and the scorer's), on the plan's warmup
        sample packed at each bucket's pads (one eager run each on the
        card, which builds the kernels, then the capture). After this, any
        request the plan admits replays a captured graph."""
        for name in self.registry.names():
            self.warmup_entry(self.registry.get(name))
        self._warm = True

    def warmup_entry(self, entry: ModelEntry):
        """Capture one model version at every bucket, directly (the
        batcher is not running yet); a running server warms a new version
        with :meth:`warm_version`."""
        sample = self._warmup_sample()
        for b in range(self.plan.num_buckets):
            batch, _ = self.plan.pack([sample], b)
            self._compiled(entry, batch, b, run=False)
            if self.scorer is not None:
                self._scored(entry, batch, run=False)

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
        must compile ``num_buckets`` novel shapes (twice that with a
        scorer), every later pass none (``verified``)."""
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
        per_bucket = 1 if self.scorer is None else 2
        return {
            "buckets": self.plan.num_buckets,
            "first_pass_compiles": deltas[0],
            "later_pass_compiles": sum(deltas[1:]),
            "verified": (deltas[0] == self.plan.num_buckets * per_bucket
                         and sum(deltas[1:]) == 0),
        }

    def warm_tenant(self, tenant: str, timeout: float = 120.0, passes: int = 2) -> Dict[str, int]:
        """:meth:`warm_version` of ``tenant``'s model's active version."""
        if self.tenants is None:
            raise ValueError("server has no TenantManager")
        return self.warm_version(self.tenants.model_for(tenant), timeout=timeout, passes=passes)

    def is_warm(self) -> bool:
        """True once :meth:`warmup` captured every registered version."""
        return self._warm

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
               deadline_s: Optional[float] = None, tenant: Optional[str] = None,
               trace=None) -> ServeFuture:
        """Enqueue one graph; returns a future resolving to a list of
        per-head numpy outputs (graph head ``[dim]``, node head
        ``[num_nodes, dim]``). Raises :class:`ServerOverloaded` when the
        queue is full (or its subclass ``TenantOverQuota`` when
        ``tenant``'s quota is) and :class:`GraphTooLarge` when no bucket
        admits the graph, all before queueing. ``tenant`` resolves the
        model name (with a tenant manager) and counts against its quota;
        a cache hit answers first and uses no quota. ``trace``: a
        ``TraceContext`` or ``RequestTrace`` that records this request's
        spans."""
        name = model or self.default_model
        if tenant is not None:
            if self.tenants is None:
                raise ValueError(f"tenant {tenant!r} given but the server has no TenantManager")
            if model is None:
                name = self.tenants.model_for(tenant)  # KeyError: unknown tenant
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
        cache_key = None
        if self.cache is not None:
            # keyed on the raw graph and the active version: a stale hit
            # after a promote or rollback is impossible by construction
            cache_key = ResponseCache.key(canonical_graph_key(graph), entry.name, entry.version,
                                          tenant)
            cached = self.cache.get(cache_key)
            if cached is not None:
                if trace is not None:
                    trace.record("cache_lookup", time.time(), 0.0, hit=True, side="replica",
                                 tenant=tenant)
                fut = ServeFuture()
                fut.version = entry.version
                fut.model_name = entry.name
                fut.set_result(cached)
                self.metrics.on_submit()
                self.metrics.on_response()
                self.metrics.on_response_latency(0.0)
                if deadline is not None:
                    self.metrics.on_deadline(True)
                return fut
        if tenant is not None:
            # after the cache (hits are free), before the shared queue: a
            # flooding tenant sheds here while the queue stays clear
            try:
                self.tenants.admit(tenant, retry_after_s=max(self.max_wait_s, 0.001))
            except ServerOverloaded:
                self.metrics.on_shed()
                raise
        req = _Request(
            graph, entry, bucket, sizes, deadline,
            fallback=bucket > self.plan.natural_bucket(graph.num_nodes),
            tenant=tenant, cache_key=cache_key, trace=trace,
        )
        if tenant is not None:
            tenants = self.tenants
            req.future._on_done = lambda t=tenant: tenants.release(t)
        with self._submit_lock:
            if self._stopped:
                if tenant is not None:
                    self.tenants.release(tenant)
                raise RuntimeError("server stopped; submits are refused")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                if tenant is not None:
                    self.tenants.release(tenant)
                self.metrics.on_shed()
                raise ServerOverloaded(retry_after_s=max(self.max_wait_s, 0.001))
        self.metrics.on_submit()
        self.metrics.set_queue_depth(self._depth())
        return req.future

    def predict(self, graph: GraphData, model: Optional[str] = None,
                timeout: Optional[float] = None, tenant: Optional[str] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(graph, model=model, deadline_s=timeout, tenant=tenant).result(timeout)

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
            if self.costs is not None:
                # the cost->quota feedback: a clock read between windows
                self.costs.maybe_adjust_quotas(self.tenants)
            self.metrics.set_queue_depth(self._depth())
        # shutdown flush: stop(drain=True) never strands accepted work
        with self._pending_lock:
            keys = list(self._pending)
        for key in keys:
            self._flush_group(key)

    def _admit_pending(self, req: _Request):
        # one group per (tenant, model version, bucket): a micro-batch never
        # mixes tenants, so no answer can reach another tenant
        key = (req.tenant, req.entry.name, req.entry.version, req.bucket)
        with self._pending_lock:
            self._pending.setdefault(key, []).append(req)

    def _flush_due(self):
        now = time.monotonic()
        with self._pending_lock:
            keys = list(self._pending)
            backlog: Dict[Optional[str], int] = {}
            for key in keys:
                backlog[key[0]] = backlog.get(key[0], 0) + len(self._pending.get(key) or ())
        if self.tenants is not None and len(backlog) > 1:
            # deficit-weighted round robin across tenants: a flooding tenant
            # cannot buy more than its weight's share of consecutive slots
            rank = {t: i for i, t in enumerate(self.tenants.flush_order(backlog))}
            keys.sort(key=lambda k: (rank.get(k[0], len(rank)), k[3]))
        for key in keys:
            with self._pending_lock:
                group = self._pending.get(key)
            if not group:
                with self._pending_lock:
                    self._pending.pop(key, None)
                continue
            if self._group_full(key, group) or now - group[0].enqueued_at >= self.max_wait_s:
                served = self._flush_group(key)
                if self.tenants is not None and served:
                    self.tenants.on_served(key[0], served)

    def _group_full(self, key, group) -> bool:
        """Full = adding the last request's sizes again would overflow the
        bucket (exact for same-size streams; at worst one early flush)."""
        n = sum(r.sizes[0] for r in group)
        e = sum(r.sizes[1] for r in group)
        t = sum(r.sizes[2] for r in group)
        return not self.plan.fits_batch(key[3], n, e, len(group), group[-1].sizes, acc_trips=t)

    def _flush_group(self, key) -> int:
        """Dispatch one pending group as one or more full batches; returns
        how many requests went to the device (the DWRR debit)."""
        with self._pending_lock:
            group = self._pending.pop(key, None)
        if not group:
            return 0
        now = time.monotonic()
        live: List[_Request] = []
        expired = 0
        for req in group:
            if req.expired(now):
                if req.trace is not None:
                    dur = now - req.enqueued_at
                    req.trace.record("queue_wait", time.time() - dur, dur, bucket=key[3],
                                     tenant=req.tenant, expired=True)
                req.future.set_exception(DeadlineExceeded(
                    f"deadline expired after {now - req.enqueued_at:.3f}s in queue"
                ))
                expired += 1
            else:
                live.append(req)
        if expired:
            self.metrics.on_timeout(expired)
        bucket = key[3]
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
        traced = [r for r in requests if r.trace is not None]
        w0 = time.time() if traced else 0.0  # t0 on the wall clock: the spans' timeline
        try:
            batch, coords = self.plan.pack([r.graph for r in requests], bucket)
            t_pack = time.monotonic()
            outputs = self._compiled(entry, batch, bucket)
            t_disp = time.monotonic()
            variances = None
            if self.scorer is not None:
                # advisory: a failed scoring program answers the batch
                # unscored (the JAX package's rule), counted here
                try:
                    variances = self._scored(entry, batch)
                except Exception:
                    self.metrics.on_scorer_error()
            host = _readback(outputs + (variances or []))
            outputs, variances = host[:len(outputs)], (host[len(outputs):] or None)
        except Exception as e:  # fail the batch, keep the server alive
            self.metrics.on_error(len(requests))
            for req in requests:
                req.future.set_exception(e)
            return
        now = time.monotonic()
        self._batch_seq += 1
        batch_seq = self._batch_seq
        for req in traced:
            # the batch's phase boundaries, one span set per traced rider
            queue_s = max(t0 - req.enqueued_at, 0.0)
            req.trace.record("queue_wait", w0 - queue_s, queue_s, bucket=bucket,
                             tenant=req.tenant)
            req.trace.record("batch_form", w0, t_pack - t0, bucket=bucket,
                             batch_graphs=len(requests))
            req.trace.record("dispatch", w0 + (t_pack - t0), t_disp - t_pack, bucket=bucket,
                             batch_seq=batch_seq)
            req.trace.record("readback", w0 + (t_disp - t0), now - t_disp, bucket=bucket)
        if self.costs is not None:
            self.costs.note_batch(requests[0].tenant, bucket, len(requests),
                                  batch_seconds=now - t0,
                                  flops=self._shape_flops.get((entry.key, bucket), 0.0))
        for req, (g, off, n) in zip(requests, coords):
            # a copy per request: an answer (and a cached one) never keeps
            # the whole batch's buffer alive
            pick = [(lambda a: a[g]) if kind == "graph" else (lambda a: a[off : off + n])
                    for kind in entry.output_type]
            per_head = [np.array(p(o)) for p, o in zip(pick, outputs)]
            if variances is not None:
                unc = []
                for p, v in zip(pick, variances):
                    arr = p(v)
                    unc.append(float(np.mean(arr)) if arr.size else 0.0)
                req.future.uncertainty = unc
                self.scorer.observe(req.tenant, bucket, unc)
            # stamped before resolution: a waiter reads a consistent pair
            req.future.version = entry.version
            req.future.model_name = entry.name
            req.future.batch_seq = batch_seq
            if self.cache is not None and req.cache_key is not None:
                # filled before resolving: a resubmit right after result()
                # hits
                self.cache.put(req.cache_key, per_head)
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
    def _compiled(self, entry: ModelEntry, batch, bucket: int, run: bool = True):
        """``entry``'s forward program on one host batch: captured, and
        counted in ``compiles_total``, when its (version, shape) key is new
        (its matmul FLOPs counted over the capture's eager warm-up by
        ``obs.introspect`` when a cost ledger bills them); replayed with ``run``. Returns the per-head
        outputs (on the device) with ``run``."""
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
        if not prog.instrumented:
            # a cost ledger bills FLOPs: every capture counts them (and
            # takes no memory peak outside a telemetry run, obs/introspect.py)
            introspect.instrument(prog, always=self.costs is not None)
        before = prog.captures
        outputs = prog(batch) if run else prog.prepare(batch)
        if prog.captures != before:
            self.metrics.on_compile()
            if self.costs is not None:
                rec = prog.records.get(
                    introspect.bucket_label(prog.name, introspect.signature_key((batch,))))
                self._shape_flops[(entry.key, bucket)] = (rec or {}).get("cost", {}).get(
                    "flops", 0.0)
        return outputs

    def _scored(self, entry: ModelEntry, batch, run: bool = True):
        """The scorer's program on one host batch, with the forward's
        compile accounting: a new (member set, shape) key is a capture,
        counted in ``compiles_total``."""
        prog = self.scorer.program(entry)
        before = prog.captures
        out = self.scorer.dispatch(entry, batch, run=run)
        if prog.captures != before:
            self.metrics.on_compile()
        return out

    # ---- health and metrics --------------------------------------------
    def health(self) -> Dict:
        """``/healthz``: liveness, registry and warmup state (and the
        tenants, the cache, the bill and the scorer's quantiles)."""
        out = {
            "status": "ok" if self._running.is_set() else "stopped",
            "warm": self._warm,
            "models": self.registry.describe(),
            "buckets": [
                {"max_nodes": cap.max_nodes, "max_edges": cap.max_edges, "n_pad": lay.n_pad,
                 "e_pad": lay.e_pad, "g_pad": lay.g_pad}
                for cap, lay in zip(self.plan.capacities, self.plan.layouts)
            ],
            "queue_depth": self._depth(),
            "queue_capacity": self.queue_capacity,
            "max_wait_s": self.max_wait_s,
        }
        if self.tenants is not None:
            out["tenants"] = self.tenants.describe()
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self.costs is not None:
            out["costs"] = self.costs.bill()
        if self.scorer is not None:
            out["quality"] = dict(self.scorer.stats(),
                                  scorer_errors=self.metrics.snapshot()["scorer_errors"])
        return out

    def render_prometheus(self) -> str:
        """The ``/metrics`` text: the serving series (the JAX package's
        text), ``scorer_errors_total``, then the cost ledger's and the
        scorer's families."""
        prefix = "hydragnn_serve"
        text = self.metrics.render_prometheus(prefix)
        text += (f"# HELP {prefix}_scorer_errors_total Scored batches answered unscored "
                 "because the scoring program failed\n"
                 f"# TYPE {prefix}_scorer_errors_total counter\n"
                 f"{prefix}_scorer_errors_total {self.metrics.snapshot()['scorer_errors']}\n")
        for part in (self.costs, self.scorer):
            if part is not None:
                text += part.render_prometheus()
        return text


def _readback(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor back to the host in one copy (float32), as numpy
    arrays of their shapes."""
    host = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(host[off : off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out
