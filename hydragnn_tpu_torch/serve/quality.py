"""Per-request uncertainty scoring and the labelled-on-demand feedback
sink (port of the JAX package's ``serve/quality.py``).

:class:`UncertaintyScorer` gives every dispatched batch a per-head
predictive variance from K samples, in one of two modes:

- ``dropout`` (MC dropout): K forwards of the served version in the
  training branch, that is with the stochastic layers' draws (GAT's
  attention dropout) and BatchNorm on the batch's masked statistics, whose
  update of the running statistics is thrown away, as the JAX package's
  ``train=True`` apply with a discarded ``batch_stats``. The port runs
  that branch with ``HydraBase.forward(sample=True)`` on the served module
  as it is (never flipped to ``train()``), so the served running
  statistics do not move. The draws come from the scorer's own generator,
  seeded with ``seed`` before every dispatch, so the same batch gets the
  same K masks each time (the JAX package splits a fixed ``PRNGKey(seed)``
  each time). A model with no stochastic layer draws nothing: its K
  samples are one forward (as under JAX's ``vmap``, which then batches
  nothing), run once, and its variance is exactly zero.
- ``ensemble``: one forward per registered version of the model, the
  entry's version and up to K-1 predecessors, one after another (the port's
  kernels have no batching rule, so there is no ``vmap`` over stacked
  weights). A promote changes the member set, hence the program.

The variance is the population variance over the samples
(``correction=0``, ``jnp.var``'s). On the card each mode is one captured
program per (member set, bucket) that holds all K forwards
(``train/capture.py``): a scored dispatch is one replay, which launches K
times the forward's kernels (the one forward's in ``dropout`` mode without
a stochastic layer). On the CPU the same body runs eagerly. The server
counts the programs in ``compiles_total`` (two per bucket and served
version: the forward and the scoring program).
"""

import math
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

from hydragnn_tpu_torch.obs.drift import P2Quantile
from hydragnn_tpu_torch.obs.metrics import MetricsRegistry
from hydragnn_tpu_torch.obs import introspect
from hydragnn_tpu_torch.train.capture import ProgramSet
from hydragnn_tpu_torch.utils.device import resolve_device
from hydragnn_tpu_torch.utils.envparse import env_float, env_int

MODES = ("dropout", "ensemble")


def _stochastic(model) -> bool:
    """Whether a forward of ``model`` in the training branch draws
    anything (a stochastic layer with a non-zero rate)."""
    return any(getattr(m, "stochastic", False) and float(getattr(m, "dropout", 0.0)) > 0.0
               for m in model.modules())


def _variance(samples: List[Tuple[torch.Tensor, ...]]) -> List[torch.Tensor]:
    """Per head, the population variance over the samples (float32)."""
    return [torch.var(torch.stack([s[i].to(torch.float32) for s in samples]), dim=0,
                      correction=0)
            for i in range(len(samples[0]))]


class UncertaintyScorer:
    """K-sample predictive-variance scoring over the serving registry.

    ``dispatch(entry, batch)`` runs the entry's scoring program on one
    packed host batch and returns one variance tensor per head (on the
    device), shaped as the forward's outputs, which the server slices per
    request with the same coordinates. ``device``: ``None`` means the card
    (raises without one); ``"cpu"`` runs the plain versions."""

    def __init__(self, mode: str = "dropout", samples: int = 4, seed: int = 0,
                 registry=None, metrics: Optional[MetricsRegistry] = None, device=None):
        if mode not in MODES:
            raise ValueError(f"HYDRAGNN_UNC_MODE must be one of {MODES}, got {mode!r}")
        if samples < 2:
            raise ValueError(f"uncertainty scoring needs samples >= 2, got {samples}")
        self.device = resolve_device(device)
        self.mode = mode
        self.samples = int(samples)
        self.seed = int(seed)
        self.registry = registry
        self.metrics = metrics or MetricsRegistry("hydragnn")
        self.metrics.labeled_gauge(
            "uncertainty", "per-tenant/bucket/head predictive-variance quantiles")
        # the dropout draws: one generator on the device, re-seeded before
        # every dispatch and registered with every captured graph
        self.generator = (torch.Generator(device=self.device).manual_seed(self.seed)
                          if mode == "dropout" else None)
        self._programs: Optional[ProgramSet] = None
        self._lock = threading.Lock()
        self._quant: Dict[Tuple, Dict] = {}
        self.scored = 0

    # ---- the scoring programs ------------------------------------------
    def _member_versions(self, entry) -> Tuple[int, ...]:
        """The ensemble's members: the entry's version and up to K-1
        predecessors still registered."""
        versions = [entry.version]
        if self.registry is not None:
            v = entry.version - 1
            while len(versions) < self.samples and v >= 1:
                try:
                    self.registry.get(entry.name, v)
                except KeyError:
                    break
                versions.append(v)
                v -= 1
        return tuple(sorted(versions))

    def program(self, entry):
        """The entry's scoring program (one captured graph per bucket on the
        card), built at first use."""
        if entry.device != self.device:
            raise RuntimeError(
                f"model {entry.name!r} v{entry.version} lives on {entry.device}, the "
                f"scorer on {self.device}"
            )
        if self._programs is None:
            self._programs = ProgramSet(self.device, generator=self.generator)
        if self.mode == "ensemble":
            versions = self._member_versions(entry)
            name = f"score:{entry.name}:ens{'-'.join(str(v) for v in versions)}"
        else:
            name = f"score:{entry.name}:v{entry.version}"
        prog = self._programs.programs.get(name)
        if prog is not None:
            return prog
        if self.mode == "ensemble":
            members = [self.registry.get(entry.name, v).model if self.registry is not None
                       else entry.model for v in versions]
            for m in members:
                if next(m.parameters()).device != self.device:
                    raise RuntimeError(f"an ensemble member of {entry.name!r} is not on "
                                       f"{self.device}")

            def body(b):
                with torch.inference_mode():
                    return _variance([m(b) for m in members])

            bodies = len(members)
        else:
            model, k, gen = entry.model, self.samples, self.generator
            if _stochastic(model):
                def body(b):
                    with torch.inference_mode():
                        return _variance([model(b, generator=gen, sample=True)
                                          for _ in range(k)])

                bodies = k
            else:
                def body(b):
                    with torch.inference_mode():
                        return [torch.zeros_like(o, dtype=torch.float32)
                                for o in model(b, sample=True)]

                bodies = 1
        # accounted like the forward while a telemetry run is active
        return introspect.instrument(
            self._programs.program(name, body, bodies=lambda args, n=bodies: n))

    def dispatch(self, entry, batch, run: bool = True):
        """Per-head predictive variance of one packed host batch (device
        tensors), through the entry's scoring program: captured at the
        first call with the batch's shape key, replayed after. With
        ``run=False`` only the capture (the warmup). In ``dropout`` mode
        the generator is re-seeded right before the replay, so that every
        dispatch draws the same masks."""
        prog = self.program(entry)
        prog.prepare(batch)
        if not run:
            return None
        if self.generator is not None:
            self.generator.manual_seed(self.seed)
        return prog(batch)

    def release(self):
        """Free every captured scoring program."""
        if self._programs is not None:
            self._programs.release()
            self._programs = None

    # ---- per-tenant/bucket quantiles -----------------------------------
    def observe(self, tenant, bucket, head_vars: List[float]):
        """Fold one request's per-head variance scalars into the
        per-(tenant, bucket, head) quantile sketches and gauges."""
        with self._lock:
            self.scored += 1
            for ihead, v in enumerate(head_vars):
                if v is None or not math.isfinite(float(v)):
                    continue
                key = (tenant or "-", int(bucket), ihead)
                qs = self._quant.get(key)
                if qs is None:
                    qs = self._quant[key] = {"p50": P2Quantile(0.5), "p90": P2Quantile(0.9),
                                             "p99": P2Quantile(0.99)}
                for name, sk in qs.items():
                    sk.add(float(v))
                    val = sk.value()
                    if val is not None:
                        self.metrics.set_labeled("uncertainty", val, tenant=key[0],
                                                 bucket=key[1], head=ihead, q=name)

    def stats(self) -> Dict:
        with self._lock:
            quantiles = {
                f"{t}|{b}|{h}": {name: sk.value() for name, sk in qs.items()}
                for (t, b, h), qs in sorted(self._quant.items())
            }
            return {"mode": self.mode, "samples": self.samples, "scored": self.scored,
                    "quantiles": quantiles}

    def render_prometheus(self) -> str:
        return self.metrics.render_prometheus()

    @classmethod
    def from_env(cls, registry=None, device=None) -> Optional["UncertaintyScorer"]:
        """``HYDRAGNN_UNC_SAMPLES`` >= 2 turns scoring on (default 0: off);
        ``HYDRAGNN_UNC_MODE`` picks the mode, ``HYDRAGNN_UNC_SEED`` the
        dropout draws' seed."""
        samples = env_int("HYDRAGNN_UNC_SAMPLES", 0)
        if samples == 0:
            return None
        if samples < 2:
            raise ValueError("HYDRAGNN_UNC_SAMPLES must be 0 (off) or >= 2 (K scoring "
                             f"samples), got {samples}")
        return cls(mode=os.getenv("HYDRAGNN_UNC_MODE", "dropout"), samples=samples,
                   seed=env_int("HYDRAGNN_UNC_SEED", 0), registry=registry, device=device)


class FeedbackSink:
    """Dedup + bound + persist the graphs worth labeling.

    ``offer`` admits a graph when the request was drifted (detector
    alert active) or its max per-head predictive variance clears
    ``min_unc``; admitted graphs dedup by ``canonical_graph_key`` (an
    LRU seen-set, so permuted duplicates of the same graph never enqueue
    twice), buffer up to ``max_graphs`` and flush as one shard_store
    pack (``shard.<packs:05d>.gpk``) under ``queue_dir`` — which is then
    directly consumable by ``ShardStoreSource``/``ShardDataset`` of
    either package. At most ``max_packs`` packs are ever written
    (bounded disk), after which offers count as dropped.
    """

    def __init__(
        self,
        queue_dir: str,
        *,
        max_graphs: int = 256,
        max_packs: int = 16,
        min_unc: float = 0.0,
        emit=None,
    ):
        self.queue_dir = queue_dir
        self.max_graphs = max(int(max_graphs), 1)
        self.max_packs = max(int(max_packs), 1)
        self.min_unc = float(min_unc)
        self.emit = emit
        self._lock = threading.Lock()
        self._buf: List = []
        self._seen: "dict" = {}  # canonical key -> True, LRU-bounded
        self._seen_cap = max(4 * self.max_graphs, 1024)
        self.offered = 0
        self.accepted = 0
        self.deduped = 0
        self.dropped = 0
        self.graphs = 0  # persisted
        self.packs = 0
        self._next_rank = 0  # reserved under the lock: concurrent
        # flushes must never write the same shard.<rank>.gpk

    def offer(self, graph, uncertainty=None, drifted: bool = False) -> bool:
        """Consider one served graph; returns True when it was buffered
        for labeling. Never raises into the request path."""
        try:
            return self._offer(graph, uncertainty, drifted)
        except Exception:
            return False

    def _offer(self, graph, uncertainty, drifted) -> bool:
        admit = bool(drifted)
        if not admit and uncertainty is not None:
            finite = [
                float(v) for v in uncertainty
                if v is not None and math.isfinite(float(v))
            ]
            admit = bool(finite) and max(finite) >= self.min_unc
        with self._lock:
            self.offered += 1
            if not admit:
                return False
            from hydragnn_tpu_torch.serve.cache import canonical_graph_key

            key = canonical_graph_key(graph)
            if key in self._seen:
                self._seen.pop(key)
                self._seen[key] = True  # refresh LRU position
                self.deduped += 1
                return False
            if self.packs >= self.max_packs:
                self.dropped += 1
                return False
            self._seen[key] = True
            while len(self._seen) > self._seen_cap:
                self._seen.pop(next(iter(self._seen)))
            self._buf.append(graph.clone())
            self.accepted += 1
            flush = len(self._buf) >= self.max_graphs
        if flush:
            self.flush()
        return True

    def flush(self):
        """Persist the buffered graphs as one pack (tmp + rename via
        ShardWriter, so a reader never sees a torn pack)."""
        with self._lock:
            if not self._buf or self._next_rank >= self.max_packs:
                return
            buf, self._buf = self._buf, []
            rank = self._next_rank
            self._next_rank += 1
        from hydragnn_tpu_torch.data.shard_store import ShardWriter

        writer = ShardWriter(self.queue_dir, rank=rank)
        writer.add(buf)
        writer.save()
        with self._lock:
            self.packs += 1
            self.graphs += len(buf)
        if self.emit is not None:
            self.emit("feedback_sink", **self.stats())

    def close(self):
        self.flush()

    def stats(self) -> Dict:
        with self._lock:
            return {
                "offered": self.offered,
                "accepted": self.accepted,
                "deduped": self.deduped,
                "dropped": self.dropped,
                "graphs": self.graphs,
                "packs": self.packs,
                "buffered": len(self._buf),
            }

    @classmethod
    def from_env(cls, emit=None) -> Optional["FeedbackSink"]:
        """``HYDRAGNN_FEEDBACK_DIR`` (unset = sink off) + bounded-size
        knobs, all via ``utils/envparse``."""
        queue_dir = os.getenv("HYDRAGNN_FEEDBACK_DIR")
        if not queue_dir:
            return None
        return cls(
            queue_dir,
            max_graphs=env_int(
                "HYDRAGNN_FEEDBACK_MAX_GRAPHS", 256, minimum=1
            ),
            max_packs=env_int(
                "HYDRAGNN_FEEDBACK_MAX_PACKS", 16, minimum=1
            ),
            min_unc=env_float("HYDRAGNN_FEEDBACK_MIN_UNC", 0.0),
            emit=emit,
        )
