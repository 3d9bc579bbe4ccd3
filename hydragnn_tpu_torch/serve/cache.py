"""Canonical-graph response cache: a bounded LRU in front of dispatch
(a copy of the JAX package's ``serve/cache.py``, which the port does not
import).

- :func:`canonical_graph_key`: a permutation-stable digest of one request
  graph, computed before collation. Reordering nodes (with the edges
  relabelled) or edge columns gives the same key; changing any float32
  bit of ``x``/``pos``/``edge_attr``, or rewiring an edge, gives another.
  The hex digest equals the JAX package's for the same graph.
- :class:`ResponseCache`: a thread-safe LRU bounded by entry count and by
  payload bytes, keyed ``(tenant, model, version, graph_key)``. The model
  version in the key is what makes a stale hit after a promote or a
  rollback impossible; :meth:`ResponseCache.invalidate` (which the server
  hangs on the registry's activation listeners) only reclaims memory.
  Entries are copies, and :meth:`ResponseCache.get` hands out copies, so
  no caller can change a cached answer, and an entry never keeps a whole
  batch's output alive.

Hash construction (one Weisfeiler-Lehman round over content digests)::

    node_i   = H(x[i] bytes, pos[i] bytes)          # content, not index
    refine_i = H(node_i, sorted out-multiset of (node_j, edge_attr),
                         sorted in-multiset  of (node_j, edge_attr))
    edge_k   = H(refine_src, refine_dst, edge_attr[k] bytes)
    key      = H(counts, sorted(refine_*), sorted(edge_*))

Digests are BLAKE2b-128 over exact float32/int64 bytes: no rounding, so a
one-ULP change changes the key.
"""

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.utils.envparse import env_int


_DIGEST_SIZE = 16  # BLAKE2b-128: plenty for a cache key, half the hashing cost


def _h(*parts: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    for p in parts:
        h.update(p)
    return h.digest()


def canonical_graph_key(graph) -> str:
    """Permutation-stable content digest of one request graph (hex).

    Invariant under any relabeling of nodes (with ``edge_index`` mapped
    through the same permutation) and any reordering of edge columns;
    sensitive to every float32 bit of ``x``/``pos``/``edge_attr`` and to
    the (directed) wiring itself.
    """
    x = np.ascontiguousarray(np.asarray(graph.x, np.float32))
    n = int(x.shape[0])
    pos = (
        None
        if graph.pos is None
        else np.ascontiguousarray(np.asarray(graph.pos, np.float32))
    )
    ei = (
        np.zeros((2, 0), np.int64)
        if graph.edge_index is None
        else np.ascontiguousarray(np.asarray(graph.edge_index, np.int64))
    )
    ea = (
        None
        if getattr(graph, "edge_attr", None) is None
        else np.ascontiguousarray(np.asarray(graph.edge_attr, np.float32))
    )
    m = int(ei.shape[1])
    # pass 1: per-node content digests (row bytes only — no indices)
    node = [
        _h(x[i].tobytes(), b"" if pos is None else pos[i].tobytes())
        for i in range(n)
    ]
    # pass 2: one WL refinement round, direction-aware, edge-attr-aware
    out_adj: List[List[bytes]] = [[] for _ in range(n)]
    in_adj: List[List[bytes]] = [[] for _ in range(n)]
    for k in range(m):
        s, d = int(ei[0, k]), int(ei[1, k])
        attr = b"" if ea is None else ea[k].tobytes()
        out_adj[s].append(node[d] + attr)
        in_adj[d].append(node[s] + attr)
    refined = [
        _h(
            node[i],
            b"\x00",
            *sorted(out_adj[i]),
            b"\x01",
            *sorted(in_adj[i]),
        )
        for i in range(n)
    ]
    # pass 3: edge digests over refined endpoints, then the sorted roll-up
    edges = sorted(
        _h(
            refined[int(ei[0, k])],
            refined[int(ei[1, k])],
            b"" if ea is None else ea[k].tobytes(),
        )
        for k in range(m)
    )
    return _h(
        np.int64(n).tobytes(),
        np.int64(m).tobytes(),
        *sorted(refined),
        b"\x02",
        *edges,
    ).hex()


def _payload_bytes(heads: List[np.ndarray]) -> int:
    return int(sum(np.asarray(h).nbytes for h in heads))


class ResponseCache:
    """Bounded LRU of per-head response arrays, keyed
    ``(tenant, model, version, graph_key)``.

    Thread-safe; sized by both entry count (``capacity``) and payload
    bytes (``max_bytes``) — whichever bound bites first evicts from the
    LRU tail. Stored arrays are copies of the host arrays a dispatch
    read back; :meth:`get` hands back copies so a caller
    mutating its answer cannot poison later hits.
    """

    def __init__(self, capacity: int = 1024, max_bytes: int = 64 << 20,
                 metrics=None):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        if max_bytes < 1:
            raise ValueError("cache max_bytes must be >= 1")
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes)
        self.metrics = metrics  # ServeMetrics (or None): cache_* counters
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Tuple[List[np.ndarray], int]]" = (
            OrderedDict()
        )
        self._bytes = 0
        # local counters so the cache is inspectable without a ServeMetrics
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @classmethod
    def from_env(cls, spec: Optional[Dict] = None, metrics=None) -> Optional["ResponseCache"]:
        """A cache from a fleet spec's ``cache`` section and the
        ``HYDRAGNN_CACHE_*`` knobs (the environment wins), or None when
        caching is off: ``HYDRAGNN_CACHE=0`` turns off a spec that enables
        it, ``HYDRAGNN_CACHE=1`` turns it on with the defaults where no spec
        does. ``HYDRAGNN_CACHE_CAPACITY`` and ``HYDRAGNN_CACHE_MAX_BYTES``
        bound it."""
        spec = dict(spec or {})
        enabled = env_int("HYDRAGNN_CACHE", 1 if spec.get("enabled", bool(spec)) else 0)
        if not enabled:
            return None
        return cls(
            capacity=env_int("HYDRAGNN_CACHE_CAPACITY", int(spec.get("capacity", 1024)),
                             minimum=1),
            max_bytes=env_int("HYDRAGNN_CACHE_MAX_BYTES", int(spec.get("max_bytes", 64 << 20)),
                              minimum=1),
            metrics=metrics,
        )

    @staticmethod
    def key(graph_key: str, model: str, version: int,
            tenant: Optional[str] = None) -> Tuple:
        """The full cache key. Version is load-bearing: it is what makes
        a stale hit after promote/rollback impossible by construction."""
        return (tenant or "", str(model), int(version), graph_key)

    # ---- read/write ----------------------------------------------------
    def get(self, key: Tuple) -> Optional[List[np.ndarray]]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                heads = [np.array(h, copy=True) for h in hit[0]]
        if hit is None:
            if self.metrics is not None:
                self.metrics.on_cache_miss()
            return None
        if self.metrics is not None:
            self.metrics.on_cache_hit()
        return heads

    def put(self, key: Tuple, heads: List[np.ndarray]):
        stored = [np.array(h, copy=True) for h in heads]
        size = _payload_bytes(stored)
        if size > self.max_bytes:
            return  # one oversized answer must not wipe the whole cache
        evicted = 0
        freed = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (stored, size)
            self._bytes += size
            while (
                len(self._entries) > self.capacity
                or self._bytes > self.max_bytes
            ):
                _, (_, osize) = self._entries.popitem(last=False)
                self._bytes -= osize
                evicted += 1
                freed += osize
            self.evictions += evicted
            total = self._bytes
        if self.metrics is not None:
            if evicted:
                self.metrics.on_cache_evict(evicted)
            self.metrics.set_cache_bytes(total)

    # ---- invalidation --------------------------------------------------
    def invalidate(self, tenant: Optional[str] = None,
                   model: Optional[str] = None,
                   version: Optional[int] = None) -> int:
        """Drop matching entries (all of them with no filter). Returns
        the count dropped. Correctness never depends on this — version
        keys already fence stale reads — but promote/rollback call it so
        a superseded version's answers stop occupying budget."""
        with self._lock:
            doomed = [
                k for k in self._entries
                if (tenant is None or k[0] == tenant)
                and (model is None or k[1] == str(model))
                and (version is None or k[2] == int(version))
            ]
            for k in doomed:
                _, size = self._entries.pop(k)
                self._bytes -= size
            total = self._bytes
        if self.metrics is not None:
            self.metrics.set_cache_bytes(total)
        return len(doomed)

    # ---- introspection -------------------------------------------------
    def __len__(self):
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_ratio": round(
                    self.hits / max(self.hits + self.misses, 1), 6
                ),
            }
