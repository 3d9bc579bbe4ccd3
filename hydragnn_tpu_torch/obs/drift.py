"""Streaming drift detection: the model-quality half of observability (a
port of the JAX package's ``obs/drift.py``, numpy on the host).

Three layers, bottom-up:

- **Sketches**: :class:`P2Quantile` (Jain & Chlamtac 1985 P², one quantile
  in O(1) state, not mergeable; the uncertainty scorer's per-tenant
  quantiles) and :class:`StreamingHistogram` (a Ben-Haim & Tom-Tov style
  bounded centroid histogram, mergeable in any order: the fleet's rollup
  and the reference snapshot both rely on it).
- **Scores**: :func:`psi` (population stability index over
  reference-quantile bins) and :func:`ks` (the largest CDF gap), computed
  sketch against sketch.
- **Detector**: :class:`DriftDetector` folds each request's input features
  (node and edge counts, species values, edge lengths) and per-head
  prediction and uncertainty scalars into tumbling-window sketches, scores
  each window against a reference window pinned to the serving version,
  and raises and clears ``drift_alert`` events with hysteresis.

A version's reference is written to ``drift-ref-v<version>.json`` the
first time it activates (a promote snapshots the traffic the candidate
was vetted on); a rollback re-activates a version whose file exists and
reloads it. Two versions never share or overwrite a baseline. The files,
the events and the sketches' serialisation are the JAX package's.
:func:`load_quality_events`, :func:`build_drift_report` and
:func:`render_drift_text` fold a fleet's streams into the report the JAX
package's ``obs drift`` command prints.
"""

import json
import math
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from hydragnn_tpu_torch.obs.events import iter_events
from hydragnn_tpu_torch.obs.metrics import MetricsRegistry
from hydragnn_tpu_torch.utils.envparse import env_float, env_int

# knob defaults (the JAX package's names and values)
DEFAULT_WINDOW = 64        # requests per tumbling evaluation window
DEFAULT_PSI = 0.25         # PSI at/above => window counts toward raise
DEFAULT_KS = 0.35          # KS  at/above => window counts toward raise
DEFAULT_RAISE = 2          # consecutive over-threshold windows to raise
DEFAULT_CLEAR = 2          # consecutive clean windows to clear
DEFAULT_BINS = 64          # StreamingHistogram centroid budget

# per-request caps on the unbounded feature streams (species values,
# edge lengths): drift needs the distribution, not every sample
_SPECIES_CAP = 128
_EDGE_CAP = 64


class P2Quantile:
    """P² single-quantile estimator (Jain & Chlamtac 1985): five markers,
    no buffering past the first five samples, exact below five
    observations. Not mergeable."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._heights: List[float] = []
        self._pos: List[float] = []
        self._want: List[float] = []
        self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float):
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._heights.append(x)
            self._heights.sort()
            if self.n == 5:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._inc[i]
        for i in (1, 2, 3):  # move the interior markers toward their places
            d = self._want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                    d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                s = 1.0 if d >= 1.0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # the parabola overshot: linear
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def value(self) -> Optional[float]:
        if self.n == 0:
            return None
        if self.n <= 5:  # exact: nearest rank over the sorted buffer
            idx = min(int(math.ceil(self.q * self.n)) - 1, self.n - 1)
            return self._heights[max(idx, 0)]
        return self._heights[2]


class StreamingHistogram:
    """Bounded mergeable centroid histogram (Ben-Haim & Tom-Tov style).

    At most ``max_bins`` (centroid, count) pairs; inserting past the
    budget merges the two closest centroids (weighted). ``merge`` feeds
    one sketch's bins into another, so combining per-stream sketches
    approximates the sketch of the concatenated stream — merge order
    only moves estimates within the sketch's own approximation error
    (the merge-associativity property test pins this).
    """

    def __init__(self, max_bins: int = DEFAULT_BINS):
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        self.max_bins = int(max_bins)
        self.bins: List[List[float]] = []  # [centroid, count], sorted
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def add(self, x: float, count: float = 1.0):
        x, count = float(x), float(count)
        if count <= 0.0 or not math.isfinite(x):
            return
        self.total += count
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        bins = self.bins
        lo, hi = 0, len(bins)
        while lo < hi:
            mid = (lo + hi) // 2
            if bins[mid][0] < x:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(bins) and bins[lo][0] == x:
            bins[lo][1] += count
            return
        bins.insert(lo, [x, count])
        while len(bins) > self.max_bins:
            # merge the closest adjacent pair (weighted centroid)
            gaps = [
                bins[i + 1][0] - bins[i][0] for i in range(len(bins) - 1)
            ]
            i = gaps.index(min(gaps))
            c1, w1 = bins[i]
            c2, w2 = bins[i + 1]
            w = w1 + w2
            bins[i] = [(c1 * w1 + c2 * w2) / w, w]
            del bins[i + 1]

    def merge(self, other: "StreamingHistogram"):
        for c, w in other.bins:
            self.add(c, w)
        if other.min is not None:
            self.min = (
                other.min if self.min is None else min(self.min, other.min)
            )
        if other.max is not None:
            self.max = (
                other.max if self.max is None else max(self.max, other.max)
            )

    def copy(self) -> "StreamingHistogram":
        h = StreamingHistogram(self.max_bins)
        h.bins = [list(b) for b in self.bins]
        h.total, h.min, h.max = self.total, self.min, self.max
        return h

    def cdf(self, x: float) -> float:
        """Fraction of mass <= x, with each bin's mass split linearly
        around its centroid (the BHTT sum convention)."""
        if self.total <= 0.0 or self.min is None:
            return 0.0
        if x < self.min:
            return 0.0
        if x >= self.max:
            return 1.0
        bins = self.bins
        acc = 0.0
        for i, (c, w) in enumerate(bins):
            if c <= x:
                acc += w
                continue
            # x sits between centroid i-1 and centroid i: interpolate
            # the half-masses each centroid contributes to the gap
            if i == 0:
                lo_c, lo_w = self.min, 0.0
            else:
                lo_c, lo_w = bins[i - 1][0], bins[i - 1][1]
            if c == lo_c:
                break
            frac = (x - lo_c) / (c - lo_c)
            acc += -lo_w / 2.0 + (lo_w + w) / 2.0 * frac
            break
        return min(max(acc / self.total, 0.0), 1.0)

    def quantile(self, q: float) -> Optional[float]:
        """Inverse of :meth:`cdf` by interpolation between centroids."""
        if self.total <= 0.0 or self.min is None:
            return None
        q = min(max(float(q), 0.0), 1.0)
        target = q * self.total
        acc = 0.0
        prev_c, prev_half = self.min, 0.0
        for c, w in self.bins:
            step = prev_half + w / 2.0
            if acc + step >= target:
                frac = (target - acc) / step if step > 0 else 0.0
                return prev_c + (c - prev_c) * frac
            acc += step
            prev_c, prev_half = c, w / 2.0
        return self.max

    def to_dict(self) -> Dict:
        return {
            "max_bins": self.max_bins,
            "bins": [[float(c), float(w)] for c, w in self.bins],
            "min": self.min,
            "max": self.max,
            "total": self.total,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "StreamingHistogram":
        h = cls(int(d.get("max_bins", DEFAULT_BINS)))
        h.bins = [[float(c), float(w)] for c, w in d.get("bins", [])]
        h.total = float(d.get("total", sum(w for _, w in h.bins)))
        h.min = d.get("min")
        h.max = d.get("max")
        return h


# ---- drift scores (scipy-free, sketch vs sketch) -------------------------


def psi(ref: StreamingHistogram, live: StreamingHistogram,
        bins: int = 10, eps: float = 1e-4) -> float:
    """Population stability index: bin edges from the REFERENCE sketch's
    quantiles (so every reference bin holds ~equal mass), fractions from
    both sketches' CDFs, ``sum((p - q) * ln(p / q))`` with epsilon
    smoothing. Rule of thumb: < 0.1 stable, > 0.25 drifted."""
    if ref.total <= 0.0 or live.total <= 0.0:
        return 0.0
    edges = []
    for i in range(1, bins):
        e = ref.quantile(i / bins)
        if e is not None and (not edges or e > edges[-1]):
            edges.append(e)
    if not edges:  # constant reference: PSI over {<=c, >c}
        edges = [ref.bins[0][0]] if ref.bins else [0.0]
    score = 0.0
    prev_r = prev_v = 0.0
    for e in edges + [float("inf")]:
        r = ref.cdf(e) if math.isfinite(e) else 1.0
        v = live.cdf(e) if math.isfinite(e) else 1.0
        p = max(r - prev_r, eps)
        q = max(v - prev_v, eps)
        score += (p - q) * math.log(p / q)
        prev_r, prev_v = r, v
    return float(score)


def ks(ref: StreamingHistogram, live: StreamingHistogram) -> float:
    """Two-sample Kolmogorov–Smirnov statistic between the sketches'
    CDFs, evaluated at every centroid of either (<= 2 x max_bins
    points — where piecewise-linear CDFs can attain their max gap)."""
    if ref.total <= 0.0 or live.total <= 0.0:
        return 0.0
    points = sorted(
        {c for c, _ in ref.bins} | {c for c, _ in live.bins}
    )
    gap = 0.0
    for x in points:
        gap = max(gap, abs(ref.cdf(x) - live.cdf(x)))
    return float(gap)


# ---- per-request feature extraction --------------------------------------


def graph_features(graph) -> Dict[str, List[float]]:
    """The input-distribution features one request contributes, straight
    off the collate-layout fields (``GraphData``): node/edge counts,
    species values (first node-feature column), edge lengths (``pos``
    distances when present, else the first ``edge_attr`` column).
    Unbounded streams are capped per request — drift needs the
    distribution, not the census."""
    feats: Dict[str, List[float]] = {
        "num_nodes": [float(graph.num_nodes)],
        "num_edges": [float(graph.num_edges)],
    }
    x = getattr(graph, "x", None)
    if x is not None and x.ndim == 2 and x.shape[1] >= 1:
        feats["species"] = [
            float(v) for v in np.asarray(x[:_SPECIES_CAP, 0], np.float64)
        ]
    ei = getattr(graph, "edge_index", None)
    pos = getattr(graph, "pos", None)
    if ei is not None and ei.size and pos is not None:
        src = np.asarray(ei[0, :_EDGE_CAP], np.int64)
        dst = np.asarray(ei[1, :_EDGE_CAP], np.int64)
        n = pos.shape[0]
        ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
        if ok.any():
            d = np.linalg.norm(
                np.asarray(pos, np.float64)[src[ok]]
                - np.asarray(pos, np.float64)[dst[ok]],
                axis=1,
            )
            feats["edge_len"] = [float(v) for v in d]
    elif getattr(graph, "edge_attr", None) is not None:
        ea = graph.edge_attr
        if ea.ndim == 2 and ea.shape[1] >= 1 and ea.shape[0]:
            feats["edge_len"] = [
                float(v)
                for v in np.asarray(ea[:_EDGE_CAP, 0], np.float64)
            ]
    return feats


def _key_str(tenant, feature, head) -> str:
    return f"{tenant or '-'}|{feature}|{head or '-'}"


def _key_parts(key: str):
    tenant, feature, head = key.split("|", 2)
    return tenant, feature, head


class DriftDetector:
    """Tumbling-window drift scoring against a version-pinned reference.

    Thread-safe; ``observe`` is called per served request (fleet replica
    request path), ``on_activate`` is registered as a registry
    activation listener so promote/rollback snapshot/reload the
    reference. ``emit`` (when given) receives ``drift_window`` /
    ``drift_alert`` events; gauges render through
    :meth:`render_prometheus` as
    ``hydragnn_drift_score{tenant,head,feature}``.
    """

    def __init__(
        self,
        ref_dir: str,
        *,
        window: int = DEFAULT_WINDOW,
        psi_threshold: float = DEFAULT_PSI,
        ks_threshold: float = DEFAULT_KS,
        raise_after: int = DEFAULT_RAISE,
        clear_after: int = DEFAULT_CLEAR,
        max_bins: int = DEFAULT_BINS,
        emit=None,
        metrics=None,
    ):
        self.ref_dir = ref_dir
        self.window = max(int(window), 1)
        self.psi_threshold = float(psi_threshold)
        self.ks_threshold = float(ks_threshold)
        self.raise_after = max(int(raise_after), 1)
        self.clear_after = max(int(clear_after), 1)
        self.max_bins = int(max_bins)
        self.emit = emit
        self.metrics = metrics or MetricsRegistry("hydragnn")
        self.metrics.labeled_gauge(
            "drift_score",
            "live-window PSI vs the version-pinned reference window",
        )
        self._lock = threading.Lock()
        self._live: Dict[str, StreamingHistogram] = {}
        self._last: Dict[str, StreamingHistogram] = {}
        self._ref: Optional[Dict[str, StreamingHistogram]] = None
        self._ref_version: Optional[int] = None
        self._count = 0
        self._alerts: Dict[str, Dict] = {}
        self._active: Dict[str, set] = {}  # tenant -> alerted keys
        self.windows = 0
        self.raised = 0
        self.cleared = 0
        self.requests = 0

    # ---- reference lifecycle -------------------------------------------
    def _ref_path(self, version) -> str:
        return os.path.join(self.ref_dir, f"drift-ref-v{version}.json")

    def on_activate(self, version: int):
        """Registry activation listener: pin the reference to the newly
        active version. A version seen before (rollback) RELOADS its
        frozen file; a new version (promote) snapshots the most recent
        traffic — never the other way around, so baselines cannot
        alias."""
        path = self._ref_path(version)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    payload = json.load(f)
                sketches = {
                    k: StreamingHistogram.from_dict(d)
                    for k, d in payload.get("sketches", {}).items()
                }
            except (OSError, ValueError):
                sketches = {}
            with self._lock:
                self._ref = sketches or None
                self._ref_version = version
                self._reset_alerts_locked()
            return
        with self._lock:
            # snapshot the freshest traffic this process has: the last
            # completed window merged with the in-flight one
            snap: Dict[str, StreamingHistogram] = {}
            for k, h in self._last.items():
                snap[k] = h.copy()
            for k, h in self._live.items():
                if k in snap:
                    snap[k].merge(h)
                else:
                    snap[k] = h.copy()
            self._ref = snap or None
            self._ref_version = version
            self._reset_alerts_locked()
        if snap:
            self._persist_ref(version, snap)

    def _persist_ref(self, version, sketches: Dict[str, StreamingHistogram]):
        try:
            os.makedirs(self.ref_dir, exist_ok=True)
            path = self._ref_path(version)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "version": version,
                        "sketches": {
                            k: h.to_dict() for k, h in sketches.items()
                        },
                    },
                    f,
                )
            os.replace(tmp, path)
        except OSError:
            pass  # a full disk must not kill serving

    def _reset_alerts_locked(self):
        self._alerts.clear()
        self._active.clear()

    # ---- observation ----------------------------------------------------
    def observe(self, tenant, graph=None, heads=None, uncertainty=None):
        """Fold one served request into the live window; returns True
        when any drift alert is currently active for ``tenant`` (the
        feedback sink's "drifted" admission signal)."""
        evaluate = False
        with self._lock:
            self.requests += 1
            if graph is not None:
                for feature, values in graph_features(graph).items():
                    sk = self._sketch_locked(
                        _key_str(tenant, feature, None)
                    )
                    for v in values:
                        sk.add(v)
            if heads is not None:
                for ihead, out in enumerate(heads):
                    v = _mean_scalar(out)
                    if v is not None:
                        self._sketch_locked(
                            _key_str(tenant, "pred", str(ihead))
                        ).add(v)
            if uncertainty is not None:
                for ihead, v in enumerate(uncertainty):
                    if v is not None and math.isfinite(float(v)):
                        self._sketch_locked(
                            _key_str(tenant, "unc", str(ihead))
                        ).add(float(v))
            self._count += 1
            if self._count >= self.window:
                evaluate = True
            active = bool(self._active.get(tenant or "-"))
        if evaluate:
            self.evaluate_window()
            with self._lock:
                active = bool(self._active.get(tenant or "-"))
        return active

    def _sketch_locked(self, key: str) -> StreamingHistogram:
        sk = self._live.get(key)
        if sk is None:
            sk = self._live[key] = StreamingHistogram(self.max_bins)
        return sk

    def alert_active(self, tenant=None) -> bool:
        with self._lock:
            if tenant is None:
                return any(bool(v) for v in self._active.values())
            return bool(self._active.get(tenant or "-"))

    # ---- evaluation ------------------------------------------------------
    def evaluate_window(self):
        """Close the current window: score every live sketch against the
        reference, update gauges + hysteresis, emit events, reset."""
        alerts = []
        with self._lock:
            if self._count == 0:
                return
            live, self._live = self._live, {}
            count, self._count = self._count, 0
            self._last = live
            self.windows += 1
            version = self._ref_version
            if self._ref is None:
                # bootstrap: the first completed window becomes the
                # reference for whatever version is serving it
                self._ref = {k: h.copy() for k, h in live.items()}
                ref_snapshot = dict(self._ref)
            else:
                ref_snapshot = None
            scores: Dict[str, Dict[str, float]] = {}
            unc: Dict[str, Dict[str, float]] = {}
            if ref_snapshot is None:
                for key, sk in sorted(live.items()):
                    ref = self._ref.get(key)
                    if ref is None or ref.total <= 0.0:
                        continue  # feature new since the reference
                    s_psi = psi(ref, sk)
                    s_ks = ks(ref, sk)
                    scores[key] = {
                        "psi": round(s_psi, 6), "ks": round(s_ks, 6),
                    }
                    tenant, feature, head = _key_parts(key)
                    self.metrics.set_labeled(
                        "drift_score", s_psi,
                        tenant=tenant, feature=feature, head=head,
                    )
                    alerts.extend(
                        self._hysteresis_locked(
                            key, s_psi, s_ks, version
                        )
                    )
            for key, sk in sorted(live.items()):
                tenant, feature, head = _key_parts(key)
                if feature != "unc":
                    continue
                unc[f"{tenant}|{head}"] = {
                    "p50": _round_opt(sk.quantile(0.5)),
                    "p90": _round_opt(sk.quantile(0.9)),
                    "p99": _round_opt(sk.quantile(0.99)),
                }
        if ref_snapshot is not None and version is not None:
            self._persist_ref(version, ref_snapshot)
        if self.emit is not None:
            payload = {
                "version": version, "window": count, "scores": scores,
            }
            if unc:
                payload["uncertainty"] = unc
            self.emit("drift_window", **payload)
            for a in alerts:
                self.emit("drift_alert", **a)

    def _hysteresis_locked(self, key, s_psi, s_ks, version) -> List[Dict]:
        over = s_psi >= self.psi_threshold or s_ks >= self.ks_threshold
        st = self._alerts.setdefault(
            key, {"active": False, "over": 0, "under": 0}
        )
        out = []
        tenant, feature, head = _key_parts(key)
        if over:
            st["over"] += 1
            st["under"] = 0
            if not st["active"] and st["over"] >= self.raise_after:
                st["active"] = True
                self.raised += 1
                self._active.setdefault(tenant, set()).add(key)
                kind = "psi" if s_psi >= self.psi_threshold else "ks"
                out.append(
                    {
                        "tenant": tenant, "feature": feature,
                        "head": head, "kind": kind,
                        "score": round(
                            s_psi if kind == "psi" else s_ks, 6
                        ),
                        "status": "raised", "version": version,
                    }
                )
        else:
            st["under"] += 1
            st["over"] = 0
            if st["active"] and st["under"] >= self.clear_after:
                st["active"] = False
                self.cleared += 1
                self._active.get(tenant, set()).discard(key)
                out.append(
                    {
                        "tenant": tenant, "feature": feature,
                        "head": head, "kind": "psi",
                        "score": round(s_psi, 6),
                        "status": "cleared", "version": version,
                    }
                )
        return out

    # ---- surfacing -------------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            return {
                "reference_version": self._ref_version,
                "reference_features": (
                    len(self._ref) if self._ref else 0
                ),
                "window": self.window,
                "windows_evaluated": self.windows,
                "requests": self.requests,
                "alerts_active": sum(
                    len(v) for v in self._active.values()
                ),
                "alerts_raised": self.raised,
                "alerts_cleared": self.cleared,
            }

    def render_prometheus(self) -> str:
        return self.metrics.render_prometheus()

    @classmethod
    def from_env(cls, ref_dir: str, emit=None) -> Optional["DriftDetector"]:
        """Knob-driven constructor (all via ``utils/envparse`` — the
        error message names the variable). ``HYDRAGNN_DRIFT_WINDOW=0``
        disables detection entirely."""
        window = env_int("HYDRAGNN_DRIFT_WINDOW", DEFAULT_WINDOW)
        if window == 0:
            return None
        return cls(
            ref_dir,
            window=window,
            psi_threshold=env_float("HYDRAGNN_DRIFT_PSI", DEFAULT_PSI),
            ks_threshold=env_float("HYDRAGNN_DRIFT_KS", DEFAULT_KS),
            raise_after=env_int(
                "HYDRAGNN_DRIFT_RAISE", DEFAULT_RAISE, minimum=1
            ),
            clear_after=env_int(
                "HYDRAGNN_DRIFT_CLEAR", DEFAULT_CLEAR, minimum=1
            ),
            max_bins=env_int("HYDRAGNN_DRIFT_BINS", DEFAULT_BINS,
                             minimum=8),
            emit=emit,
        )


def _mean_scalar(out) -> Optional[float]:
    try:
        v = float(np.mean(np.asarray(out, np.float64)))
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


def _round_opt(v, digits: int = 6):
    return None if v is None else round(float(v), digits)


# ---- `obs drift` CLI report ----------------------------------------------

QUALITY_EVENTS = ("drift_window", "drift_alert", "feedback_sink")


def load_quality_events(path: str) -> List[Dict]:
    """Every quality event under a run/coordination dir (searched
    recursively for ``events*.jsonl``, the fleet layout) or in one
    stream file (:func:`~hydragnn_tpu_torch.obs.events.iter_events`),
    merged in (ts, seq) order."""
    records = [r for r in iter_events(path) if r["event"] in QUALITY_EVENTS]
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("seq", 0)))
    return records


def build_drift_report(records: List[Dict]) -> Dict:
    """Fold quality events into the CLI/report structure: latest scores
    per (tenant, feature, head), the alert ledger, per-head uncertainty
    quantiles, and the sink's fill/dedup counters."""
    scores: Dict[str, Dict] = {}
    uncertainty: Dict[str, Dict] = {}
    alerts: List[Dict] = []
    sink: Optional[Dict] = None
    windows = 0
    for r in records:
        ev = r.get("event")
        if ev == "drift_window":
            windows += 1
            for key, sc in (r.get("scores") or {}).items():
                if isinstance(sc, dict):
                    scores[key] = {
                        "psi": sc.get("psi"), "ks": sc.get("ks"),
                        "version": r.get("version"),
                    }
            for key, qs in (r.get("uncertainty") or {}).items():
                if isinstance(qs, dict):
                    uncertainty[key] = qs
        elif ev == "drift_alert":
            alerts.append(
                {
                    "tenant": r.get("tenant"),
                    "feature": r.get("feature"),
                    "head": r.get("head"),
                    "kind": r.get("kind"),
                    "score": r.get("score"),
                    "status": r.get("status"),
                    "version": r.get("version"),
                    "ts": r.get("ts"),
                }
            )
        elif ev == "feedback_sink":
            sink = {  # cumulative counters: last record wins
                "accepted": r.get("accepted"),
                "deduped": r.get("deduped"),
                "graphs": r.get("graphs"),
                "packs": r.get("packs"),
            }
    active = set()
    for a in alerts:
        key = (a["tenant"], a["feature"], a["head"])
        if a["status"] == "raised":
            active.add(key)
        else:
            active.discard(key)
    return {
        "windows": windows,
        "scores": scores,
        "uncertainty": uncertainty,
        "alerts": alerts,
        "alerts_active": sorted(
            "|".join(str(p) for p in key) for key in active
        ),
        "sink": sink,
    }


def render_drift_text(report: Dict) -> str:
    lines = ["== model-quality (drift) report =="]
    lines.append(
        f"windows: {report['windows']}  alerts: "
        f"{len(report['alerts'])} event(s), "
        f"{len(report['alerts_active'])} active"
    )
    if report["scores"]:
        lines += ["", "-- drift scores (latest window, vs pinned "
                  "reference) --"]
        lines.append(
            f"{'tenant':<12} {'feature':<12} {'head':<6} "
            f"{'psi':>10} {'ks':>10} {'ref_ver':>8}"
        )
        for key in sorted(report["scores"]):
            tenant, feature, head = _key_parts(key)
            sc = report["scores"][key]
            ver = sc.get("version")
            lines.append(
                f"{tenant:<12} {feature:<12} {head:<6} "
                f"{_fmt_score(sc.get('psi')):>10} "
                f"{_fmt_score(sc.get('ks')):>10} "
                f"{str(ver if ver is not None else '-'):>8}"
            )
    if report["uncertainty"]:
        lines += ["", "-- uncertainty quantiles (per tenant/head "
                  "predictive variance) --"]
        lines.append(
            f"{'tenant':<12} {'head':<6} {'p50':>12} {'p90':>12} "
            f"{'p99':>12}"
        )
        for key in sorted(report["uncertainty"]):
            tenant, _, head = (key.split("|") + ["-", "-"])[:3]
            qs = report["uncertainty"][key]
            lines.append(
                f"{tenant:<12} {head:<6} "
                f"{_fmt_score(qs.get('p50')):>12} "
                f"{_fmt_score(qs.get('p90')):>12} "
                f"{_fmt_score(qs.get('p99')):>12}"
            )
    if report["alerts"]:
        lines += ["", "-- alert ledger --"]
        for a in report["alerts"]:
            lines.append(
                f"{a['status']:<8} tenant={a['tenant']} "
                f"feature={a['feature']} head={a['head']} "
                f"{a['kind']}={_fmt_score(a['score'])} "
                f"version={a['version']}"
            )
    if report["sink"]:
        s = report["sink"]
        lines += ["", "-- feedback sink --"]
        lines.append(
            f"accepted={s.get('accepted')} deduped={s.get('deduped')} "
            f"persisted graphs={s.get('graphs')} packs={s.get('packs')}"
        )
    return "\n".join(lines) + "\n"


def _fmt_score(v) -> str:
    return "-" if v is None else f"{float(v):.4g}"
