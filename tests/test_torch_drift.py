"""Port parity: drift detection (``obs/drift.py``) against the JAX package's,
with inputs made from a numpy seed. Everything here is host arithmetic in
float64, so the port is held to the JAX functions exactly.

- ``P2Quantile`` after every sample of adversarial streams.
- ``StreamingHistogram``: the same bins, total, extrema, CDF and quantiles
  after the same inserts; merges; ``to_dict``/``from_dict`` across the
  packages.
- ``psi`` and ``ks`` on the same sketches.
- ``graph_features`` of the same graphs as either package's ``GraphData``.
- ``DriftDetector``: one stream of shifted and clean windows through both
  detectors, the same ``drift_window``/``drift_alert`` events, the same
  reference files, the same alert state after every request; the reference
  pinned per version (a promote snapshots, a rollback reloads); each
  ``HYDRAGNN_DRIFT_*`` knob read alike.
- The report: ``load_quality_events``, ``build_drift_report`` and
  ``render_drift_text`` over the same streams.
"""

import json
import os

import numpy as np
import pytest

from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.obs import drift as jax_drift
from hydragnn_tpu.obs.events import RunEventLog as JaxRunEventLog
from hydragnn_tpu.obs.events import validate_events as jax_validate_events

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.obs import drift
from hydragnn_tpu_torch.obs.events import RunEventLog, validate_events

from test_torch_serve import _graphs


def _streams(seed):
    rng = np.random.default_rng(seed)
    return {
        "normal": rng.normal(0.0, 1.0, 700),
        "sorted": np.sort(rng.exponential(2.0, 700)),
        "reversed": np.sort(rng.normal(0, 1, 700))[::-1].copy(),
        "ties": rng.integers(0, 4, 700).astype(np.float64),
        "bimodal": np.concatenate([rng.normal(-5, 1, 350), rng.normal(5, 1, 350)]),
    }


@pytest.mark.parametrize("kind", ["normal", "sorted", "reversed", "ties", "bimodal"])
def pytest_p2_quantile_as_jax_on_adversarial_streams(kind):
    data = _streams(0)[kind]
    for q in (0.1, 0.5, 0.99):
        ours, theirs = drift.P2Quantile(q), jax_drift.P2Quantile(q)
        for v in data:
            ours.add(v)
            theirs.add(v)
            assert ours.value() == theirs.value()


def _hist(mod, data, max_bins=24):
    h = mod.StreamingHistogram(max_bins)
    for v in data:
        h.add(float(v))
    return h


@pytest.mark.parametrize("kind", ["normal", "sorted", "ties", "bimodal"])
def pytest_streaming_histogram_as_jax(kind):
    data = _streams(1)[kind]
    ours, theirs = _hist(drift, data), _hist(jax_drift, data)
    assert ours.to_dict() == theirs.to_dict()
    probe = np.linspace(data.min() - 1, data.max() + 1, 41)
    assert [ours.cdf(x) for x in probe] == [theirs.cdf(x) for x in probe]
    assert [ours.quantile(q) for q in np.linspace(0, 1, 21)] == \
        [theirs.quantile(q) for q in np.linspace(0, 1, 21)]
    ours.add(float("nan"))  # ignored by both
    ours.add(1.0, count=0.0)
    assert ours.to_dict() == theirs.to_dict()
    # merges in both orders, and a copy, as JAX's
    other = _streams(2)["bimodal"]
    a, b = _hist(drift, other), _hist(jax_drift, other)
    ours.merge(a)
    theirs.merge(b)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.copy().to_dict() == ours.to_dict()
    # serialisation across the packages
    back = drift.StreamingHistogram.from_dict(json.loads(json.dumps(theirs.to_dict())))
    assert back.to_dict() == theirs.to_dict()
    assert jax_drift.StreamingHistogram.from_dict(ours.to_dict()).to_dict() == ours.to_dict()
    with pytest.raises(ValueError):
        drift.StreamingHistogram(1)


@pytest.mark.parametrize("shift", [0.0, 0.3, 1.5, 8.0])
def pytest_psi_ks_as_jax(shift):
    rng = np.random.default_rng(3)
    ref, live = rng.normal(0, 1, 2000), rng.normal(shift, 1, 2000)
    pairs = [(_hist(drift, ref, 64), _hist(drift, live, 64)),
             (_hist(jax_drift, ref, 64), _hist(jax_drift, live, 64))]
    for bins in (4, 10):
        assert drift.psi(*pairs[0], bins=bins) == jax_drift.psi(*pairs[1], bins=bins)
    assert drift.ks(*pairs[0]) == jax_drift.ks(*pairs[1])
    if shift >= 1.5:
        assert drift.psi(*pairs[0]) > drift.DEFAULT_PSI and drift.ks(*pairs[0]) > drift.DEFAULT_KS
    empty = drift.StreamingHistogram(8)
    assert drift.psi(empty, pairs[0][0]) == 0.0 == drift.ks(pairs[0][0], empty)
    const = _hist(drift, [2.0] * 5, 8)
    assert drift.psi(const, pairs[0][1]) == jax_drift.psi(_hist(jax_drift, [2.0] * 5, 8),
                                                          pairs[1][1])


def pytest_graph_features_as_jax():
    ours, theirs = _graphs(GraphData, [3, 9, 150], 4), _graphs(JaxGraphData, [3, 9, 150], 4)
    for g, jg in zip(ours, theirs):
        assert drift.graph_features(g) == jax_drift.graph_features(jg)
    g = ours[0]
    g.pos = None
    g.edge_attr = np.arange(g.num_edges, dtype=np.float32)[:, None]
    jg = theirs[0]
    jg.pos, jg.edge_attr = None, g.edge_attr
    assert drift.graph_features(g) == jax_drift.graph_features(jg)
    assert len(drift.graph_features(ours[2])["species"]) == 128


def _run_detector(mod, log_cls, path, seed):
    """One stream: bootstrap, shifted, clean and mixed windows for two
    tenants, a promote and a rollback; the alert state after every
    request and the stream written."""
    os.makedirs(path, exist_ok=True)
    log = log_cls(os.path.join(path, "events.jsonl"))
    det = mod.DriftDetector(path, window=32, raise_after=2, clear_after=2, emit=log.emit)
    det.on_activate(1)
    rng = np.random.default_rng(seed)
    base = _graphs(GraphData if mod is drift else JaxGraphData, [6] * 32, seed)
    states = []
    for window, scale in enumerate([1, 3, 3, 1, 1, 4, 1, 1]):
        if window == 6:
            det.on_activate(2)
        if window == 7:
            det.on_activate(1)
        for i, g0 in enumerate(base):
            g = g0.clone()
            g.x = g.x * scale
            g.pos = g.pos * scale
            heads = [np.array([float(g.x.sum())]), g.x[:, :1] * 2]
            unc = [float(rng.random()), None] if i % 4 == 0 else None
            tenant = "acme" if i % 2 else None
            states.append(det.observe(tenant, graph=g, heads=heads, uncertainty=unc))
    det.evaluate_window()
    log.close()
    refs = {f: open(os.path.join(path, f)).read() for f in sorted(os.listdir(path))
            if f.startswith("drift-ref")}
    return states, det.stats(), refs, det.render_prometheus()


def _strip(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def pytest_drift_detector_as_jax_over_one_stream(tmp_path):
    ours = _run_detector(drift, RunEventLog, str(tmp_path / "port"), 7)
    theirs = _run_detector(jax_drift, JaxRunEventLog, str(tmp_path / "jax"), 7)
    assert ours == theirs
    states, stats, refs, text = ours
    assert stats["alerts_raised"] >= 1 and stats["alerts_cleared"] >= 1
    assert True in states and set(refs) == {"drift-ref-v1.json", "drift-ref-v2.json"}
    assert "hydragnn_drift_score" in text
    recs = [validate_events(str(tmp_path / d / "events.jsonl"), require=["drift_window",
                                                                         "drift_alert"])
            for d in ("port", "jax")]
    jax_validate_events(str(tmp_path / "port" / "events.jsonl"))
    assert _strip(recs[0]) == _strip(recs[1])
    statuses = [r["status"] for r in recs[0] if r["event"] == "drift_alert"]
    assert "raised" in statuses and "cleared" in statuses


def pytest_drift_reference_pinned_per_version(tmp_path):
    det = drift.DriftDetector(str(tmp_path), window=16)
    det.on_activate(1)
    rng = np.random.default_rng(29)
    for v in rng.normal(0, 1, 16):
        det.observe("t", heads=[np.asarray([v])])
    v1 = open(tmp_path / "drift-ref-v1.json", "rb").read()
    for v in rng.normal(9, 1, 16):
        det.observe("t", heads=[np.asarray([v])])
    det.on_activate(2)
    assert det.stats()["reference_version"] == 2 and (tmp_path / "drift-ref-v2.json").exists()
    det.on_activate(1)
    assert det.stats()["reference_version"] == 1
    assert open(tmp_path / "drift-ref-v1.json", "rb").read() == v1
    # the JAX detector loads the port's file as its own
    jdet = jax_drift.DriftDetector(str(tmp_path), window=16)
    jdet.on_activate(1)
    assert jdet.stats()["reference_features"] == det.stats()["reference_features"] == 1


DRIFT_KNOBS = {"HYDRAGNN_DRIFT_WINDOW": "16", "HYDRAGNN_DRIFT_PSI": "0.1",
               "HYDRAGNN_DRIFT_KS": "0.2", "HYDRAGNN_DRIFT_RAISE": "3",
               "HYDRAGNN_DRIFT_CLEAR": "4", "HYDRAGNN_DRIFT_BINS": "32"}
BAD_DRIFT = {"HYDRAGNN_DRIFT_WINDOW": "banana", "HYDRAGNN_DRIFT_PSI": "nan",
             "HYDRAGNN_DRIFT_KS": "-1", "HYDRAGNN_DRIFT_RAISE": "0",
             "HYDRAGNN_DRIFT_CLEAR": "0", "HYDRAGNN_DRIFT_BINS": "4"}


def _fields(det):
    return None if det is None else (det.window, det.psi_threshold, det.ks_threshold,
                                     det.raise_after, det.clear_after, det.max_bins)


@pytest.mark.parametrize("knob", sorted(DRIFT_KNOBS))
def pytest_drift_knobs_as_jax(monkeypatch, tmp_path, knob):
    for k in DRIFT_KNOBS:
        monkeypatch.delenv(k, raising=False)
    assert _fields(drift.DriftDetector.from_env(str(tmp_path))) == (64, 0.25, 0.35, 2, 2, 64)
    monkeypatch.setenv(knob, DRIFT_KNOBS[knob])
    ours = drift.DriftDetector.from_env(str(tmp_path))
    assert _fields(ours) == _fields(jax_drift.DriftDetector.from_env(str(tmp_path)))
    assert str(DRIFT_KNOBS[knob]) in {str(v) for v in _fields(ours)} | {
        str(float(DRIFT_KNOBS[knob]))}
    monkeypatch.setenv(knob, BAD_DRIFT[knob])
    with pytest.raises(ValueError, match=knob):
        drift.DriftDetector.from_env(str(tmp_path))
    monkeypatch.setenv("HYDRAGNN_DRIFT_WINDOW", "0")  # detection off
    if knob != "HYDRAGNN_DRIFT_WINDOW":
        monkeypatch.delenv(knob)
    assert drift.DriftDetector.from_env(str(tmp_path)) is None


def pytest_drift_report_as_jax(tmp_path):
    _run_detector(drift, RunEventLog, str(tmp_path / "fleet" / "drift-replica0"), 8)
    _run_detector(jax_drift, JaxRunEventLog, str(tmp_path / "fleet" / "drift-replica1"), 9)
    with open(tmp_path / "fleet" / "events-replica2.jsonl", "w") as f:
        f.write('{"event": "feedback_sink", "ts": 1.0, "seq": 0, "accepted": 3, '
                '"deduped": 1, "graphs": 2, "packs": 1}\n{"torn')
    ours = drift.load_quality_events(str(tmp_path / "fleet"))
    theirs = jax_drift.load_quality_events(str(tmp_path / "fleet"))
    assert ours == theirs and len(ours) > 10
    report = drift.build_drift_report(ours)
    assert report == jax_drift.build_drift_report(theirs)
    assert report["sink"]["packs"] == 1 and report["windows"] > 10
    assert drift.render_drift_text(report) == jax_drift.render_drift_text(report)
    one = str(tmp_path / "fleet" / "drift-replica0" / "events.jsonl")
    assert drift.load_quality_events(one) == jax_drift.load_quality_events(one)
    empty = drift.build_drift_report([])
    assert "model-quality" in drift.render_drift_text(empty) and empty["alerts"] == []
