"""Port parity: the shared observability core (``hydragnn_tpu_torch/obs/``)
against the JAX package's ``obs/``.

- The Prometheus text of one scripted series of ``ServeMetrics`` and
  ``MetricsRegistry`` calls is byte for byte the JAX package's.
- The port's ``RunEventLog`` writes streams that the JAX package's
  ``validate_events`` accepts: strict JSON (non-finite floats become
  null), a torn tail cut off, ``seq`` carried on across reopenings.
- Span files written by either package load in the other's
  ``load_span_events``/``build_traces``/``anatomy``, with equal results;
  the ``X-Hydragnn-Trace`` header codec works both ways.
- ``utils/envparse`` parses and refuses as the JAX module does.
- The ``/healthz`` + ``/metrics`` listener answers over a real socket.
- ``obs/drift.P2Quantile`` gives the JAX sketch's value after every sample.
"""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from hydragnn_tpu.obs import drift as jax_drift
from hydragnn_tpu.obs import events as jax_events
from hydragnn_tpu.obs import metrics as jax_metrics
from hydragnn_tpu.obs import trace as jax_trace
from hydragnn_tpu.utils import envparse as jax_envparse

from hydragnn_tpu_torch.obs import drift, events, metrics, trace
from hydragnn_tpu_torch.obs.http import ObservabilityServer
from hydragnn_tpu_torch.utils import envparse


def _script_serve(m):
    """One scripted series of ``ServeMetrics`` calls."""
    for _ in range(7):
        m.on_submit()
    m.on_shed()
    m.on_compile()
    m.on_compile()
    m.on_batch(0, 3, real_nodes=20, padded_nodes=32, batch_seconds=0.0031)
    m.on_batch(1, 2, real_nodes=30, padded_nodes=40, batch_seconds=0.04, fallbacks=1)
    for s in (0.0004, 0.002, 0.007, 0.03, 0.2, 3.0, 20.0):
        m.on_response_latency(s)
    m.on_timeout()
    m.on_deadline(True, 2)
    m.on_deadline(False)
    m.on_error(1)
    m.on_response(1)
    m.set_queue_depth(4)
    m.on_cache_hit(3)
    m.on_cache_miss(5)
    m.on_cache_evict(2)
    m.set_cache_bytes(4096)
    return m


def _script_registry(r):
    r.counter("steps_total", "Steps")
    r.gauge("loss", "Loss")
    r.histogram("epoch_seconds", "Epoch time", bounds=jax_metrics.EPOCH_LATENCY_BOUNDS)
    r.labeled_gauge("bucket_flops", "FLOPs per bucket")
    r.labeled_gauge("empty", "no label set yet")
    r.inc("steps_total", 5)
    r.set("loss", 0.123456789)
    for s in (0.3, 2.0, 70.0):
        r.observe("epoch_seconds", s)
    r.set_labeled("bucket_flops", 1.5e9, bucket=1, model="pna")
    r.set_labeled("bucket_flops", 2.25, model="gin", bucket=0)
    r.set_labeled("bucket_flops", 7, bucket=2, model="pna")
    return r


def pytest_prometheus_text_is_the_jax_package_s():
    port, ref = _script_serve(metrics.ServeMetrics()), _script_serve(jax_metrics.ServeMetrics())
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.render_prometheus("other") == ref.render_prometheus("other")
    snap = port.snapshot()
    assert snap.pop("scorer_errors") == 0
    assert snap == ref.snapshot()
    port_r = _script_registry(metrics.MetricsRegistry("hydragnn"))
    ref_r = _script_registry(jax_metrics.MetricsRegistry("hydragnn"))
    assert port_r.render_prometheus() == ref_r.render_prometheus()
    assert port_r.snapshot() == ref_r.snapshot()
    with pytest.raises(ValueError, match="already declared"):
        port_r.counter("steps_total")


def pytest_port_event_stream_passes_the_jax_validator(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = events.RunEventLog(path)
    log.emit("run_manifest", schema_version=events.SCHEMA_VERSION, run="r", config_hash="h",
             git_rev="g", world_size=1, device_kind="cpu", device_count=1, num_epoch=1)
    log.emit("quota_adjusted", tenant="a", old_quota=8, new_quota=4, reason="over_cost",
             cost_share=0.9, fair_share=0.5)
    log.emit("span", trace="t", span="s", parent="", name="route", start=1.0,
             dur_s=float("nan"), attrs={"x": float("inf")})
    log.close()
    with open(path, "a") as f:
        f.write('{"event": "span", "ts": 1.0, "se')  # a write cut short
    log = events.RunEventLog(path)  # repairs the tail, carries seq on
    log.emit("cache_stats", hits=1, misses=2, evictions=0, bytes=10)
    log.close()
    recs = jax_events.validate_events(path, require=["span", "quota_adjusted", "run_manifest"])
    assert [r["seq"] for r in recs] == [0, 1, 2, 3]
    assert recs[2]["dur_s"] is None and recs[2]["attrs"]["x"] is None
    assert events.validate_events(path) == recs
    with pytest.raises(ValueError, match="missing required"):
        bad = tmp_path / "bad.jsonl"
        bad.write_text(json.dumps({"event": "quota_adjusted", "ts": 0, "seq": 0}) + "\n")
        events.validate_events(str(bad))


def _write_traces(pkg_events, pkg_trace, path):
    """Three requests through one package's tracer at rate 1: each an
    ``attempt`` span and the replica's four spans, recorded on a
    ``TraceContext`` built from the propagated header and merged back; the
    third missed its SLO."""
    log = pkg_events.RunEventLog(path)
    tracer = pkg_trace.Tracer(sample=1.0, emit=log.emit)
    t0 = 1_700_000_000.0
    for i in range(3):
        rt = tracer.start(tenant=f"t{i % 2}", lane="hi")
        # the attempt outlasts its replica spans by 0.5 ms of transport
        attempt = rt.record("attempt", t0 + i, 0.001 * (10 + 4 * i) + 0.0005, replica=i)
        ctx = pkg_trace.TraceContext.from_header(rt.header(attempt))
        for k, name in enumerate(pkg_trace.REPLICA_SPANS):
            ctx.record(name, t0 + i + 0.001 * k, 0.001 * (k + 1 + i), bucket=i)
        rt.merge(ctx.export())
        rt.finish("ok", slo_missed=i == 2)
    log.close()
    return tracer


def pytest_one_tolerant_reader_under_spans_and_quality_events(tmp_path):
    """``events.iter_events`` walks a fleet's tree of streams (nested, a
    torn tail, blank and unparseable lines, a file that is no stream); the
    span and quality loaders built on it read what the JAX package's read.
    A line that parses but is no record is skipped too."""
    root = tmp_path / "fleet"
    (root / "log").mkdir(parents=True)
    (root / "drift-replica0").mkdir()
    _write_traces(events, trace, str(root / "log" / "events.jsonl"))
    rng = np.random.default_rng(5)
    kinds = ["drift_window", "drift_alert", "feedback_sink", "span", "fleet_report"]
    streams = [root / "events-replica0.jsonl", root / "drift-replica0" / "events-canary1.jsonl",
               root / "other.jsonl"]
    whole = 0
    for k, path in enumerate(streams):
        with open(path, "w") as f:
            for seq in range(8):
                rec = {"event": kinds[int(rng.integers(len(kinds)))],
                       "ts": float(rng.integers(0, 4)), "seq": seq, "replica": k}
                if rec["event"] == "span":
                    rec.update(trace=f"t{k}", span=f"s{seq}", name="dispatch", parent="p")
                f.write(json.dumps(rec) + "\n")
                f.write("\n" if seq % 3 else "not json\n")
            f.write('{"event": "drift_alert", "ts": 9.0')  # a torn tail
        whole += 8 * (path.name != "other.jsonl")
    got = list(events.iter_events(str(root)))
    assert len(got) == whole + len(jax_trace.load_span_events(str(root / "log")))
    assert all(isinstance(r, dict) and "event" in r for r in got)
    assert trace.load_span_events(str(root)) == jax_trace.load_span_events(str(root))
    assert drift.load_quality_events(str(root)) == jax_drift.load_quality_events(str(root))
    one = str(streams[1])
    assert drift.load_quality_events(one) == jax_drift.load_quality_events(one)
    assert trace.load_span_events(one) == jax_trace.load_span_events(one)
    odd = tmp_path / "events-odd.jsonl"
    odd.write_text('[1, 2]\n7\n"event"\n{"ts": 1.0}\n{"event": "span", "trace": "x"}\n')
    assert list(events.iter_events(str(odd))) == [{"event": "span", "trace": "x"}]
    assert list(events.iter_events(str(tmp_path / "missing"))) == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def pytest_span_files_read_by_the_other_package(tmp_path, writer):
    path = str(tmp_path / "events.jsonl")
    pkgs = {"port": (events, trace), "jax": (jax_events, jax_trace)}
    tracer = _write_traces(*pkgs[writer], path)
    assert tracer.metrics.get("trace_flushed_total") == 3
    reader = jax_trace if writer == "port" else trace
    spans = reader.load_span_events(str(tmp_path))
    assert len(spans) == 3 * (2 + len(trace.REPLICA_SPANS))
    traces = reader.build_traces(spans)
    mine = pkgs[writer][1]
    assert traces == mine.build_traces(mine.load_span_events(str(tmp_path)))
    assert reader.anatomy(traces) == mine.anatomy(traces)
    for t in traces.values():
        assert t["root"]["name"] == "route"
        names = {s["name"] for s in t["spans"]}
        assert set(trace.REPLICA_SPANS) <= names
        assert reader.dominant_segment(t) == mine.dominant_segment(t) == "readback"
        assert reader.segment_durations(t) == pytest.approx(mine.segment_durations(t))
    jax_events.validate_events(path, require=["span"])


@pytest.mark.parametrize("encoder", ["port", "jax"])
def pytest_trace_header_codec_both_ways(encoder):
    enc, dec = (trace, jax_trace) if encoder == "port" else (jax_trace, trace)
    value = enc.encode_header("0123456789abcdef", "89abcdef")
    assert dec.decode_header(value) == ("0123456789abcdef", "89abcdef")
    ctx = dec.TraceContext.from_header(value)
    assert (ctx.trace_id, ctx.parent_id) == ("0123456789abcdef", "89abcdef")
    for bad in (None, "", "nodash", "-x-01", "x--01"):
        assert dec.decode_header(bad) is None and enc.decode_header(bad) is None
    for rate in (0.0, 0.25, 1.0):
        assert enc.head_sampled("80000000aa", rate) == dec.head_sampled("80000000aa", rate)


@pytest.mark.parametrize("raw", [None, "", " 7 ", "-3", "2.5", "abc", "nan", "1e3"])
def pytest_envparse_as_the_jax_module(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("HYDRAGNN_T", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_T", raw)
    for fn in ("env_int", "env_float"):
        outcomes = []
        for mod in (envparse, jax_envparse):
            try:
                outcomes.append(getattr(mod, fn)("HYDRAGNN_T", 4))
            except ValueError as e:
                outcomes.append(("raises", str(e)))
        a, b = outcomes
        assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))
    monkeypatch.setenv("HYDRAGNN_MESH", raw or "")
    outcomes = []
    for mod in (envparse, jax_envparse):
        try:
            outcomes.append(mod.env_mesh())
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


class _Provider:
    def __init__(self):
        self.status = "ok"
        self.metrics = _script_serve(metrics.ServeMetrics())

    def health(self):
        return {"status": self.status}


def pytest_observability_listener_answers_over_a_socket(tmp_path):
    provider = _Provider()
    http = ObservabilityServer(provider, port=0).start()
    try:
        host, port = http.address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.read().decode() == provider.metrics.render_prometheus()
        provider.status = "stopped"
        for path, code in (("/healthz", 503), ("/profile?steps=2", 501), ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + path, timeout=10)
            assert err.value.code == code
    finally:
        http.stop()
    assert http.address is None
    http.stop()  # a second stop is a no-op
    # a provider with a run: /profile arms its trace capture (200)
    from hydragnn_tpu_torch.obs.runtime import RunTelemetry

    run = RunTelemetry("profiled", str(tmp_path / "profiled"))
    http = ObservabilityServer(run, port=0).start()
    try:
        host, port = http.address
        with urllib.request.urlopen(f"http://{host}:{port}/profile?steps=2", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read())["status"] == "armed"
    finally:
        http.stop()
        run.close()


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def pytest_p2_quantile_as_the_jax_sketch(q):
    values = np.random.default_rng(11).lognormal(size=400)
    port, ref = drift.P2Quantile(q), jax_drift.P2Quantile(q)
    assert port.value() is None and ref.value() is None
    for v in values:
        port.add(v)
        ref.add(v)
        assert port.value() == ref.value()
    with pytest.raises(ValueError, match="quantile"):
        drift.P2Quantile(1.0)
