"""Port parity: the canary (``serve/canary.py``) and the autoscaler
(``serve/autoscale.py``) against the JAX package's, with inputs made from a
numpy seed.

- ``evaluate_gates`` gives the JAX function's verdict and reason, string
  for string, over the whole decision table of ``tests/test_canary.py``
  and more; ``_CandidateStats`` gives the JAX accumulator's snapshot after
  the same samples (a NaN veto's origin named ``head_<i>`` by the port,
  ``['head_<i>']`` by JAX, the same subtree); ``CanaryGates.from_env``
  reads each knob as JAX's does.
- The controller, in process as the JAX tier-1 canary tests run it: the
  shadow tap's shed order, a crash loop, a superseded candidate and a boot
  timeout with stubbed replicas, and a NaN candidate vetoed then a healthy
  one promoted through a real in-process port canary replica, which the
  router never routes to. A hot-swap rollback after the gates passed is a
  loud rejection.
- ``AutoscalePolicy``, ``LoadForecast`` and ``FleetAutoscaler`` follow the
  JAX classes decision for decision over one synthetic diurnal load trace,
  with the knobs read alike.
- The training side: a 3-epoch CPU ``run_training`` with ``publish_dir``
  publishes the candidates its knobs ask for, which the JAX package's
  ``CandidateChannel`` reads and the port's registry loads strictly.
"""

import json
import math
import os
import time

import numpy as np
import pytest

from hydragnn_tpu.serve import autoscale as jax_autoscale
from hydragnn_tpu.serve import canary as jax_canary

from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.serve import (
    AutoscalePolicy,
    CanaryController,
    CanaryGates,
    CandidateChannel,
    FleetAutoscaler,
    FleetRouter,
    LoadForecast,
    ReplicaServer,
    ServerOverloaded,
)
from hydragnn_tpu_torch.serve import autoscale as port_autoscale
from hydragnn_tpu_torch.serve import canary as port_canary
from hydragnn_tpu_torch.serve.canary import evaluate_gates
from hydragnn_tpu_torch.serve.fleet import CANARY

from test_torch_fleet import (
    TINY,
    save_checkpoint,
    tiny_model,
    tiny_replica,
    tiny_server,
    write_spec,
)
from test_torch_pna import arch
from test_torch_run_training import _in_dir, raw_dirs  # noqa: F401  (a fixture)
from test_torch_serve import _graphs


# ---- the gates: a pure decision table ---------------------------------------------


def _stats(**over):
    base = {
        "samples": 10, "errors": 0, "nans": 0,
        "head_mae": {0: 1e-4, 1: 1e-4},
        "head_live_mag": {0: 1.0, 1: 1.0},
        "buckets": {0: {"n": 5, "live_mean_s": 0.010, "canary_mean_s": 0.012}},
    }
    base.update(over)
    return base


SLOW = {0: {"n": 5, "live_mean_s": 0.010, "canary_mean_s": 0.030}}
GATE_CASES = [
    ({}, "promote"),
    (dict(samples=0, nans=1), "reject"),
    (dict(nans=2, nan_origins=[{"subtree": "head_1", "origin": "head_1"}]), "reject"),
    (dict(errors=1), "reject"),
    (dict(samples=3), "wait"),
    (dict(head_mae={0: 0.2, 1: 1e-4}), "reject"),
    (dict(head_mae={0: 0.05, 1: 1e-4}), "promote"),
    (dict(buckets=SLOW), "reject"),
    (dict(buckets={0: {"n": 1, "live_mean_s": 0.010, "canary_mean_s": 9.0}}), "promote"),
    (dict(head_mae={0: 0.2, 1: 1e-4}, buckets=SLOW), "reject"),
    (dict(head_live_mag={0: 0.001, 1: 1.0}, head_mae={0: 9e-4, 1: 0.0}), "promote"),
    (dict(uncertainty={"live_n": 5, "live_mean": 1e-3, "canary_n": 5, "canary_mean": 9e-3}),
     "reject"),
    (dict(uncertainty={"live_n": 5, "live_mean": 1e-3, "canary_n": 5, "canary_mean": 2e-3}),
     "promote"),
    (dict(uncertainty={"live_n": 1, "live_mean": 1e-3, "canary_n": 5, "canary_mean": 9.0}),
     "promote"),
]


@pytest.mark.parametrize("over,verdict", GATE_CASES)
@pytest.mark.parametrize("unc_ratio", [None, 3.0])
def pytest_evaluate_gates_as_the_jax_function(over, verdict, unc_ratio):
    kw = dict(min_samples=4, min_bucket_samples=2, head_mae_tol=1e-3, head_mae_rel_tol=0.1,
              latency_ratio_tol=2.0, latency_slack_s=0.0, max_shadow_errors=0,
              max_unc_ratio=unc_ratio)
    ours = evaluate_gates(_stats(**over), CanaryGates(**kw))
    theirs = jax_canary.evaluate_gates(_stats(**over), jax_canary.CanaryGates(**kw))
    assert ours == theirs
    if unc_ratio is None and "uncertainty" in over:
        verdict = "promote"
    assert ours["verdict"] == verdict


def _feed_stats(mod, rng):
    s = mod._CandidateStats()
    verdicts = []
    for i in range(30):
        live = [rng.normal(0, 1, 1), rng.normal(0, 1, (int(rng.integers(3, 9)), 2))]
        cand = [h + rng.normal(0, 0.01, h.shape) for h in live]
        if i in (7, 19):
            cand[i % 2] = cand[i % 2].copy()
            cand[i % 2].flat[0] = np.nan
        unc = None if i % 3 else [float(v) for v in rng.random(2)]
        verdicts.append(s.add_sample(live, cand, bucket=int(rng.integers(0, 3)),
                                     live_latency_s=float(rng.random() * 0.01),
                                     canary_latency_s=float(rng.random() * 0.02),
                                     live_unc=unc, canary_unc=unc))
        if i % 11 == 0:
            s.add_error()
    return verdicts, s.snapshot()


def pytest_candidate_stats_as_the_jax_accumulator():
    ours = _feed_stats(port_canary, np.random.default_rng(3))
    theirs = _feed_stats(jax_canary, np.random.default_rng(3))
    assert ours[0] == theirs[0] and ours[0].count(False) == 2
    a, b = ours[1], theirs[1]
    origins = (a.pop("nan_origins"), b.pop("nan_origins"))
    assert a == b and a["samples"] == 28 and a["nans"] == 2 and a["errors"] == 3
    assert [o["subtree"] for o in origins[0]] == [o["subtree"] for o in origins[1]] == \
        ["head_1", "head_1"]
    assert [(o["leaves"], o["total"]) for o in origins[0]] == \
        [(o["leaves"], o["total"]) for o in origins[1]]
    assert evaluate_gates({**a, "nan_origins": origins[0]}, CanaryGates())["reason"].startswith(
        "nan_outputs: 2 non-finite canary answer(s) — hard veto (first origin: `head_1`")


KNOBS = {
    "HYDRAGNN_CANARY_MIN_SAMPLES": "7", "HYDRAGNN_CANARY_MIN_BUCKET_SAMPLES": "3",
    "HYDRAGNN_CANARY_HEAD_MAE_TOL": "0.01", "HYDRAGNN_CANARY_HEAD_MAE_REL_TOL": "0.2",
    "HYDRAGNN_CANARY_LATENCY_RATIO_TOL": "4.0", "HYDRAGNN_CANARY_LATENCY_SLACK_S": "0.5",
    "HYDRAGNN_CANARY_MAX_SHADOW_ERRORS": "2", "HYDRAGNN_CANARY_MAX_CRASHES": "3",
    "HYDRAGNN_CANARY_DECIDE_TIMEOUT_S": "9.5", "HYDRAGNN_CANARY_MAX_UNC_RATIO": "1.5",
}


@pytest.mark.parametrize("knob", [None] + sorted(KNOBS))
def pytest_canary_gates_from_env_as_jax(monkeypatch, knob):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    if knob is not None:
        monkeypatch.setenv(knob, KNOBS[knob])
    ours = CanaryGates.from_env(min_samples=5)
    theirs = jax_canary.CanaryGates.from_env(min_samples=5)
    assert ours.__dict__ == theirs.__dict__
    if knob is not None:
        field = knob[len("HYDRAGNN_CANARY_"):].lower()
        assert getattr(ours, field) == type(getattr(ours, field) or 0.0)(KNOBS[knob])


# ---- the controller, with stubbed parts -------------------------------------------


class _StubFleet:
    """The supervisor surface the controller needs, the promote recorded."""

    def __init__(self, coord_dir, spec_path=None, promote_result=None):
        self.coord_dir, self.spec_path, self.lease_s = coord_dir, spec_path, 2.0
        self.events, self.promotes = [], []
        self._result = promote_result or {"status": "promoted", "cmd_id": 1,
                                          "versions": {0: 2, 1: 2}, "propagated": True,
                                          "acks": {}}

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def promote(self, checkpoint, path=None, arch_config=None, name=None, timeout=None):
        self.promotes.append({"checkpoint": checkpoint, "path": path, "name": name})
        return dict(self._result)


def _bare_spec(tmp_path):
    path = str(tmp_path / "bare-spec.json")
    with open(path, "w") as f:
        json.dump({"model_name": "m", "checkpoint": {"name": "x", "path": "y"}}, f)
    return path


def pytest_shadow_tap_sheds_degraded_then_queue_full(tmp_path):
    d = str(tmp_path / "coord")
    os.makedirs(d)
    c = CanaryController(_StubFleet(d, _bare_spec(tmp_path)), str(tmp_path / "chan"),
                         fraction=0.5, queue_capacity=4, heartbeat_s=0.0)
    g = object()  # the tap never looks at the graph
    c.shadow_tap(g, {"heads": [[1.0]]}, 0.01)  # disarmed: ignored
    assert c._q.qsize() == 0
    c._armed.set()
    for _ in range(8):  # stride 2: ordinals 0, 2, 4, 6 queue
        c.shadow_tap(g, {"heads": [[1.0]]}, 0.01)
    assert c._q.qsize() == 4 and c.metrics.snapshot()["shadow_shed_total"] == 0
    for _ in range(2):
        c.shadow_tap(g, {"heads": [[1.0]]}, 0.01)
    assert c.metrics.snapshot()["shadow_shed_total"] == 1
    time.sleep(0.01)
    coord.write_json(os.path.join(d, "fleet.json"),
                     {"live": 1, "target": 2, "degraded": True, "ts": time.time()})
    for _ in range(2):
        c.shadow_tap(g, {"heads": [[1.0]]}, 0.01)
    assert c.metrics.snapshot()["shadow_shed_total"] == 2 and c._q.qsize() == 4


def pytest_canary_crash_loop_supersede_and_boot_timeout(tmp_path):
    src = tmp_path / "ck" / "c1"
    src.mkdir(parents=True)
    (src / "c1.pk").write_bytes(b"blob")
    root = str(tmp_path / "chan")
    ch = CandidateChannel(root)
    ch.publish("c1", str(tmp_path / "ck"))
    ch.publish("c1", str(tmp_path / "ck"))
    d = str(tmp_path / "coord")
    os.makedirs(d)

    class _Dead:
        def alive(self):
            return False

        def stop(self):
            pass

    spawned = []

    def factory(spec_path, canary_id, incarnation):
        spawned.append((canary_id, incarnation))
        return _Dead()

    stub = _StubFleet(d, _bare_spec(tmp_path))
    gates = CanaryGates(max_crashes=1, min_samples=4)
    with CanaryController(stub, root, poll_s=0.01, gates=gates, replica_factory=factory) as c:
        d1 = c.wait_decision(1, timeout=30)
        assert d1["verdict"] == "rejected" and d1["reason"] == "superseded by seq 2"
        d2 = c.wait_decision(2, timeout=30)
        assert d2["reason"].startswith("crash_loop: candidate died 2")
    assert spawned == [(2, 0), (2, 1)] and stub.promotes == []
    assert c.metrics.snapshot()["crashes_total"] == 2
    assert [e for e, _ in stub.events].count("canary_rejected") == 2

    class _Wedged(_Dead):
        def alive(self):
            return True

    stub2 = _StubFleet(d, _bare_spec(tmp_path))
    ch.publish("c1", str(tmp_path / "ck"))
    with CanaryController(stub2, root, poll_s=0.01, boot_timeout_s=0.2, gates=gates,
                          replica_factory=lambda *a: _Wedged()) as c2:
        d3 = c2.wait_decision(3, timeout=30)
    assert "never reached serving" in d3["reason"] and stub2.promotes == []


def pytest_canary_promote_rollback_chains_reason(tmp_path):
    d = str(tmp_path / "coord")
    os.makedirs(d)
    stub = _StubFleet(d, _bare_spec(tmp_path),
                      promote_result={"status": "rolled_back", "reason": "corrupt pk"})
    c = CanaryController(stub, str(tmp_path / "chan"), fraction=1.0)
    manifest = {"seq": 5, "checkpoint": "cand", "path": "/x", "ts": time.time()}
    with c._lock:
        c._cand = manifest
    c._promote(manifest, {"samples": 30})
    assert c.wait_decision(5, timeout=5)["reason"] == "hot_swap_rolled_back: corrupt pk"


# ---- the controller with a real canary replica ------------------------------------


def pytest_canary_vetoes_nan_then_promotes_and_takes_no_live_request(tmp_path, monkeypatch):
    """A NaN-answering candidate is vetoed, a healthy one promoted (the
    fleet's swap stubbed), both through a real in-process port canary
    replica fed by the shadow tap; a live replica beside it takes every
    routed request."""
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    spec_path = write_spec(tmp_path, ckdir)
    coord_dir = str(tmp_path / "coord")
    live = tiny_replica(ckdir, coord_dir)
    live.start()
    reps = []

    class _InProc:
        def __init__(self, rep):
            self.rep, self.dead = rep, False

        def alive(self):
            return not self.dead

        def stop(self):
            self.dead = True
            self.rep.shutdown()

    def factory(cand_spec_path, canary_id, incarnation):
        with open(cand_spec_path) as f:
            ck = json.load(f)["checkpoint"]
        rep = ReplicaServer(tiny_server(ck["path"], name=ck["name"]), coord_dir, canary_id,
                            heartbeat_s=0.05, incarnation=incarnation, model_name="m",
                            arch_config=arch(**TINY), role=CANARY)
        rep.start()
        reps.append(rep)
        return _InProc(rep)

    ch = CandidateChannel(str(tmp_path / "chan"))
    stub = _StubFleet(coord_dir, spec_path)
    gates = CanaryGates(min_samples=4, min_bucket_samples=1, latency_ratio_tol=50.0,
                        latency_slack_s=1.0, max_crashes=1, decide_timeout_s=60.0)
    c = CanaryController(stub, ch, spec_path, fraction=1.0, gates=gates, poll_s=0.02,
                         boot_timeout_s=60.0, replica_factory=factory)
    router = FleetRouter(coord_dir, target_replicas=1, scan_interval_s=0.05)
    c.attach(router)
    graphs = _graphs(GraphData, [4, 6, 8, 10, 5, 7], 9)

    def drive(seq):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with c._lock:
                if any(dec["seq"] == seq for dec in c.decisions):
                    break
            for g in graphs:
                assert router.route(g, deadline_s=30, raw=True)["replica"] == 0
        return c.wait_decision(seq, timeout=10)

    try:
        with c:
            monkeypatch.setenv("HYDRAGNN_FAULT_NAN_CANDIDATE", "all")
            ch.publish("base", str(ckdir))
            d1 = drive(1)
            assert d1["verdict"] == "rejected" and d1["reason"].startswith("nan_outputs")
            monkeypatch.delenv("HYDRAGNN_FAULT_NAN_CANDIDATE")
            ch.publish("base", str(ckdir))
            d2 = drive(2)
            assert d2["verdict"] == "promoted" and d2["samples"] >= gates.min_samples
    finally:
        live.shutdown()
    assert [p["checkpoint"] for p in stub.promotes] == ["base"]
    assert stub.promotes[0]["path"] == ch.read(2)["path"] and ch.pinned() == {2}
    events = [e for e, _ in stub.events]
    assert events.count("canary_started") == 2 and events.count("canary_rejected") == 1
    assert events.count("nan_origin") >= 1
    assert all(r._state == "stopped" for r in reps) and len(reps) == 2
    snap = c.metrics.snapshot()
    assert snap["nan_vetoes_total"] == 1 and snap["promotes_total"] == 1
    assert "hydragnn_canary_promotes_total 1" in c.metrics.render_prometheus()
    # the canary never entered the router's capacity count
    coord.write_json(os.path.join(coord_dir, "fleet.json"),
                     {"live": 0, "target": 1, "degraded": True, "ts": time.time()})
    assert FleetRouter(coord_dir, scan_interval_s=0.0).live_replicas() == []
    with pytest.raises(ServerOverloaded):
        FleetRouter(coord_dir, scan_interval_s=0.0).route(graphs[0])


# ---- the autoscaler over one synthetic load trace ----------------------------------


class _Fleet:
    def __init__(self, coord_dir, target=2):
        self.coord_dir, self.target, self.resizes = coord_dir, target, []

    def resize(self, n, reason="manual"):
        self.resizes.append((self.target, n, reason))
        self.target = n
        return n


def _run_trace(mod, coord_dir):
    """A two-day diurnal trace with a shed burst and a degraded stretch;
    every tick's decision record."""
    rng = np.random.default_rng(5)
    fleet = _Fleet(coord_dir)
    counters = {"requests_total": 0, "shed_total": 0,
                "deadline_met_total": 0, "deadline_missed_total": 0}
    policy = mod.AutoscalePolicy(min_replicas=1, max_replicas=6, capacity_rps=20.0,
                                 up_cooldown_s=600.0, down_cooldown_s=3600.0,
                                 period_s=86400.0, n_phases=24)
    scaler = mod.FleetAutoscaler(fleet, lambda: dict(counters), policy=policy, interval_s=1.0)
    out = []
    for step in range(2 * 288):
        now = 1.7e9 + step * 300.0
        rate = 40.0 + 35.0 * math.sin(2 * math.pi * (now % 86400) / 86400)
        n = int(rng.poisson(rate * 300.0))
        counters["requests_total"] += n
        missed = int(n * (0.1 if 200 <= step < 210 else 0.01))
        counters["deadline_met_total"] += n - missed
        counters["deadline_missed_total"] += missed
        if 400 <= step < 404:
            counters["shed_total"] += 5
        if step in (0, 450, 470):  # the supervisor's status turns degraded and back
            coord.write_json(os.path.join(coord_dir, "fleet.json"),
                             {"degraded": 450 <= step < 470})
        out.append(scaler.tick(now))
    forecast = [round(scaler.forecast.forecast(1.7e9 + h * 3600.0), 9) for h in range(24)]
    return out, fleet.resizes, forecast


def pytest_autoscaler_follows_jax_over_a_load_trace(tmp_path):
    ours = _run_trace(port_autoscale, str(tmp_path))
    theirs = _run_trace(jax_autoscale, str(tmp_path))
    assert ours == theirs
    decisions, resizes, _ = ours
    assert decisions[0] is None
    reasons = {r for _, _, r in resizes}
    assert {"forecast", "slo_pressure", "scale_down"} <= reasons, resizes


def pytest_load_forecast_as_jax():
    ours, theirs = LoadForecast(0.4, 600.0, 6), jax_autoscale.LoadForecast(0.4, 600.0, 6)
    assert ours.forecast(0.0) == theirs.forecast(0.0) == 0.0
    rng = np.random.default_rng(6)
    for t in np.sort(rng.uniform(0, 3000, 200)):
        rps = float(rng.gamma(2.0, 10.0))
        ours.observe(rps, t)
        theirs.observe(rps, t)
        assert ours.forecast(t, 100.0) == theirs.forecast(t, 100.0)


AUTOSCALE_KNOBS = {
    "HYDRAGNN_AUTOSCALE_MIN": "2", "HYDRAGNN_AUTOSCALE_MAX": "9",
    "HYDRAGNN_AUTOSCALE_CAPACITY_RPS": "12.5", "HYDRAGNN_AUTOSCALE_SLO_BUDGET": "0.2",
    "HYDRAGNN_AUTOSCALE_UP_COOLDOWN_S": "3", "HYDRAGNN_AUTOSCALE_DOWN_COOLDOWN_S": "30",
    "HYDRAGNN_AUTOSCALE_PERIOD_S": "600",
}


@pytest.mark.parametrize("knob", [None] + sorted(AUTOSCALE_KNOBS))
def pytest_autoscale_policy_from_env_as_jax(monkeypatch, knob):
    for k in list(AUTOSCALE_KNOBS) + ["HYDRAGNN_AUTOSCALE_INTERVAL_S"]:
        monkeypatch.delenv(k, raising=False)
    if knob is not None:
        monkeypatch.setenv(knob, AUTOSCALE_KNOBS[knob])
    ours, theirs = AutoscalePolicy.from_env(), jax_autoscale.AutoscalePolicy.from_env()
    assert ours.__dict__ == theirs.__dict__
    monkeypatch.setenv("HYDRAGNN_AUTOSCALE_INTERVAL_S", "2.5")
    assert FleetAutoscaler(_Fleet("/x"), dict).interval_s == 2.5
    monkeypatch.setenv("HYDRAGNN_AUTOSCALE_MIN", "0")
    with pytest.raises(ValueError, match="HYDRAGNN_AUTOSCALE_MIN"):
        AutoscalePolicy.from_env()


# ---- the training side: publish_dir ------------------------------------------------


@pytest.mark.parametrize("case", ["config", "env_every", "env_keep_async"])
def pytest_run_training_publishes_candidates_the_jax_channel_reads(raw_dirs, tmp_path,
                                                                   monkeypatch, case):
    """A 3-epoch CPU ``run_training`` with ``publish_dir`` (or
    ``HYDRAGNN_PUBLISH_DIR``), ``HYDRAGNN_PUBLISH_EVERY`` and
    ``HYDRAGNN_PUBLISH_KEEP`` (with the async writer): the JAX
    ``CandidateChannel`` reads the manifests, and each snapshot loads
    strictly."""
    import copy

    import hydragnn_tpu_torch
    from hydragnn_tpu.serve.registry import CandidateChannel as JaxCandidateChannel
    from hydragnn_tpu_torch.serve import ModelRegistry

    for k in ("HYDRAGNN_PUBLISH_DIR", "HYDRAGNN_PUBLISH_EVERY", "HYDRAGNN_PUBLISH_KEEP",
              "HYDRAGNN_ASYNC_CKPT"):
        monkeypatch.delenv(k, raising=False)
    _in_dir(monkeypatch, tmp_path / "run")
    chan = str(tmp_path / "chan")
    config = copy.deepcopy(raw_dirs)
    training = config["NeuralNetwork"]["Training"]
    training["num_epoch"] = 3
    if case == "config":
        training["publish_dir"] = chan
        want_epochs = [0, 1, 2]
    elif case == "env_every":
        monkeypatch.setenv("HYDRAGNN_PUBLISH_DIR", chan)
        monkeypatch.setenv("HYDRAGNN_PUBLISH_EVERY", "2")
        want_epochs = [1]
    else:
        training["publish_dir"] = chan
        training["async_checkpoint"] = True
        monkeypatch.setenv("HYDRAGNN_PUBLISH_KEEP", "1")
        want_epochs = [2]
    state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
    name = state.info["log_name"]
    pending = JaxCandidateChannel(chan).pending()
    assert [m["epoch"] for m in pending] == want_epochs
    assert [m["seq"] for m in pending] == ([1, 2, 3] if case == "config" else
                                           [1] if case == "env_every" else [3])
    history = {h["epoch"]: h["val_loss"] for h in state.info["history"]}
    for m in pending:
        assert m["checkpoint"] == name and m["val_loss"] == pytest.approx(history[m["epoch"]])
        entry = ModelRegistry().load_checkpoint(name, path=m["path"], device="cpu")
        assert entry.version == 1
    assert CandidateChannel(chan).latest_seq() == pending[-1]["seq"]
