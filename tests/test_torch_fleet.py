"""Port parity: the serving fleet (``coord.py``, ``serve/fleet.py``,
``serve/router.py``, the fleet's fault hooks and env builders) against the
JAX package's, with inputs made from a numpy seed.

- Pure functions equal the JAX package's exactly: ``lease_serving``,
  ``dead_members`` and ``highest_cmd`` over the same files, ``RetryBudget``
  over one script, ``backoff_delay`` from the same ``random`` state, and
  the replica and candidate fault hooks.
- Coordination files (leases, tombstones, ``cmd-*``, ``ack-*``,
  ``active.json``, ``result-*``) written by one package read the same in
  the other: a JAX ``ServingFleet`` promotes and rolls back a port replica.
- A port ``ReplicaServer`` (PNA at hidden 16, on the CPU) answers
  ``/predict`` for graphs the JAX package's ``encode_graph`` wrote, as the
  JAX ``InferenceServer`` answers them on the same weights (rtol 1e-4,
  atol 1e-5, ``test_torch_serve.py``'s).
- In process, as the JAX tier-1 fleet tests run: the promote, the corrupt
  candidate's rollback and the operator's rollback under load (no failed
  request, no micro-batch mixing versions, pass 1 compiling one program a
  bucket); the supervisor's heal of an exit and of a wedge with stubbed
  spawns; degraded shedding.
- One replica process on the CPU boots to a serving lease, answers, is
  SIGKILLed and answers again at incarnation 1 (~6 s on one worker); the
  CLI's supervisor serves one replica and exits 0 on SIGTERM. The
  two-replica run of the smoke's fleet phase on the CPU is ``slow``.
- Each env builder the fleet calls reads each of its knobs.
"""

import json
import os
import pickle
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from hydragnn_tpu import coord as jax_coord
from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.obs.events import validate_events as jax_validate_events
from hydragnn_tpu.serve import fleet as jax_fleet
from hydragnn_tpu.serve import router as jax_router
from hydragnn_tpu.utils import faults as jax_faults
from hydragnn_tpu.utils import retry as jax_retry

from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.bridge import flax_variables_of
from hydragnn_tpu_torch.obs import Tracer
from hydragnn_tpu_torch.obs.events import validate_events
from hydragnn_tpu_torch.ops import KERNELS
from hydragnn_tpu_torch.serve import (
    DeadlineExceeded,
    FeedbackSink,
    FleetRouter,
    InferenceServer,
    ModelRegistry,
    ReplicaServer,
    ResponseCache,
    RetryBudget,
    ServerOverloaded,
    ServingFleet,
    TenantManager,
    plan_from_samples,
)
from hydragnn_tpu_torch.serve import fleet, router as port_router
from hydragnn_tpu_torch.serve.fleet import REPLICA, build_server_from_spec
from hydragnn_tpu_torch.serve.router import NoLiveReplica
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.retry import backoff_delay

from test_torch_pna import arch
from test_torch_serve import ATOL, PLAN_SIZES, REQUEST_SIZES, RTOL, _graphs, _jax_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=8, layers=2)
PROCESS_DEADLINE_S = 90.0  # the replica-process test's own bound (a loaded host boots slower)


# ---- shared harness (the canary tests import it) -------------------------------


def tiny_model(seed, bump=0.0):
    """PNA at hidden 8, 2 conv layers, on the CPU, weights from ``seed``
    (plus ``bump`` on every parameter)."""
    model = create_model_config(arch(**TINY), device="cpu", seed=seed)
    if bump:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(bump)
    return model


def save_checkpoint(model, name, path):
    """A v2 checkpoint of ``model``'s weights and statistics (what a
    registry's strict loader reads)."""
    variables = flax_variables_of(model)
    ckpt.save_model({"params": variables["params"], "batch_stats": variables["batch_stats"]},
                    name, path=str(path))


def corrupt_copy(path, src, dst):
    """``<path>/<dst>/<dst>.pk``: ``src``'s checkpoint with its middle byte
    flipped."""
    raw = bytearray(open(os.path.join(path, src, f"{src}.pk"), "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    os.makedirs(os.path.join(path, dst), exist_ok=True)
    with open(os.path.join(path, dst, f"{dst}.pk"), "wb") as f:
        f.write(bytes(raw))


def tiny_plan():
    return plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=4)


def tiny_server(ckdir, name="base", **kw):
    registry = ModelRegistry()
    registry.load_checkpoint(name, arch_config=arch(**TINY), path=str(ckdir), name="m",
                             device="cpu")
    kw.setdefault("max_wait_s", 0.002)
    return InferenceServer(registry, tiny_plan(), default_model="m", device="cpu", **kw)


def tiny_replica(ckdir, coord_dir, rid=0, **kw):
    return ReplicaServer(tiny_server(ckdir), str(coord_dir), rid, heartbeat_s=0.05,
                         model_name="m", arch_config=arch(**TINY), poll_s=0.02, **kw)


def write_spec(tmp_path, ckdir, **extra):
    """A fleet spec for the tiny model on the CPU (its samples pickled)."""
    samples = str(tmp_path / "samples.pkl")
    with open(samples, "wb") as f:
        pickle.dump(_graphs(GraphData, PLAN_SIZES, 0), f)
    spec = {"checkpoint": {"name": "base", "path": str(ckdir)}, "arch": arch(**TINY),
            "model_name": "m", "samples": samples, "plan": {"max_batch_graphs": 4},
            "server": {"max_wait_s": 0.002}, "device": "cpu"}
    spec.update(extra)
    path = str(tmp_path / "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ---- pure functions against the JAX package's ---------------------------------


def _random_leases(rng, n=60):
    now = 1000.0
    out = []
    for _ in range(n):
        lease = {"ts": now - float(rng.uniform(0, 3)), "gen": int(rng.integers(0, 3))}
        if rng.random() < 0.8:
            lease["state"] = str(rng.choice(["serving", "starting", "draining", "stopped"]))
        if rng.random() < 0.3:
            lease["done"] = bool(rng.integers(0, 2))
        if rng.random() < 0.1:
            lease.pop("ts")
        out.append(lease)
    return now, out + [None]


def pytest_lease_serving_matches_jax():
    now, leases = _random_leases(np.random.default_rng(0))
    for lease in leases:
        for lease_s in (0.5, 2.0):
            assert fleet.lease_serving(lease, lease_s, now) == jax_fleet.lease_serving(
                lease, lease_s, now)
    assert sum(fleet.lease_serving(lease, 2.0, now) for lease in leases) > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def pytest_coord_files_read_the_same_in_both_packages(tmp_path, writer):
    """Leases, tombstones and promote commands written by one package:
    ``dead_members``, ``heartbeat_age``, ``read_tombstone`` and
    ``highest_cmd`` give the same answers in both."""
    w, r = (coord, jax_coord) if writer == "port" else (jax_coord, coord)
    d = str(tmp_path)
    rng = np.random.default_rng(1)
    now, leases = _random_leases(rng, 12)
    for m, lease in enumerate(leases[:-1]):
        w.write_json(w.hb_path(d, REPLICA, m, prefix=REPLICA), lease)
    w.write_tombstone(d, 3, reason="wedged", by=-1, prefix=REPLICA)
    w.write_tombstone(d, 3, reason="second", by=-1, prefix=REPLICA)  # first write wins
    assert coord.hb_path(d, REPLICA, 4, prefix=REPLICA) == jax_coord.hb_path(
        d, REPLICA, 4, prefix=REPLICA)
    members = list(range(14))
    for gen in (None, 1):
        got = [mod.dead_members(d, members, 2.0, kind=REPLICA, now=now, current_gen=gen,
                                prefix=REPLICA) for mod in (coord, jax_coord)]
        assert got[0] == got[1]
    assert r.read_tombstone(d, 3, prefix=REPLICA)["reason"] == "wedged"
    for m in members:
        assert coord.heartbeat_age(d, REPLICA, m, now=now, prefix=REPLICA) == \
            jax_coord.heartbeat_age(d, REPLICA, m, now=now, prefix=REPLICA)
    r.clear_tombstone(d, 3, prefix=REPLICA)
    assert w.read_tombstone(d, 3, prefix=REPLICA) is None
    pdir = os.path.join(d, "promote")
    for c in (1, 2, 3, 5):
        w.write_json(os.path.join(pdir, f"cmd-{c:06d}.json"), {"cmd_id": c})
    assert fleet.highest_cmd(pdir) == jax_fleet.highest_cmd(pdir) == 3
    assert fleet.highest_cmd(str(tmp_path / "none")) == 0


def pytest_retry_budget_matches_jax():
    rng = np.random.default_rng(2)
    ours, theirs = RetryBudget(ratio=0.3, reserve=3.0), jax_router.RetryBudget(0.3, 3.0)
    for op in rng.integers(0, 2, 200):
        if op:
            assert ours.try_acquire() == theirs.try_acquire()
        else:
            ours.on_success()
            theirs.on_success()
        assert ours.tokens == theirs.tokens
    for bad in (dict(ratio=-1), dict(reserve=0)):
        with pytest.raises(ValueError):
            RetryBudget(**bad)


def pytest_backoff_delay_matches_jax():
    for attempt in range(5):
        random.seed(attempt)
        ours = [backoff_delay(attempt, 0.05) for _ in range(10)]
        random.seed(attempt)
        theirs = [jax_retry.backoff_delay(attempt, 0.05) for _ in range(10)]
        assert ours == theirs
        lo = 0.05 * 2.0 ** attempt
        assert all(lo <= d <= lo * 1.5 + 1e-12 for d in ours)


def _hook_trace(mod, monkeypatch, hook, tmp_path):
    """What one fault hook does over a scripted run of calls, with its
    exits and sleeps recorded instead of taken."""
    exits, sleeps = [], []
    monkeypatch.setattr(os, "_exit", exits.append)
    monkeypatch.setattr(time, "sleep", sleeps.append)
    mod.reset()
    out = []
    if hook == "kill":
        for spec, rid in (("1:1", "0"), ("0:2", "0"), ("3", "0"), ("2:3", "2")):
            monkeypatch.setenv("HYDRAGNN_FLEET_REPLICA", rid)
            monkeypatch.setenv("HYDRAGNN_FAULT_KILL_REPLICA_AT_REQUEST", spec)
            mod.reset()
            for _ in range(4):
                mod.kill_replica_at_request()
            out.append(list(exits))
    elif hook == "slow":
        for spec, rid in (("1:3@0.2", "1"), ("0:3@0.2", "1"), ("5", "0"), ("2:0:3@0.1", "2")):
            monkeypatch.setenv("HYDRAGNN_FLEET_REPLICA", rid)
            monkeypatch.setenv("HYDRAGNN_FAULT_SLOW_REPLICA", spec)
            for i in range(7):
                mod.slow_replica(i)
            out.append(list(sleeps))
    elif hook == "candidate":
        for spec in ("2", "all"):
            monkeypatch.setenv("HYDRAGNN_FAULT_NAN_CANDIDATE", spec)
            out.append([mod.nan_candidate(k) for k in (1, 2, 3)])
        for spec in ("3@0.1", "0:2@0.2", "5"):
            monkeypatch.setenv("HYDRAGNN_FAULT_SLOW_CANDIDATE", spec)
            for i in range(6):
                mod.slow_candidate(i)
        out.append(list(sleeps))
    elif hook == "corrupt":
        src = tmp_path / f"{mod.__name__}.pk"
        src.write_bytes(bytes(range(64)))
        monkeypatch.setenv("HYDRAGNN_FAULT_CORRUPT_CANDIDATE", "2")
        paths = [mod.corrupt_candidate(str(src)) for _ in range(3)]
        out.append([p == str(src) for p in paths])
        out.append(open(paths[1], "rb").read())
        assert src.read_bytes() == bytes(range(64))
    elif hook == "shift":
        for spec, rid, only in (("2:4@2.0", "0", None), ("1@0.5", "1", "0"), (":2", "1", "1")):
            monkeypatch.setenv("HYDRAGNN_FLEET_REPLICA", rid)
            monkeypatch.setenv("HYDRAGNN_FAULT_SHIFT_INPUTS", spec)
            if only is None:
                monkeypatch.delenv("HYDRAGNN_FAULT_SHIFT_REPLICA", raising=False)
            else:
                monkeypatch.setenv("HYDRAGNN_FAULT_SHIFT_REPLICA", only)
            for i in range(5):
                g = _graphs(GraphData, [5], i)[0]
                x, pos = g.x.copy(), g.pos.copy()
                mod.shift_inputs(g, i)
                out.append((float(np.max(g.x / x)), float(np.max(g.pos / pos))))
    mod.reset()
    return out


@pytest.mark.parametrize("hook", ["kill", "slow", "candidate", "corrupt", "shift"])
def pytest_fault_hooks_match_jax(monkeypatch, tmp_path, hook):
    for name in ("KILL_REPLICA_AT_REQUEST", "SLOW_REPLICA", "NAN_CANDIDATE", "SLOW_CANDIDATE",
                 "CORRUPT_CANDIDATE", "SHIFT_INPUTS", "SHIFT_REPLICA"):
        monkeypatch.delenv(f"HYDRAGNN_FAULT_{name}", raising=False)
    assert faults.corrupt_candidate("x") == "x" and faults.shift_inputs(7, 0) == 7
    assert not faults.nan_candidate(1)
    ours = _hook_trace(faults, monkeypatch, hook, tmp_path)
    theirs = _hook_trace(jax_faults, monkeypatch, hook, tmp_path)
    assert ours == theirs and any(ours)


# ---- the wire and a replica's answers ------------------------------------------


def pytest_wire_format_both_ways():
    jg = _graphs(JaxGraphData, [6], 3)[0]
    jg.edge_attr = np.random.default_rng(4).random((jg.num_edges, 2)).astype(np.float32)
    g = fleet.decode_graph(json.loads(json.dumps(jax_fleet.encode_graph(jg))))
    assert type(g) is GraphData
    for field in ("x", "pos", "edge_index", "edge_attr"):
        np.testing.assert_array_equal(getattr(g, field), getattr(jg, field))
        assert getattr(g, field).dtype == getattr(jg, field).dtype
    assert fleet.encode_graph(g) == jax_fleet.encode_graph(jg)
    back = jax_fleet.decode_graph(json.loads(json.dumps(fleet.encode_graph(g))))
    np.testing.assert_array_equal(back.x, g.x)


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def pytest_replica_answers_jax_encoded_graphs_as_the_jax_server(tmp_path):
    """The port replica's ``/predict`` (and a router in front of it) on
    JAX-encoded graphs, against the JAX ``InferenceServer`` on the same
    weights (carried by ``models/bridge.py``)."""
    ref = _jax_reference()
    model = create_model_config(ref["cfg"], device="cpu")
    load_flax_variables(model, ref["variables"])
    ckdir = tmp_path / "ck"
    save_checkpoint(model, "base", ckdir)
    registry = ModelRegistry()
    registry.load_checkpoint("base", arch_config=ref["cfg"], path=str(ckdir), name="pna",
                             device="cpu")
    server = InferenceServer(registry, tiny_plan(), default_model="pna", device="cpu",
                             max_wait_s=0.002)
    rep = ReplicaServer(server, str(tmp_path / "coord"), 0, heartbeat_s=0.05)
    rep.start()
    try:
        port = rep.address[1]
        requests = _graphs(JaxGraphData, REQUEST_SIZES, 1)
        router = FleetRouter(str(tmp_path / "coord"), target_replicas=1, scan_interval_s=0.05)
        for jg, want in zip(requests, ref["answers"]):
            body = _post(port, {"graph": jax_fleet.encode_graph(jg)})
            assert body["version"] == 1 and body["replica"] == 0 and body["model"] == "pna"
            routed = router.route(fleet.decode_graph(jax_fleet.encode_graph(jg)), deadline_s=30)
            for got in (body["heads"], routed):
                for h, w in zip(got, want):
                    np.testing.assert_allclose(np.asarray(h, np.float32), np.asarray(w),
                                               rtol=RTOL, atol=ATOL)
        health = json.load(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz"))
        assert health["replica"] == 0 and health["state"] == "serving"
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics").read().decode()
        assert "hydragnn_serve_requests_total" in text
        with pytest.raises(RuntimeError, match="answered 400"):
            router.route(_graphs(GraphData, [5], 2)[0], model="nope", deadline_s=10)
        assert router.metrics.snapshot()["deadline_met_total"] == len(requests)
    finally:
        rep.shutdown()
    lease = coord.read_json(coord.hb_path(str(tmp_path / "coord"), REPLICA, 0, prefix=REPLICA))
    assert lease["done"] and lease["state"] == "stopped"
    assert jax_coord.dead_members(str(tmp_path / "coord"), [0], 0.0, kind=REPLICA,
                                  prefix=REPLICA) == {}


# ---- hot-swap in process ---------------------------------------------------------


class _Pump:
    """Closed-loop routed load from two threads, every outcome recorded."""

    def __init__(self, router, seed):
        self.router, self.seed = router, seed
        self.stop = threading.Event()
        self.responses, self.failures = [], []
        self.lock = threading.Lock()
        self.threads = [threading.Thread(target=self._run, args=(seed + i,)) for i in range(2)]

    def _run(self, seed):
        rng = np.random.default_rng(seed)
        while not self.stop.is_set():
            g = _graphs(GraphData, [int(rng.integers(4, 11))], int(rng.integers(1 << 30)))[0]
            try:
                raw = self.router.route(g, deadline_s=30.0, raw=True)
                with self.lock:
                    self.responses.append((raw["batch_seq"], raw["version"]))
            except Exception as e:  # any failure breaks the promise
                with self.lock:
                    self.failures.append(repr(e))

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=30.0)


def pytest_jax_supervisor_promotes_and_rolls_back_a_port_replica(tmp_path):
    """The JAX ``ServingFleet`` writes the command, the port replica loads,
    warms (one compile a bucket, then none) and acks, the JAX supervisor
    publishes ``active.json`` and ``result-*``; the port supervisor's
    promote of a corrupt candidate rolls back with the good version
    serving; an operator rollback returns to the base. Under load: no
    failed request, no micro-batch mixing versions."""
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    save_checkpoint(tiny_model(1), "cand", ckdir)
    corrupt_copy(str(ckdir), "cand", "broken")
    d = str(tmp_path / "coord")
    rep = tiny_replica(ckdir, d)
    rep.start()
    registry = rep.server.registry
    jax_sup = jax_fleet.ServingFleet(d, 1, worker_cmd=["true"], poll_s=0.02,
                                     log_dir=str(tmp_path / "jlog"))
    port_sup = ServingFleet(d, 1, worker_cmd=["true"], poll_s=0.02, log_dir=str(tmp_path / "log"))
    for sub in ("replicas", "dead", "promote"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    try:
        router = FleetRouter(d, target_replicas=1, scan_interval_s=0.05)
        g = _graphs(GraphData, [8], 5)[0]
        before = router.route(g, deadline_s=30.0, raw=True)
        assert before["version"] == 1
        with _Pump(router, 10) as pump:
            res = jax_sup.promote("cand", path=str(ckdir), arch_config=arch(**TINY), timeout=60)
            assert res["status"] == "promoted" and res["propagated"], res
            assert res["acks"][0]["compiles"] == rep.server.plan.num_buckets
            assert res["acks"][0]["later_pass_compiles"] == 0
            assert registry.get("m").version == 2
            assert coord.read_json(os.path.join(d, "promote", "result-000001.json")) == \
                json.loads(json.dumps(res))
            after = router.route(g, deadline_s=30.0, raw=True)
            assert after["version"] == 2
            np.testing.assert_allclose(np.asarray(after["heads"][0]),
                                       rep.server.predict(g, model="m", timeout=30)[0], atol=1e-6)
            assert not np.allclose(after["heads"][0], before["heads"][0])
            # the port supervisor carries on the JAX supervisor's sequence
            port_sup.start(wait_serving=False)
            bad = port_sup.promote("broken", path=str(ckdir), arch_config=arch(**TINY),
                                   timeout=60)
            assert bad["status"] == "rolled_back" and bad["cmd_id"] == 2
            assert "corrupt" in bad["reason"], bad
            assert registry.get("m").version == 2
            assert router.route(g, deadline_s=30.0, raw=True)["version"] == 2
            back = port_sup.rollback(reason="operator")
            assert back["cmd_id"] == 0
            wait_for(lambda: registry.get("m").version == 1, 20, "the rollback")
        assert pump.failures == [] and pump.responses
        by_batch = {}
        for seq, version in pump.responses:
            by_batch.setdefault(seq, set()).add(version)
        assert all(len(v) == 1 for v in by_batch.values()), by_batch
        assert {v for s in by_batch.values() for v in s} <= {1, 2}
        active = jax_coord.read_json(os.path.join(d, "promote", "active.json"))
        assert active["cmd_id"] == 0 and active["seq"] == 2
    finally:
        port_sup.stop()
        jax_sup.events.close()
        rep.shutdown()
    recs = jax_validate_events(str(tmp_path / "log" / "events.jsonl"),
                               require=["model_rollback"])
    assert [r["cmd_id"] for r in recs if r["event"] == "model_rollback"] == [2, 0]
    validate_events(str(tmp_path / "jlog" / "events.jsonl"), require=["model_promoted"])


def pytest_final_lease_carries_the_replicas_device_work(tmp_path):
    """The lease reports the replica's micro-batches, captures and kernel
    launches, and its final (``done``) write holds them with the batcher
    stopped. On the CPU the wrappers run their plain versions and count no
    launch; on the card each process must show (batches + compiles) times
    one forward's launches (the smoke's fleet phase holds it)."""
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    d = str(tmp_path / "coord")
    rep = tiny_replica(ckdir, d)
    rep.start()
    try:
        router = FleetRouter(d, target_replicas=1, scan_interval_s=0.05)
        for g in _graphs(GraphData, REQUEST_SIZES, 7):
            router.route(g, deadline_s=30.0)
        live = coord.read_json(coord.hb_path(d, REPLICA, 0, prefix=REPLICA))
        assert not live["done"] and set(live["launches"]) == set(KERNELS)
    finally:
        rep.shutdown()
    lease = coord.read_json(coord.hb_path(d, REPLICA, 0, prefix=REPLICA))
    snap = rep.server.metrics.snapshot()
    assert lease["done"] and lease["state"] == "stopped"
    assert lease["batches"] == snap["batches_total"] > 0
    assert lease["compiles"] == snap["compiles_total"] == rep.server.plan.num_buckets
    assert lease["launches"] == {name: 0 for name in KERNELS}


def pytest_respawned_replica_adopts_the_active_and_keeps_its_base(tmp_path):
    """A replica booting after a resolved promote never replays old
    commands, adopts the published candidate, and keeps the version it
    booted with as the rollback base."""
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    save_checkpoint(tiny_model(1), "cand", ckdir)
    d = str(tmp_path / "coord")
    pdir = os.path.join(d, "promote")
    jax_coord.write_json(os.path.join(pdir, "cmd-000001.json"),
                         {"cmd_id": 1, "checkpoint": "cand", "path": str(ckdir)})
    jax_coord.write_json(os.path.join(pdir, "active.json"),
                         {"seq": 1, "cmd_id": 1, "latest_cmd": 1})
    rep = tiny_replica(ckdir, d)
    rep.start()
    try:
        assert rep.server.registry.get("m").version == 2
        assert rep._warmed[0] == ("m", 1) and rep._last_cmd_handled == 1
        jax_coord.write_json(os.path.join(pdir, "active.json"),
                             {"seq": 2, "cmd_id": 0, "latest_cmd": 1})
        wait_for(lambda: rep.server.registry.get("m").version == 1, 20, "the base")
    finally:
        rep.shutdown()


# ---- the supervisor, with stubbed spawns ------------------------------------------


class _FakeProc:
    def __init__(self, rc=None):
        self.rc, self.pid, self.killed = rc, 4242, False

    def poll(self):
        return self.rc

    def kill(self):
        self.killed, self.rc = True, -9

    def wait(self, timeout=None):
        return self.rc


def pytest_supervisor_heals_exit_and_wedge_and_prices_events(tmp_path):
    d = str(tmp_path / "coord")
    sup = ServingFleet(d, 2, worker_cmd=["true"], lease_s=0.5, poll_s=0.05,
                       log_dir=str(tmp_path / "log"))
    for sub in ("replicas", "dead", "promote"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    spawned = []

    def spawn(h):
        spawned.append((h.rid, h.incarnation))
        h.proc, h.spawned_ts, h.was_serving = _FakeProc(), time.time(), False

    sup._spawn = spawn
    h0, h1 = sup._replicas[0], sup._replicas[1]
    h0.proc, h1.proc = _FakeProc(), _FakeProc()
    now = time.time()
    for rid in (0, 1):
        coord.write_json(coord.hb_path(d, REPLICA, rid, prefix=REPLICA),
                         {"ts": now, "gen": 0, "state": "serving", "port": 1000 + rid})
    sup._tick(now)
    assert sup.metrics.snapshot()["live_replicas"] == 2.0
    h0.proc.rc = -9  # replica 0 exits; replica 1 wedges (stale lease, alive)
    wedged = h1.proc
    coord.write_json(coord.hb_path(d, REPLICA, 1, prefix=REPLICA),
                     {"ts": now - 60, "gen": 0, "state": "serving", "port": 1001})
    sup._tick(now + 1.0)
    assert spawned == [(0, 1), (1, 1)] and wedged.killed
    snap = sup.metrics.snapshot()
    assert snap["replica_losses_total"] == 2 and snap["degraded"] == 1.0
    sup._tick(now + 1.5)  # the old incarnation's lease reads as booting
    assert sup.metrics.snapshot()["replica_losses_total"] == 2
    h0.proc.rc = 1  # the new replica 0 dies before serving: backoff, not a storm
    sup._tick(now + 1.6)
    assert h0.respawn_at == pytest.approx(now + 1.6 + 0.5) and len(spawned) == 2
    sup._tick(now + 2.2)
    assert spawned[-1] == (0, 2)
    for rid, gen in ((0, 2), (1, 1)):
        coord.write_json(coord.hb_path(d, REPLICA, rid, prefix=REPLICA),
                         {"ts": now + 2.5, "gen": gen, "state": "serving", "port": 2000 + rid})
    sup._tick(now + 2.5)
    snap = sup.metrics.snapshot()
    assert snap["replica_respawns_total"] == 2 and snap["live_replicas"] == 2.0
    assert snap["degraded"] == 0.0 and snap["last_recovery_seconds"] > 0
    assert sup.health()["status"] == "ok"
    sup.events.close()
    recs = jax_validate_events(str(tmp_path / "log" / "events.jsonl"),
                               require=["replica_lost", "replica_respawned", "fleet_degraded"])
    lost = [r for r in recs if r["event"] == "replica_lost"]
    assert {r["reason"] for r in lost} == {"exit_-9", "lease_expired", "exit_1"}
    assert all(r["downtime_s"] > 0 for r in recs if r["event"] == "replica_respawned")
    assert jax_coord.read_json(os.path.join(d, "fleet.json"))["live"] == 2


# ---- the router's admission ------------------------------------------------------


def pytest_router_sheds_with_retry_after_when_fleet_empty(tmp_path):
    router = FleetRouter(str(tmp_path), target_replicas=2, scan_interval_s=0.0)
    g = _graphs(GraphData, [8], 0)[0]
    with pytest.raises(ServerOverloaded) as exc:
        router.route(g)
    assert exc.value.retry_after_s > 0 and router.metrics.shed_total == 1
    with pytest.raises(ValueError, match="unknown lane"):
        router.route(g, lane="nope")
    assert router.autoscale_signals()["shed_total"] == 1


def pytest_router_degraded_sheds_low_priority_lane_only(tmp_path):
    d = str(tmp_path)
    jax_coord.write_json(jax_coord.hb_path(d, REPLICA, 0, prefix=REPLICA),
                         {"ts": time.time(), "state": "serving", "port": 1, "replica": 0})
    jax_coord.write_json(os.path.join(d, "fleet.json"),
                         {"live": 1, "target": 2, "degraded": True, "ts": time.time()})
    router = FleetRouter(d, lanes={"interactive": 0, "batch": 1}, shed_priority_when_degraded=1,
                         scan_interval_s=0.0, max_attempts=2, retry_base_delay_s=0.001)
    g = _graphs(GraphData, [8], 1)[0]
    with pytest.raises(ServerOverloaded) as exc:
        router.route(g, lane="batch")
    assert exc.value.retry_after_s > 0
    assert router.fleet_metrics.snapshot()["lane_shed_total"] == {"lane=batch": 1}
    with pytest.raises(NoLiveReplica):  # port 1 answers nothing: loud failure
        router.route(g, lane="interactive")
    assert router.fleet_metrics.snapshot()["replica_errors_total"] >= 1


# ---- one replica process ----------------------------------------------------------


def pytest_replica_process_boots_serves_dies_and_respawns(tmp_path):
    """``python -m hydragnn_tpu_torch.serve.fleet`` on the CPU: serving lease,
    an answer, SIGKILL, the respawn at incarnation 1, an answer again; ~8 s
    on one worker, within a deadline of :data:`PROCESS_DEADLINE_S`."""
    t0 = time.monotonic()
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    spec = write_spec(tmp_path, ckdir)
    d = str(tmp_path / "coord")
    sup = ServingFleet(d, 1, spec_path=spec, heartbeat_s=0.1, lease_s=0.75, poll_s=0.05,
                       env={"PYTHONPATH": REPO, "HYDRAGNN_DRIFT_WINDOW": "0"})
    assert "hydragnn_tpu_torch.serve.fleet" in sup.worker_cmd
    try:
        assert sup.start(wait_serving=True, timeout=PROCESS_DEADLINE_S).health()["live"] == 1
        router = FleetRouter(d, lease_s=0.75, scan_interval_s=0.05, max_attempts=8,
                             retry_base_delay_s=0.05)
        g = _graphs(GraphData, [7], 3)[0]
        first = router.route(g, deadline_s=10.0, raw=True)
        assert first["replica"] == 0 and first["version"] == 1
        os.kill(sup.replica_pid(0), signal.SIGKILL)
        wait_for(lambda: sup.metrics.snapshot()["replica_respawns_total"] >= 1,
                 max(PROCESS_DEADLINE_S - (time.monotonic() - t0), 1), "the respawn")
        assert sup._replicas[0].incarnation == 1
        again = router.route(g, deadline_s=10.0, raw=True)
        np.testing.assert_allclose(again["heads"][0], first["heads"][0], rtol=1e-6)
        lease = coord.read_json(coord.hb_path(d, REPLICA, 0, prefix=REPLICA))
        assert lease["gen"] == 1 and lease["state"] == "serving"
    finally:
        sup.stop()
    assert sup._replicas[0].proc.poll() is not None
    recs = validate_events(os.path.join(d, "events.jsonl"),
                           require=["replica_lost", "replica_respawned"])
    assert [r["replica"] for r in recs if r["event"] == "replica_lost"] == [0]


def pytest_cli_supervisor_serves_and_stops_on_sigterm(tmp_path):
    """``python -m hydragnn_tpu_torch.serve.fleet --spec --dir --replicas 1``:
    the supervisor's replica serves a routed request; SIGTERM drains it and
    the CLI exits 0 with the lease released."""
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    d = tmp_path / "coord"
    cmd = [sys.executable, "-m", "hydragnn_tpu_torch.serve.fleet", "--spec",
           write_spec(tmp_path, ckdir), "--dir", str(d), "--replicas", "1", "--heartbeat", "0.1",
           "--lease", "0.75"]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=REPO, HYDRAGNN_DRIFT_WINDOW="0"))
    try:
        wait_for(lambda: (coord.read_json(str(d / "fleet.json")) or {}).get("live") == 1,
                 PROCESS_DEADLINE_S, "the CLI's replica")
        router = FleetRouter(str(d), lease_s=0.75, scan_interval_s=0.05)
        raw = router.route(_graphs(GraphData, [6], 4)[0], deadline_s=10.0, raw=True)
        assert raw["replica"] == 0 and raw["version"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=PROCESS_DEADLINE_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    lease = coord.read_json(coord.hb_path(str(d), REPLICA, 0, prefix=REPLICA))
    assert lease["done"] and lease["state"] == "stopped"


def pytest_a_spec_without_a_device_refuses_the_cpu(tmp_path, monkeypatch):
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    with open(write_spec(tmp_path, ckdir)) as f:
        spec = json.load(f)
    server, arch_cfg, name = build_server_from_spec(spec)
    assert server.device == torch.device("cpu") and name == "m" and arch_cfg == arch(**TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec.pop("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server_from_spec(spec)


@pytest.mark.slow  # three replica processes and a canary on the CPU, ~2 min
def pytest_fleet_phase_of_the_smoke_on_the_cpu(tmp_path):
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--cpu-rehearsal",
                          "--only-fleet", "--workdir", str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert '{"fleet": ' in res.stdout


# ---- the env builders the fleet calls ----------------------------------------------


@pytest.mark.parametrize("knobs,spec,want", [
    ({}, None, None),
    ({}, {"enabled": True}, (1024, 64 << 20)),
    ({"HYDRAGNN_CACHE": "0"}, {"enabled": True}, None),
    ({"HYDRAGNN_CACHE": "1"}, None, (1024, 64 << 20)),
    ({"HYDRAGNN_CACHE": "1", "HYDRAGNN_CACHE_CAPACITY": "7",
      "HYDRAGNN_CACHE_MAX_BYTES": "4096"}, None, (7, 4096)),
    ({}, {"capacity": 3, "max_bytes": 99}, (3, 99)),
])
def pytest_response_cache_from_env(monkeypatch, knobs, spec, want):
    from hydragnn_tpu.serve.cache import ResponseCache as JaxResponseCache

    for k in ("HYDRAGNN_CACHE", "HYDRAGNN_CACHE_CAPACITY", "HYDRAGNN_CACHE_MAX_BYTES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    got, theirs = ResponseCache.from_env(spec), JaxResponseCache.from_env(spec)
    assert (None if got is None else (got.capacity, got.max_bytes)) == want
    assert (None if theirs is None else (theirs.capacity, theirs.max_bytes)) == want


def pytest_response_cache_from_env_refuses_bad_knobs(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_CACHE", "1")
    monkeypatch.setenv("HYDRAGNN_CACHE_CAPACITY", "0")
    with pytest.raises(ValueError, match="HYDRAGNN_CACHE_CAPACITY"):
        ResponseCache.from_env()


@pytest.mark.parametrize("raw,want", [(None, 0.0), ("0.25", 0.25), ("1", 1.0)])
def pytest_tracer_from_env(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("HYDRAGNN_TRACE_SAMPLE", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_TRACE_SAMPLE", raw)
    events = []
    tracer = Tracer.from_env(emit=lambda *a, **k: events.append(a))
    assert tracer.sample == want and tracer.enabled == (want > 0)
    monkeypatch.setenv("HYDRAGNN_TRACE_SAMPLE", "-1")
    with pytest.raises(ValueError, match="HYDRAGNN_TRACE_SAMPLE"):
        Tracer.from_env()


def pytest_feedback_sink_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("HYDRAGNN_FEEDBACK_DIR", raising=False)
    assert FeedbackSink.from_env() is None
    monkeypatch.setenv("HYDRAGNN_FEEDBACK_DIR", str(tmp_path))
    monkeypatch.setenv("HYDRAGNN_FEEDBACK_MAX_GRAPHS", "3")
    sink = FeedbackSink.from_env()
    from hydragnn_tpu.serve.quality import FeedbackSink as JaxFeedbackSink

    want = JaxFeedbackSink.from_env()
    assert sink.queue_dir == want.queue_dir == str(tmp_path)
    assert (sink.max_graphs, sink.max_packs, sink.min_unc) == (
        want.max_graphs, want.max_packs, want.min_unc) == (3, 16, 0.0)
    monkeypatch.setenv("HYDRAGNN_FEEDBACK_MAX_GRAPHS", "0")
    with pytest.raises(ValueError, match="HYDRAGNN_FEEDBACK_MAX_GRAPHS"):
        FeedbackSink.from_env()


def pytest_feedback_dir_per_process(tmp_path):
    from hydragnn_tpu_torch.serve.fleet import CANARY, REPLICA, feedback_dir

    # a replica's directory is the JAX package's replica<rid>
    assert feedback_dir(str(tmp_path), REPLICA, 1) == str(tmp_path / "replica1")
    # a canary's is its own: the JAX package's replica<rid> would be shared
    # with replica <rid>, whose first pack has the same name
    assert feedback_dir(str(tmp_path), CANARY, 1) == str(tmp_path / "canary1")
    assert feedback_dir(str(tmp_path), CANARY, 1) != feedback_dir(str(tmp_path), REPLICA, 1)


def pytest_is_warm_and_warm_tenant(tmp_path):
    ckdir = tmp_path / "ck"
    save_checkpoint(tiny_model(0), "base", ckdir)
    save_checkpoint(tiny_model(2), "aux", ckdir)
    server = tiny_server(ckdir)
    server.registry.load_checkpoint("aux", arch_config=arch(**TINY), path=str(ckdir),
                                    name="aux", device="cpu")
    server.tenants = TenantManager.from_specs([{"name": "acme", "model": "aux", "quota": 4}])
    assert not server.is_warm()
    with server:
        assert server.is_warm()
        server.registry.load_checkpoint("aux", arch_config=arch(**TINY), path=str(ckdir),
                                        name="aux", device="cpu")
        warm = server.warm_tenant("acme")
        assert warm == {"buckets": server.plan.num_buckets,
                        "first_pass_compiles": server.plan.num_buckets,
                        "later_pass_compiles": 0, "verified": True}
        assert server.warm_tenant("acme")["first_pass_compiles"] == 0
    with pytest.raises(ValueError, match="TenantManager"):
        tiny_server(ckdir).warm_tenant("acme")
