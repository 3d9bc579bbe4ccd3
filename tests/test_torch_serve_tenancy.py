"""Port parity: the rest of the single-replica server (``serve/cache.py``,
``tenants.py``, ``costs.py``, ``quality.py``, the registry's activation
listeners and candidate channel, and ``InferenceServer`` with all of them)
against the JAX package's, with inputs made from a numpy seed.

- ``canonical_graph_key`` gives the JAX package's hex digest, is the same
  for a node permutation and changes with one ULP of any float.
- ``ResponseCache``, ``TenantManager`` and ``CostLedger`` (on an injected
  clock) follow the JAX classes step by step over scripted calls.
- The candidate channel's manifests and pins are read by both packages.
- The ensemble scorer's variances (PNA at hidden 8, 2 conv layers, 3
  versions carried across by ``models/bridge.py``) agree with the JAX
  scorer's within rtol 1e-4 and atol 1e-6 * (max var + 1); dropout mode is
  exactly zero for PNA, drawn and repeatable for GAT, and leaves the
  served BatchNorm statistics bit for bit as they were.
- One sample of dropout mode, ``model(batch, sample=True)`` on a model in
  eval mode, is the JAX package's ``apply(train=True,
  mutable=["batch_stats"])`` on the same weights and batch (GAT with its
  dropout at 0, so that no draw enters; the forward tolerance of
  ``test_torch_gat_mfc_cgcnn.py``), and differs from the eval forward. With
  GAT's dropout at 0.25 and one fixed mask per shape put in place of the
  draws on both sides (flax's ``nn.Dropout`` and the port's
  ``attention_dropout``), it is JAX's train apply too: the port drops the
  same terms. GAT's
  K-sample variance is, bit for bit, that of a plain reference: a copy of
  the model in ``train()`` mode run K times on a generator seeded alike,
  then ``torch.var(correction=0)``.
- One ``InferenceServer(device="cpu")`` burst with tenants, the cache, the
  costs, the scorer, a tracer and ``observability_port=0``.
"""

import copy
import json
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.serve import ModelRegistry as JaxModelRegistry
from hydragnn_tpu.serve import plan_from_samples as jax_plan_from_samples
from hydragnn_tpu.serve import cache as jax_cache
from hydragnn_tpu.serve import costs as jax_costs
from hydragnn_tpu.serve import registry as jax_registry
from hydragnn_tpu.serve import tenants as jax_tenants
from hydragnn_tpu.serve.quality import UncertaintyScorer as JaxUncertaintyScorer

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.models.bridge import flax_variables_of
from hydragnn_tpu_torch.obs import RunEventLog, Tracer, build_traces, load_span_events
from hydragnn_tpu_torch.serve import (
    CandidateChannel,
    CostLedger,
    FeedbackSink,
    InferenceServer,
    ModelRegistry,
    ResponseCache,
    TenantManager,
    TenantOverQuota,
    UncertaintyScorer,
    canonical_graph_key,
    plan_from_samples,
)
from hydragnn_tpu_torch.serve import cache as port_cache
from hydragnn_tpu_torch.serve import costs as port_costs
from hydragnn_tpu_torch.serve import tenants as port_tenants
from hydragnn_tpu_torch.train import checkpoint as ckpt

from _torch_jax_init import cached_jax_init  # noqa: F401 (autouse)
from test_torch_gat_mfc_cgcnn import RTOL as FORWARD_RTOL
from test_torch_gat_mfc_cgcnn import ATOL as FORWARD_ATOL
from test_torch_gat_mfc_cgcnn import arch as stack_arch
from test_torch_gat_mfc_cgcnn import batches as stack_batches
from test_torch_gat_mfc_cgcnn import graphs as stack_graphs
from test_torch_gin_sage import jax_variables as jax_variables_with_stats
from test_torch_pna import arch, jax_variables
from test_torch_serve import PLAN_SIZES, REQUEST_SIZES, _graphs

UNC_RTOL, UNC_ATOL = 1e-4, 1e-6  # the latter times (max var + 1)


# ---- the cache key and the LRU -----------------------------------------------


def _keyed_graph(cls, pos, attr, perm=None):
    """Seven nodes, two with the same features (the WL round tells them
    apart by their wiring), 16 directed edges; ``perm`` relabels the nodes
    and reverses the edge columns."""
    rng = np.random.default_rng(11)
    n, m = 7, 16
    x = rng.random((n, 3)).astype(np.float32)
    x[5] = x[2]
    p = rng.random((n, 3)).astype(np.float32) if pos else None
    ei = rng.integers(0, n, (2, m)).astype(np.int64)
    ea = rng.random((m, 2)).astype(np.float32) if attr else None
    if perm is not None:
        inv = np.argsort(perm)  # new index of each old node
        x = x[perm]
        p = None if p is None else p[perm]
        ei = inv[ei][:, ::-1].copy()
        ea = None if ea is None else ea[::-1].copy()
    return cls(x=x, pos=p, edge_index=ei, edge_attr=ea)


@pytest.mark.parametrize("pos", [True, False])
@pytest.mark.parametrize("attr", [True, False])
def pytest_cache_key_is_the_jax_digest(pos, attr):
    g = _keyed_graph(GraphData, pos, attr)
    key = canonical_graph_key(g)
    assert key == jax_cache.canonical_graph_key(_keyed_graph(JaxGraphData, pos, attr))
    assert len(key) == 32
    perm = np.random.default_rng(3).permutation(7)
    permuted = _keyed_graph(GraphData, pos, attr, perm)
    assert not np.array_equal(permuted.x, g.x)
    assert canonical_graph_key(permuted) == key
    assert jax_cache.canonical_graph_key(_keyed_graph(JaxGraphData, pos, attr, perm)) == key
    for field in ("x", "pos", "edge_attr"):
        if getattr(g, field) is None:
            continue
        bumped = _keyed_graph(GraphData, pos, attr)
        arr = getattr(bumped, field)
        arr[1, 0] = np.nextafter(arr[1, 0], np.float32(2.0))  # one ULP
        assert canonical_graph_key(bumped) != key
    rewired = _keyed_graph(GraphData, pos, attr)
    rewired.edge_index[1, 0] = (rewired.edge_index[1, 0] + 1) % 7
    assert canonical_graph_key(rewired) != key


def _cache_script(mod):
    """Scripted puts and gets under an entry bound of 3 and a byte bound of
    200; the entries' order and the stats after every step."""
    cache = mod.ResponseCache(capacity=3, max_bytes=200)
    rng = np.random.default_rng(5)
    trail = []
    for step in range(40):
        key = mod.ResponseCache.key(f"g{int(rng.integers(0, 6))}", "pna", int(rng.integers(1, 3)),
                                    ["a", None][step % 2])
        if rng.random() < 0.55:
            size = int(rng.integers(1, 30))
            cache.put(key, [np.arange(size, dtype=np.float32), np.zeros(2, np.float32)])
        else:
            got = cache.get(key)
            trail.append(None if got is None else [h.tolist() for h in got])
        if step == 30:
            trail.append(cache.invalidate(model="pna", version=2))
        trail.append((list(cache._entries), cache.stats(), cache.bytes))
    return trail


def pytest_lru_evicts_as_the_jax_cache():
    trail = _cache_script(port_cache)
    assert trail == _cache_script(jax_cache)
    assert trail[-1][1]["evictions"] > 0
    cache = ResponseCache(capacity=2, max_bytes=64)
    out = [np.ones(3, np.float32)]
    cache.put(("", "m", 1, "k"), out)
    out[0][0] = 7.0  # the caller changes its array: the entry does not
    got = cache.get(("", "m", 1, "k"))
    got[0][1] = 9.0  # nor a hit's copy
    assert cache.get(("", "m", 1, "k"))[0].tolist() == [1.0, 1.0, 1.0]
    cache.put(("", "m", 1, "big"), [np.zeros(100, np.float32)])  # over max_bytes: refused
    assert len(cache) == 1


# ---- tenants and costs -------------------------------------------------------


SPECS = [{"name": "a", "model": "pna", "quota": 3, "weight": 2.0},
         {"name": "b", "model": "gin", "quota": 2},
         {"name": "c", "model": "pna"}]


def _tenant_script(mod):
    """One scripted backlog: admissions (some shed), DWRR rounds, serves,
    releases and a quota override; every outcome in order."""
    tm = mod.TenantManager.from_specs(SPECS, default_quota=4, quantum=4)
    out = []
    for t in "aaaabbbcccccab":
        try:
            tm.admit(t)
            out.append(("admit", t))
        except mod.TenantOverQuota as e:
            out.append(("shed", t, e.quota, str(e)))
    backlogs = [{"a": 3, "b": 2, "c": 4}, {"a": 1, "c": 4}, {"b": 2, None: 5},
                {"a": 5, "b": 1, "c": 1, None: 1}]
    for i, backlog in enumerate(backlogs):
        order = tm.flush_order(backlog)
        out.append(("order", order))
        for j, t in enumerate(order):
            tm.on_served(t, (i + j) % 4 + 1)
        out.append(("deficit", sorted(tm._deficit.items(), key=lambda kv: str(kv[0]))))
    for t in "abca":
        tm.release(t)
    tm.set_quota_override("c", 2)
    tm.set_quota_override("a", 9)  # above the base: clamped at read time
    out.append(("quota", [tm.quota_for(t) for t in "abc"], tm.base_quota_for("c")))
    out.append(("describe", tm.describe()))
    tm.set_quota_override("c", None)
    out.append(("in_flight", [tm.in_flight(t) for t in "abc"], tm.quota_for("c")))
    with pytest.raises(KeyError):
        tm.admit("nobody")
    return out


def pytest_tenant_manager_follows_the_jax_one():
    trail = _tenant_script(port_tenants)
    assert trail == _tenant_script(jax_tenants)
    assert any(step[0] == "shed" for step in trail)
    assert issubclass(TenantOverQuota, port_tenants.ServerOverloaded)


def _cost_script(costs_mod, tenants_mod, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_TENANT_COST_QUOTAS", "1")
    monkeypatch.setenv("HYDRAGNN_TENANT_COST_WINDOW_S", "1.0")
    monkeypatch.setenv("HYDRAGNN_TENANT_COST_PATIENCE", "2")
    now = [100.0]
    emitted = []
    ledger = costs_mod.CostLedger(emit=lambda ev, **kw: emitted.append((ev, kw)),
                                  clock=lambda: now[0])
    tm = tenants_mod.TenantManager.from_specs(SPECS, default_quota=8, quantum=4)
    rng = np.random.default_rng(9)
    out = []
    for tick in range(14):
        for _ in range(3):
            tenant = ["a", "b", "c", None][int(rng.integers(0, 4))]
            # b floods the device for the first half, then goes quiet
            heavy = 5.0 if tenant == "b" and tick < 7 else 1.0
            ledger.note_batch(tenant, int(rng.integers(0, 3)), int(rng.integers(1, 9)),
                              batch_seconds=0.01 * heavy * float(rng.random()),
                              flops=float(rng.integers(0, 1000)))
        now[0] += 0.6
        out.append(ledger.maybe_adjust_quotas(tm))
        out.append([tm.quota_for(t) for t in "abc"])
    bill = ledger.bill()
    out += [bill, emitted, ledger.render_prometheus()]
    out.append(costs_mod.merge_bills([bill, bill, {}]))
    out.append(costs_mod.price_per_million(bill, 1234))
    return out, bill


def pytest_cost_ledger_and_feedback_follow_the_jax_ones(monkeypatch):
    port, bill = _cost_script(port_costs, port_tenants, monkeypatch)
    ref, _ = _cost_script(jax_costs, jax_tenants, monkeypatch)
    assert port == ref
    assert any(port[i] for i in range(0, 28, 2))  # some quota moved
    rows = sum(r["device_s"] for r in bill["tenants"].values())
    assert rows + bill["idle_s"] == pytest.approx(bill["replica_s"], abs=1e-5)


# ---- the registry's listeners and channel -----------------------------------


def _tiny(seed=0, model_type="PNA"):
    return create_model_config(dict(arch(hidden=8, layers=2), model_type=model_type),
                               device="cpu", seed=seed)


class _JaxStub:
    output_type, output_dim = ("graph", "node"), (1, 2)


def pytest_activation_listeners_fire_as_in_jax():
    calls = {"port": [], "jax": []}

    def drive(reg, log, register):
        for _ in range(3):
            register(reg)
        reg.add_activation_listener(lambda n, v: log.append((n, v)))
        reg.add_activation_listener(lambda n, v: 1 / 0)  # swallowed
        reg.promote("m", 3)  # the implicit active version: no change
        reg.promote("m", 1)
        reg.promote("m", 1)
        reg.promote("m", 2)
        reg.rollback("m")
        reg.rollback("m")
        with pytest.raises(ValueError):
            reg.rollback("m")
        return reg.describe()["m"]["version"]

    a = drive(ModelRegistry(), calls["port"], lambda r: r.register("m", _tiny()))
    b = drive(JaxModelRegistry(), calls["jax"], lambda r: r.register("m", _JaxStub(), {}))
    assert calls["port"] == calls["jax"] == [("m", 1), ("m", 2), ("m", 1), ("m", 3)]
    assert a == b == 3


def _publish_port_checkpoint(path, name, seed):
    model = _tiny(seed)
    ckpt.save_model(flax_variables_of(model), name, path=str(path))
    cfg = {"NeuralNetwork": {"Architecture": dict(arch(hidden=8, layers=2)),
                             "Training": {"loss_function_type": "mse"}}}
    (path / name / "config.json").write_text(json.dumps(cfg))
    return model


def pytest_candidate_channel_is_read_by_both_packages(tmp_path, monkeypatch):
    logs, root = tmp_path / "logs", str(tmp_path / "channel")
    models = [_publish_port_checkpoint(logs, f"run{i}", seed=i) for i in range(3)]
    port_ch = CandidateChannel(root)
    for i in range(3):
        port_ch.publish(f"run{i}", str(logs), epoch=i)
    jax_ch = jax_registry.CandidateChannel(root)
    assert jax_ch.latest_seq() == 3 and [m["epoch"] for m in jax_ch.pending()] == [0, 1, 2]
    jax_ch.record_promotion(2)
    assert port_ch.pinned() == {2}
    port_ch.record_promotion(1)
    assert jax_ch.pinned() == {1, 2}
    assert port_ch.gc(keep_last=1) == [] and jax_ch.gc(keep_last=1) == []
    jax_ch.record_promotion(3)  # pins 3 and 1: seq 2 is collected
    assert port_ch.gc(keep_last=1) == [2] and jax_ch.latest_seq() == 3
    # a tenant on the channel loads the pinned newest version, in both packages
    specs = [{"name": "t", "model": "pna", "channel": root}]
    reg = ModelRegistry()
    assert TenantManager.from_specs(specs).load_models(reg, device="cpu") == {"pna": 1}
    got = flax_variables_of(reg.get("pna").model)
    want = flax_variables_of(models[2])
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, got, want))
    jreg = JaxModelRegistry()
    assert jax_tenants.TenantManager.from_specs(specs).load_models(jreg) == {"pna": 1}
    assert jreg.get("pna").source.endswith("run2")
    # no card and no device="cpu": the channel's load raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TenantManager.from_specs(specs).load_models(ModelRegistry())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UncertaintyScorer("ensemble")
    # the feedback sink is host-side: it builds without a card, and writes
    # nothing before its first flush
    sink = FeedbackSink(str(tmp_path / "queue"))
    assert sink.stats()["packs"] == 0 and not (tmp_path / "queue").exists()


# ---- the scorer --------------------------------------------------------------


def pytest_ensemble_variances_match_the_jax_scorer():
    cfg = arch(hidden=8, layers=2)
    graphs = _graphs(GraphData, REQUEST_SIZES[:6], 1)
    jplan = jax_plan_from_samples(_graphs(JaxGraphData, PLAN_SIZES, 0), max_batch_graphs=8)
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=8)
    jmodel = jax_create_model_config(cfg)
    init, _ = jplan.pack([jplan.warmup_sample], 0)
    jreg, reg = JaxModelRegistry(), ModelRegistry()
    for seed in range(3):
        v = jax_variables(jmodel, jax.tree_util.tree_map(jnp.asarray, init), seed=seed)
        v["params"] = jax.tree_util.tree_map(
            lambda a, s=seed: np.asarray(a) * (1.0 + 0.3 * s), v["params"])
        jreg.register("pna", jmodel, v["params"], v["batch_stats"])
        reg.register("pna", load_flax_variables(create_model_config(cfg, device="cpu"), v))
    bucket = plan.num_buckets - 1
    jbatch, jcoords = jplan.pack(_graphs(JaxGraphData, REQUEST_SIZES[:6], 1), bucket)
    batch, coords = plan.pack(graphs, bucket)
    jvar = JaxUncertaintyScorer("ensemble", samples=4, registry=jreg).dispatch(
        jreg.get("pna"), jax.tree_util.tree_map(np.asarray, jbatch))
    scorer = UncertaintyScorer("ensemble", samples=4, registry=reg, device="cpu")
    var = scorer.dispatch(reg.get("pna"), batch)
    assert scorer._member_versions(reg.get("pna")) == (1, 2, 3)
    for ihead, kind in enumerate(cfg["output_type"]):
        j, p = np.asarray(jvar[ihead]), var[ihead].numpy()
        for (g, off, n), (jg, joff, jn) in zip(coords, jcoords):
            mine = p[g] if kind == "graph" else p[off : off + n]
            ref = j[jg] if kind == "graph" else j[joff : joff + jn]
            assert mine.max() > 0
            np.testing.assert_allclose(mine, ref, rtol=UNC_RTOL,
                                       atol=UNC_ATOL * (float(ref.max()) + 1.0))


def _bn_buffers(model):
    return [b.clone() for b in model.buffers()]


@pytest.mark.parametrize("model_type", ["PNA", "GAT"])
def pytest_dropout_scores_leave_the_served_statistics(model_type):
    cfg = dict(arch(hidden=8, layers=2), model_type=model_type, max_neighbours=4)
    model = create_model_config(cfg, device="cpu", seed=2)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.linspace(0.5, 1.5, b.numel()) if "var" in name
                    else torch.linspace(-0.2, 0.2, b.numel()))
    reg = ModelRegistry()
    entry = reg.register("m", model)
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=8)
    batch, _ = plan.pack(_graphs(GraphData, REQUEST_SIZES[:6], 2), plan.num_buckets - 1)
    before = _bn_buffers(model)
    scorer = UncertaintyScorer("dropout", samples=4, seed=5, registry=reg, device="cpu")
    first = scorer.dispatch(entry, batch)
    second = scorer.dispatch(entry, batch)
    assert not model.training
    assert all(torch.equal(a, b) for a, b in zip(before, _bn_buffers(model)))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    if model_type == "PNA":  # no stochastic layer: K copies of one forward
        assert all(int(torch.count_nonzero(v)) == 0 for v in first)
    else:
        assert all(float(v.max()) > 0 for v in first)
        # another seed draws other masks
        other = UncertaintyScorer("dropout", samples=4, seed=6, device="cpu").dispatch(entry, batch)
        assert not torch.equal(other[0], first[0])


@pytest.mark.parametrize("model_type,branch", [("PNA", "segment"), ("GAT", "segment"),
                                               ("GAT", "dense")])
def pytest_sampling_forward_is_the_jax_train_apply(model_type, branch):
    cfg = stack_arch(model_type)
    host, batch = stack_batches(stack_graphs(3), branch, with_targets=False)
    jmodel = jax_create_model_config(cfg).clone(dropout=0.0)
    variables = jax_variables_with_stats(jmodel, host, seed=4)  # running stats far from 0, 1

    def train_apply(v, b):
        out, _ = jmodel.apply(v, b, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        return out

    ref = [np.asarray(o) for o in jax.jit(train_apply)(variables, host)]
    model = load_flax_variables(create_model_config(cfg, device="cpu"), variables)
    model.set_dropout(0.0)
    before = _bn_buffers(model)
    with torch.inference_mode():
        got = [o.numpy() for o in model(batch, sample=True)]
        served = [o.numpy() for o in model(batch)]
    assert not model.training
    assert all(torch.equal(a, b) for a, b in zip(before, _bn_buffers(model)))
    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    for kind, g, r, e in zip(cfg["output_type"], got, ref, served):
        m = masks[kind]
        np.testing.assert_allclose(g[m], r[m], rtol=FORWARD_RTOL, atol=FORWARD_ATOL)
        # the running statistics would have given another answer
        assert np.abs(e[m] - r[m]).max() > 10 * (FORWARD_ATOL + FORWARD_RTOL * np.abs(r[m]).max())


def _fixed_mask(shape, rate):
    """One keep-mask per shape: the same draws for both packages."""
    seed = int(np.prod(shape)) % (2**31)
    return np.random.default_rng(seed).random(shape) < 1.0 - rate


@pytest.mark.parametrize("branch", ["segment", "dense"])
def pytest_sampling_drops_where_the_jax_train_apply_does(monkeypatch, branch):
    import flax.linen as nn

    import hydragnn_tpu_torch.models.gat as port_gat

    def jax_drop(self, inputs, deterministic=None, rng=None):
        if self.deterministic if deterministic is None else deterministic:
            return inputs
        keep = _fixed_mask(inputs.shape, self.rate)
        return jnp.where(keep, inputs / (1.0 - self.rate), 0.0)

    def port_drop(x, rate, generator):
        assert generator is not None
        keep = torch.from_numpy(_fixed_mask(tuple(x.shape), rate))
        return torch.where(keep, x / (1.0 - rate), 0.0)

    monkeypatch.setattr(nn.Dropout, "__call__", jax_drop)
    monkeypatch.setattr(port_gat, "attention_dropout", port_drop)
    cfg = stack_arch("GAT")
    host, batch = stack_batches(stack_graphs(5), branch, with_targets=False)
    jmodel = jax_create_model_config(cfg)
    variables = jax_variables_with_stats(jmodel, host, seed=6)
    ref, _ = jmodel.apply(variables, host, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
    model = load_flax_variables(create_model_config(cfg, device="cpu"), variables)
    assert model.encoder_conv_0.dropout == 0.25
    with torch.inference_mode():
        got = [o.numpy() for o in model(batch, generator=torch.Generator(), sample=True)]
        undropped = [o.numpy() for o in model.set_dropout(0.0)(batch, sample=True)]
    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    for kind, g, r, u in zip(cfg["output_type"], got, ref, undropped):
        m, r = masks[kind], np.asarray(r)
        np.testing.assert_allclose(g[m], r[m], rtol=FORWARD_RTOL, atol=FORWARD_ATOL)
        assert np.abs(u[m] - r[m]).max() > 10 * (FORWARD_ATOL + FORWARD_RTOL * np.abs(r[m]).max())


def pytest_dropout_variance_is_k_train_mode_forwards():
    cfg = dict(arch(hidden=8, layers=2), model_type="GAT", max_neighbours=4)
    model = create_model_config(cfg, device="cpu", seed=3)
    reg = ModelRegistry()
    entry = reg.register("gat", model)
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=8)
    batch, _ = plan.pack(_graphs(GraphData, REQUEST_SIZES[:6], 4), plan.num_buckets - 1)
    got = UncertaintyScorer("dropout", samples=4, seed=9, registry=reg,
                            device="cpu").dispatch(entry, batch)
    plain = copy.deepcopy(model).train()
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        outs = [plain(batch, generator=gen) for _ in range(4)]
    for ihead, v in enumerate(got):
        want = torch.var(torch.stack([o[ihead].to(torch.float32) for o in outs]), dim=0,
                         correction=0)
        assert float(want.max()) > 0 and torch.equal(v, want)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"HYDRAGNN_UNC_SAMPLES": "1"}, "raises"),
    ({"HYDRAGNN_UNC_SAMPLES": "3", "HYDRAGNN_UNC_MODE": "ensemble", "HYDRAGNN_UNC_SEED": "7"},
     ("ensemble", 3, 7)),
    ({"HYDRAGNN_UNC_SAMPLES": "2", "HYDRAGNN_UNC_MODE": "bogus"}, "raises"),
])
def pytest_scorer_from_env_as_the_jax_one(monkeypatch, env, want):
    for name in ("HYDRAGNN_UNC_SAMPLES", "HYDRAGNN_UNC_MODE", "HYDRAGNN_UNC_SEED"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    outcomes = []
    for build in (lambda: UncertaintyScorer.from_env(device="cpu"),
                  JaxUncertaintyScorer.from_env):
        try:
            s = build()
            outcomes.append(None if s is None else (s.mode, s.samples, s.seed))
        except ValueError:
            outcomes.append("raises")
    assert outcomes == [want, want]


# ---- one burst through the whole server --------------------------------------


_PROM = re.compile(r'^[a-z_]+(\{[a-z_]+="[^"]*"(,[a-z_]+="[^"]*")*\})? (-?[0-9.e+-]+|nan|inf)$')


def _parse_prometheus(text):
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        assert _PROM.match(line), line
        name, value = line.rsplit(" ", 1)
        series[name] = float(value)
    return series


def _permuted(g, seed):
    perm = np.random.default_rng(seed).permutation(g.num_nodes)
    inv = np.argsort(perm)
    return GraphData(x=g.x[perm], pos=g.pos[perm], edge_index=inv[g.edge_index])


def pytest_server_burst_with_tenants_cache_costs_scorer_and_tracing(tmp_path):
    reg = ModelRegistry()
    for seed in range(3):
        reg.register("pna", _tiny(seed))
    reg.register("gin", _tiny(0, "GIN"))
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=4)
    tenants = TenantManager.from_specs([{"name": "a", "model": "pna", "weight": 3.0},
                                        {"name": "b", "model": "gin", "quota": 4}])
    costs = CostLedger()
    scorer = UncertaintyScorer("ensemble", samples=4, registry=reg, device="cpu")
    log = RunEventLog(str(tmp_path / "events.jsonl"))
    tracer = Tracer(sample=1.0, emit=log.emit)
    server = InferenceServer(reg, plan, tenants=tenants, cache=ResponseCache(), costs=costs,
                             scorer=scorer, observability_port=0, device="cpu")
    reqs_a = _graphs(GraphData, REQUEST_SIZES, 1)
    reqs_b = _graphs(GraphData, REQUEST_SIZES[:6], 2)
    with InferenceServer(reg, plan, device="cpu") as plain:  # the plain server's answers
        ref_a = [plain.submit(g, model="pna").result(60) for g in reqs_a]
        ref_b = [plain.submit(g, model="gin").result(60) for g in reqs_b[:4]]
    # before start() nothing drains: b's fifth in-flight request is over its
    # quota and shed, while a's all queue
    traces = [tracer.start(tenant="a") for _ in reqs_a]
    futs_a = [server.submit(g, tenant="a", trace=t) for g, t in zip(reqs_a, traces)]
    futs_b = [server.submit(g, tenant="b") for g in reqs_b[:4]]
    with pytest.raises(TenantOverQuota) as shed:
        server.submit(reqs_b[4], tenant="b")
    assert shed.value.tenant == "b"
    with server:
        assert server.metrics.compiles_total == 2 * plan.num_buckets * 2
        got_a = [f.result(60) for f in futs_a]
        got_b = [f.result(60) for f in futs_b]
        for t in traces:
            t.finish("ok")
        host, port = server.observability_address
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
            series = _parse_prometheus(r.read().decode())
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        batches = server.metrics.batches_total
        again = [server.submit(_permuted(g, i), tenant="a") for i, g in enumerate(reqs_a)]
        hits = [f.result(10) for f in again]
        assert server.metrics.batches_total == batches  # no dispatch
        # a new version (v3 pinned first, as promote_checkpoint does) warms
        # through the batcher, forward and scorer per bucket, and its
        # promote drops pna's cached answers, not gin's
        reg.promote("pna", 3)
        reg.register("pna", _tiny(7))
        warmed = server.warm_version("pna", version=4)
        assert server.cache.stats()["entries"] == len(reqs_a) + 4
        reg.promote("pna", 4)
        assert server.cache.stats()["entries"] == 4
    log.close()
    assert warmed["verified"] and warmed["first_pass_compiles"] == 2 * plan.num_buckets
    snap = server.metrics.snapshot()
    assert snap["compiles_total"] == 2 * plan.num_buckets * 2 + 2 * plan.num_buckets
    assert snap["scorer_errors"] == 0 and snap["errors_total"] == 0
    assert snap["shed_total"] == 1 and snap["cache_hits_total"] == len(reqs_a)
    for got, want in zip(hits, got_a):
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert all(f.uncertainty is None for f in again)
    assert all(len(f.uncertainty) == 2 for f in futs_a + futs_b)
    assert all(f.model_name == "pna" and f.version == 3 for f in futs_a)
    for got, ref in zip(got_a + got_b, ref_a + ref_b):
        for x, y in zip(got, ref):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    # the scrape and the health
    assert series["hydragnn_serve_scorer_errors_total"] == 0
    assert series["hydragnn_serve_compiles_total"] == 12
    assert series['hydragnn_tenant_cost_requests{tenant="a"}'] == len(reqs_a)
    assert any(k.startswith("hydragnn_uncertainty{") for k in series)
    assert health["status"] == "ok" and set(health["tenants"]) == {"a", "b"}
    assert health["quality"]["scorer_errors"] == 0
    # the bill's rows and the idle residual sum to the replica-seconds
    bill = costs.bill()
    rows = sum(r["device_s"] for r in bill["tenants"].values())
    assert rows + bill["idle_s"] == pytest.approx(bill["replica_s"], abs=1e-5)
    assert bill["tenants"]["a"]["flops"] > 0
    # every traced request: its four spans under its root
    built = build_traces(load_span_events(str(tmp_path)))
    assert len(built) == len(reqs_a)
    for t in built.values():
        names = sorted(s["name"] for s in t["spans"])
        assert names == sorted(["route", "queue_wait", "batch_form", "dispatch", "readback"])
