"""The uncertainty scorer's captured programs and the tenanted server on the
card (``serve/quality.py``, ``serve/server.py``); marker ``cuda``, skipped
inside the test without one. Run on the card with
``python -m pytest tests/test_torch_serve_cuda.py -q -p no:randomly --noconftest``.

- ``dropout`` mode: GAT's K samples draw from the scorer's generator,
  re-seeded before every replay, so two dispatches of one batch draw the
  same masks; their variances (> 0) then differ only by K1's atomics,
  which add in a run-dependent order: each within ``4 eps sqrt(var) + 4
  eps^2``, ``eps = 1e-5 * (max |output| + 1)`` (K1's tolerance), while
  another seed moves them past 100 times that bound. PNA, which draws
  nothing, gives exactly 0. Neither moves the served BatchNorm
  statistics. GAT's replayed variances are within the same bound of a
  plain reference: a copy of the model in ``train()`` mode run K times
  eagerly on the card from a generator seeded as the scorer's, then
  ``torch.var(correction=0)``. One sample (``forward(sample=True)``, GAT's
  dropout at 0) on the card is the CPU's within rtol 1e-3, atol 1e-4 (the
  serve tolerance); the CPU's is the JAX package's train apply
  (``test_torch_serve_tenancy.py``).
- ``ensemble`` mode (PNA ``fused``, 4 versions): the replay's variances
  against the same members run eagerly on the card, within
  ``4 eps sqrt(var) + 4 eps^2`` with ``eps = 1e-4 * max|o| + 1e-3 |o|``
  per sample (the serve tolerance carried through the variance); one
  replay launches K3 and K1 4 times a forward's.
- A server with tenants, the cache, the ledger and the scorer: two
  programs per bucket and version, no scorer error, a permuted resubmit
  answered from the cache without a dispatch.
"""

import copy

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch import ops
from hydragnn_tpu_torch.benchmarks.model_bench import _arch, make_graphs
from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.serve import (
    CostLedger,
    InferenceServer,
    ModelRegistry,
    ResponseCache,
    TenantManager,
    UncertaintyScorer,
    plan_from_samples,
)

pytestmark = pytest.mark.cuda

K = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured programs have no CPU mode")
    return torch.device("cuda")


def _plan_and_batch(graphs=8):
    samples = make_graphs(24, 20, 6, seed=0)
    plan = plan_from_samples(samples, max_batch_graphs=graphs, num_buckets=2)
    b = plan.num_buckets - 1
    take = [g for g in samples if plan.admit(g)[0] == b][: graphs - 1]
    batch, coords = plan.pack(take, b)
    return plan, samples, batch, coords


def _model(model_type, card, seed, aggregation="fused"):
    model = create_model_config(_arch(model_type, 32, 2, 20), device=card,
                                aggregation=aggregation, seed=seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.linspace(0.5, 1.5, buf.numel()) if "var" in name
                      else torch.linspace(-0.2, 0.2, buf.numel()))
    return model


def _over_bound(a, b, scale):
    """The share used of K1's tolerance carried through a variance."""
    eps = 1e-5 * (scale + 1.0)
    return float(((a - b).abs() / (4 * eps * torch.sqrt(torch.maximum(a, b))
                                    + 4 * eps * eps)).max())


@pytest.mark.parametrize("model_type", ["GAT", "PNA"])
def pytest_dropout_scores_repeat_the_same_draws(card, model_type):
    _, _, batch, _ = _plan_and_batch()
    model = _model(model_type, card, 0, aggregation="segment")
    registry = ModelRegistry()
    entry = registry.register("m", model)
    before = [b.clone() for b in model.buffers()]
    scorer = UncertaintyScorer("dropout", samples=K, seed=3, registry=registry, device=card)
    first = scorer.dispatch(entry, batch)
    second = scorer.dispatch(entry, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    if model_type == "PNA":
        assert all(int(torch.count_nonzero(v)) == 0 for v in first + second)
        return
    moved = UncertaintyScorer("dropout", samples=K, seed=4, device=card).dispatch(entry, batch)
    with torch.inference_mode():
        scale = [float(o.abs().max()) for o in model(batch)]
    assert all(float(v.max()) > 0 for v in first)
    assert max(_over_bound(a, b, s) for a, b, s in zip(first, second, scale)) <= 1.0
    assert max(_over_bound(a, b, s) for a, b, s in zip(first, moved, scale)) > 100.0


def pytest_dropout_variance_is_k_train_mode_forwards_on_the_card(card):
    _, _, batch, _ = _plan_and_batch()
    model = _model("GAT", card, 1, aggregation="segment")
    registry = ModelRegistry()
    entry = registry.register("m", model)
    scorer = UncertaintyScorer("dropout", samples=K, seed=5, registry=registry, device=card)
    scorer.dispatch(entry, batch, run=False)  # the capture
    got = scorer.dispatch(entry, batch)
    plain = copy.deepcopy(model).train()
    gen = torch.Generator(device=card).manual_seed(5)
    with torch.no_grad():
        outs = [plain(batch, generator=gen) for _ in range(K)]
    for ihead, v in enumerate(got):
        stack = torch.stack([o[ihead].float() for o in outs])
        want = torch.var(stack, dim=0, correction=0)
        assert float(want.max()) > 0
        assert _over_bound(v, want, float(stack.abs().max())) <= 1.0
    scorer.release()


@pytest.mark.parametrize("model_type,aggregation", [("PNA", "fused"), ("GAT", "segment")])
def pytest_sampling_forward_on_the_card_is_the_cpu_s(card, model_type, aggregation):
    _, _, batch, _ = _plan_and_batch()
    model = _model(model_type, card, 2, aggregation=aggregation).set_dropout(0.0)
    cpu = copy.deepcopy(model).cpu()
    before = [b.clone() for b in model.buffers()]
    with torch.inference_mode():
        got = [o.cpu().numpy() for o in model(batch, sample=True)]
        want = [o.numpy() for o in cpu(batch, sample=True)]
        served = [o.cpu().numpy() for o in model(batch)]
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    masks = {"graph": batch.graph_mask.numpy(), "node": batch.node_mask.numpy()}
    for kind, g, w, e in zip(model.output_type, got, want, served):
        m = masks[kind]
        np.testing.assert_allclose(g[m], w[m], rtol=1e-3, atol=1e-4)
        assert np.abs(e[m] - w[m]).max() > 10 * (1e-4 + 1e-3 * np.abs(w[m]).max())


def pytest_ensemble_replay_against_eager_members(card):
    _, _, batch, _ = _plan_and_batch()
    registry = ModelRegistry()
    for seed in range(K):
        registry.register("pna", _model("PNA", card, seed))
    entry = registry.get("pna")
    scorer = UncertaintyScorer("ensemble", samples=K, registry=registry, device=card)
    scorer.dispatch(entry, batch, run=False)  # the capture
    ops.reset_launch_counts()
    got = [v.cpu().numpy() for v in scorer.dispatch(entry, batch)]
    scored = ops.launch_counts()
    ops.reset_launch_counts()
    with torch.inference_mode():
        samples = [[o.cpu().numpy() for o in m(batch)]
                   for m in (registry.get("pna", v).model for v in range(1, K + 1))]
    forward = ops.launch_counts()
    assert forward["fused_gather_moments"] == K * 2 and forward["segment_sum"] == K
    assert scored == forward  # one replay: K forwards' launches
    for ihead in range(len(got)):
        stack = np.stack([s[ihead] for s in samples]).astype(np.float64)
        want = stack.var(axis=0)
        eps = 1e-4 * np.abs(stack).max() + 1e-3 * np.abs(stack).max(axis=0)
        assert (np.abs(got[ihead] - want) <= 4 * eps * np.sqrt(want) + 4 * eps * eps).all()
        assert got[ihead].max() > 0
    scorer.release()


def pytest_tenanted_server_with_scorer_and_cache(card):
    plan, samples, _, _ = _plan_and_batch()
    registry = ModelRegistry()
    for seed in range(K):
        registry.register("pna", _model("PNA", card, seed))
    registry.register("gin", _model("GIN", card, 0))
    tenants = TenantManager.from_specs([{"name": "a", "model": "pna", "weight": 3.0},
                                        {"name": "b", "model": "gin"}])
    scorer = UncertaintyScorer("ensemble", samples=K, registry=registry, device=card)
    server = InferenceServer(registry, plan, tenants=tenants, cache=ResponseCache(),
                             costs=CostLedger(), scorer=scorer, device=card)
    with server:
        assert server.metrics.compiles_total == 2 * 2 * plan.num_buckets
        futures = [server.submit(g, tenant="ab"[i % 2]) for i, g in enumerate(samples)]
        answers = [f.result(120) for f in futures]
        batches = server.metrics.batches_total
        again = []
        for g in samples:
            perm = np.random.default_rng(0).permutation(g.num_nodes)
            inv = np.argsort(perm)
            again.append(GraphData(x=g.x[perm], pos=g.pos[perm], edge_index=inv[g.edge_index],
                                   edge_attr=g.edge_attr))
        hits = [server.submit(g, tenant="ab"[i % 2]).result(10) for i, g in enumerate(again)]
        assert server.metrics.batches_total == batches
    snap = server.metrics.snapshot()
    assert snap["compiles_total"] == 2 * 2 * plan.num_buckets
    assert snap["scorer_errors"] == 0 and snap["errors_total"] == 0
    assert all(len(f.uncertainty) == 2 for f in futures)
    for got, want in zip(hits, answers):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
