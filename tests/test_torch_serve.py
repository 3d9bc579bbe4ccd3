"""Port parity: the served slice. The port's ``InferenceServer`` on the
CPU against the JAX package's ``InferenceServer``, same weights, about a
dozen mixed-size requests, compared request by request.

The two plans pad differently (under this suite JAX sees 8 CPU devices, so
its graph pads are multiples of 8; the port serves from one card), which
is why outputs are compared per request and never as raw padded arrays.
Tolerance: rtol 1e-4, atol 1e-5 (contraction orders differ).
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.serve import InferenceServer as JaxInferenceServer
from hydragnn_tpu.serve import ModelRegistry as JaxModelRegistry
from hydragnn_tpu.serve import plan_from_samples as jax_plan_from_samples

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config, load_flax_variables
from hydragnn_tpu_torch.serve import (
    DeadlineExceeded,
    GraphTooLarge,
    InferenceServer,
    ModelRegistry,
    ServerOverloaded,
    plan_from_samples,
)

from test_torch_pna import arch, jax_variables

RTOL, ATOL = 1e-4, 1e-5


def _graphs(cls, sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        g = cls(
            x=rng.random((n, 1)).astype(np.float32),
            pos=rng.random((n, 3)).astype(np.float32),
        )
        src = np.repeat(np.arange(n), 2)
        dst = (src + rng.integers(1, n, src.shape[0])) % n
        g.edge_index = np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int64)
        out.append(g)
    return out


PLAN_SIZES = [4, 5, 6, 7, 8, 9, 10, 6, 4, 10]
REQUEST_SIZES = [4, 10, 7, 5, 9, 6, 8, 4, 10, 6, 7, 5]

_JAX = {}


def _jax_reference():
    """The JAX server's answers and its weights, computed once per module."""
    if _JAX:
        return _JAX
    cfg = arch()
    jplan = jax_plan_from_samples(_graphs(JaxGraphData, PLAN_SIZES, 0), max_batch_graphs=4)
    jmodel = jax_create_model_config(cfg)
    init_batch, _ = jplan.pack([jplan.warmup_sample], 0)
    variables = jax_variables(jmodel, jax.tree_util.tree_map(jnp.asarray, init_batch))
    registry = JaxModelRegistry()
    registry.register("pna", jmodel, variables["params"], variables["batch_stats"])
    with JaxInferenceServer(registry, jplan) as server:
        futures = [server.submit(g) for g in _graphs(JaxGraphData, REQUEST_SIZES, 1)]
        answers = [f.result(120) for f in futures]
    _JAX.update(cfg=cfg, variables=variables, answers=answers)
    return _JAX


def _port_server(aggregation):
    ref = _jax_reference()
    model = create_model_config(ref["cfg"], device="cpu", aggregation=aggregation)
    load_flax_variables(model, ref["variables"])
    registry = ModelRegistry()
    registry.register("pna", model)
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=4)
    return InferenceServer(registry, plan, device="cpu")


@pytest.mark.parametrize("aggregation", ["fused", "segment"])
def pytest_served_requests_match_jax_server(aggregation):
    ref = _jax_reference()["answers"]
    requests = _graphs(GraphData, REQUEST_SIZES, 1)
    futures = [None] * len(requests)

    def submit(idx):
        for i in idx:
            futures[i] = server.submit(requests[i])

    with _port_server(aggregation) as server:
        threads = [threading.Thread(target=submit, args=(range(k, len(requests), 3),)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        got = [f.result(60) for f in futures]
    snap = server.metrics.snapshot()
    assert snap["responses_total"] == len(requests) and snap["errors_total"] == 0
    for g, r, req in zip(got, ref, requests):
        assert g[0].shape == (1,) and g[1].shape == (req.num_nodes, 2)
        np.testing.assert_allclose(g[0], np.asarray(r[0]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g[1], np.asarray(r[1]), rtol=RTOL, atol=ATOL)


def pytest_graph_too_large_is_refused_before_queueing():
    server = _port_server("fused")
    big = _graphs(GraphData, [40], 2)[0]
    with server:
        with pytest.raises(GraphTooLarge):
            server.submit(big)
    assert server.metrics.snapshot()["requests_total"] == 0


def pytest_full_queue_sheds_and_expired_deadline_fails_before_dispatch():
    requests = _graphs(GraphData, REQUEST_SIZES[:2], 4)
    model = create_model_config(arch(), device="cpu")
    registry = ModelRegistry()
    registry.register("pna", model)
    plan = plan_from_samples(_graphs(GraphData, PLAN_SIZES, 0), max_batch_graphs=4)
    # not started: the one queue slot stays taken, the next submit is shed
    server = InferenceServer(registry, plan, queue_capacity=1, device="cpu")
    first = server.submit(requests[0], deadline_s=0.0)
    with pytest.raises(ServerOverloaded) as shed:
        server.submit(requests[1])
    assert shed.value.retry_after_s > 0
    # started, the queued request is past its deadline by the time it flushes
    server.start(warmup=False)
    with pytest.raises(DeadlineExceeded):
        first.result(30)
    assert server.predict(requests[1], timeout=30)[1].shape == (requests[1].num_nodes, 2)
    server.stop()
    snap = server.metrics.snapshot()
    assert snap["shed_total"] == 1 and snap["timeouts_total"] == 1
    assert snap["responses_total"] == 1 and snap["deadline_met_total"] == 1


def pytest_stop_drains_queued_requests():
    server = _port_server("segment")
    requests = _graphs(GraphData, REQUEST_SIZES, 3)
    server.start()
    futures = [server.submit(g) for g in requests]
    server.stop(drain=True)
    answers = [f.result(0) for f in futures]  # every one resolved, none failed
    assert len(answers) == len(requests)
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(requests[0])
    snap = server.metrics.snapshot()
    assert snap["responses_total"] == len(requests) and snap["errors_total"] == 0
