"""The port's ``bench_model`` (``hydragnn_tpu_torch/benchmarks/model_bench.py``)
against the JAX package's ``benchmarks/model_bench.py``: the same graphs,
architecture, batch and row identity; and one tiny run on the CPU through
the plain versions, which returns every field of the JAX row and counts
the matmul work of a step exactly.
"""

import numpy as np
import pytest

import bench
from benchmarks import model_bench as jax_bench

from hydragnn_tpu_torch.benchmarks import model_bench
from hydragnn_tpu_torch.ops import launch_counts

TINY = dict(model_type="PNA", hidden=16, num_graphs=4, nodes=12, degree=4, layers=2)
ROW_FIELDS = ("ms_per_step", "graphs_per_sec", "flops_per_step", "achieved_tflops",
              "mfu_pct", "device_kind", "peak_tflops_assumed")


def pytest_graphs_arch_and_batch_equal_jax():
    assert model_bench.MXU_HEADLINE == bench.MXU_HEADLINE
    got = model_bench.make_graphs(5, 20, 6, seed=3)
    want = jax_bench.make_graphs(5, 20, 6, seed=3)
    for g, w in zip(got, want):
        for name in ("x", "pos", "edge_index", "edge_attr"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        for t, u in zip(g.targets, w.targets):
            np.testing.assert_array_equal(t, u)
    for model_type in ("PNA", "GIN", "SAGE", "SchNet", "EGNN"):
        mine = model_bench._arch(model_type, 256, 3, 90)
        theirs = jax_bench._arch(model_type, 256, 3, 90)
        assert mine == {k: theirs[k] for k in mine}, model_type
    batch = model_bench._collate(got, 5, 20, 6)
    jbatch = jax_bench._collate(want, 5, 20, 6, with_triplets=False)
    for name in ("x", "senders", "receivers", "node_mask", "edge_mask", "graph_mask", "n_node"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)))
    for t, u in zip(batch.targets, jbatch.targets):
        np.testing.assert_array_equal(t.numpy(), np.asarray(u))


@pytest.mark.parametrize("kw", [
    {}, dict(bf16=True, dense=True), dict(hidden=256, num_graphs=8, layers=2), bench.MXU_HEADLINE,
])
def pytest_row_identity_equals_jax(kw):
    assert model_bench.config_identity(**kw) == jax_bench.config_identity(**kw)


def _matmul_flops(hidden, num_graphs, nodes, degree, layers):
    """The multiply-adds (x2) of one PNA training step's products, from
    their shapes: the forward, then each product's two backward products,
    less the one the batch's input needs none of (layer 0's ``pre_nn``
    pieces of ``x``)."""
    n = -(-(num_graphs * nodes + 1) // 8) * 8  # pad_sizes_for
    g = num_graphs + 1
    s = max(32, hidden // 4)
    fwd = 0
    for i in range(layers):
        d = 1 if i == 0 else hidden  # input_dim 1
        fwd += 2 * (2 * n * d * d)  # pre_nn: x @ Wi, x @ Wj ([d] -> [d])
        fwd += 2 * n * (17 * d) * hidden  # post_nn
        fwd += 2 * n * hidden * hidden  # lin
    fwd += 2 * g * (hidden * s + s * s)  # graph_shared
    fwd += 2 * g * (s * s + s * s + s * 1)  # head_0_graph
    fwd += 2 * n * (hidden * s + s * s + s * 1)  # head_1_node
    return 3 * fwd - 4 * n  # no gradient for layer 0's two [n, 1] x [1, 1] inputs


@pytest.mark.parametrize("bf16,dense", [(False, False), (True, True)])
def pytest_bench_model_runs_on_the_cpu(bf16, dense):
    before = launch_counts()
    row = model_bench.bench_model(**TINY, bf16=bf16, dense=dense, iters=2, device="cpu")
    assert launch_counts() == before  # the plain versions
    for key in ROW_FIELDS:
        assert key in row, key
    assert {k: row[k] for k in jax_bench.KEY_FIELDS if k in row} == model_bench.config_identity(
        **TINY, bf16=bf16, dense=dense)
    assert row["device_kind"] == "cpu" and row["mfu_pct"] is None and row["peak_tflops_assumed"] is None
    assert row["ms_per_step"] > 0 and np.isfinite(row["final_loss"]) and np.isfinite(row["eval_loss"])
    np.testing.assert_allclose(row["graphs_per_sec"], TINY["num_graphs"] / row["ms_per_step"] * 1e3)
    assert row["flops_per_step"] == _matmul_flops(16, 4, 12, 4, 2)
    with pytest.raises(ValueError, match="iters"):
        model_bench.bench_model(**TINY, iters=0, device="cpu")


def pytest_the_peak_is_known_only_for_the_h100():
    assert model_bench.PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": {"bf16": 989.0, "f32": 67.0}}
