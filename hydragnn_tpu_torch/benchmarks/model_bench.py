"""The training-step benchmark with MFU (port of ``benchmarks/model_bench.py``).

:func:`bench_model` builds a model and a batch as the JAX package's
``bench_model`` does (``make_graphs`` -> ``_collate`` -> the dense
neighbour lists when asked -> ``create_model_config(_arch(...))`` ->
``Trainer`` with AdamW at lr 1e-3 and ``mixed_precision = bf16``), takes
one warm step, then times ``iters`` steps with CUDA events around them and
one synchronise at the end, then takes one ``eval_step``. :data:`MXU_HEADLINE` is the JAX package's
headline configuration (``bench.py:517-518``), :data:`MXU_ROWS` its
MXU-scale rows of GIN, SAGE, SchNet and EGNN (``bench.py:302-305``).

``flops_per_step`` is the matmul work of one step (forward and backward),
counted from the products' shapes by ``torch.utils.flop_counter
.FlopCounterMode`` on the warm step. XLA's count, which the JAX package
reports, also counts elementwise work, so the two are not the same
number. MFU is against the precision's peak of the card (NVIDIA's data
sheet for the H100 SXM: 989 TFLOP/s bf16 dense, 67 TFLOP/s f32 outside
the tensor cores); a card the table does not know, or the CPU, gives
``mfu_pct: None``. A batch without the lists takes the port's ``segment``
mode, the row's ``aggregation``. Not ported: ``remat`` (conv
checkpointing), ``mesh``, ``input_dim`` (CGCNN's width) and DimeNet's
triplets (``ROADMAP.md``).
"""

import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.graph import collate_graphs, pad_sizes_for
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.ops.dense_agg import attach_neighbor_lists
from hydragnn_tpu_torch.train import Trainer
from hydragnn_tpu_torch.utils import resolve_device

MXU_HEADLINE = dict(model_type="PNA", hidden=256, num_graphs=64, nodes=90,
                    degree=12, layers=3, dense=True, bf16=True)
# the MXU-scale matrix of the stacks the port trains besides PNA
# (``bench.py:302-305``): each at hidden 256 on the oc20 shape, in segment
# f32 and in dense bf16
MXU_ROWS = [
    dict(model_type=m, hidden=256, num_graphs=64, nodes=90, degree=12, layers=3, **mode)
    for m in ("GIN", "SAGE", "SchNet", "EGNN")
    for mode in ({}, {"dense": True, "bf16": True})
]

# peak dense TFLOP/s by torch.cuda.get_device_name() and precision (NVIDIA
# H100 SXM data sheet: bf16 on the tensor cores without sparsity; f32
# outside them, as the port runs f32 with TF32 off)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "f32": 67.0},
}


def make_graphs(num_graphs, nodes, degree, seed=0):
    """Synthetic molecule-scale graphs: ~``nodes`` atoms, ``degree``
    incident edges per node (ring-offset structure), random positions, the
    edge length as ``edge_attr``, and targets ``[sum x]`` and ``x[:, :1]``
    (the JAX package's ``make_graphs``, draw for draw)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        lo = max(2, nodes - 10)  # ring edges need >= 2 nodes
        n = int(rng.integers(lo, nodes + 1))
        g = GraphData(
            x=rng.random((n, 1)).astype(np.float32),
            pos=(rng.random((n, 3)) * n ** (1 / 3)).astype(np.float32),
        )
        src = np.repeat(np.arange(n), degree // 2)
        dst = (src + rng.integers(1, n, src.shape[0])) % n
        g.edge_index = np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int64)
        d = np.linalg.norm(g.pos[g.edge_index[0]] - g.pos[g.edge_index[1]], axis=1)
        g.edge_attr = d[:, None].astype(np.float32)
        g.targets = [np.array([g.x.sum()], np.float32), g.x[:, :1].astype(np.float32)]
        out.append(g)
    return out


def _arch(model_type, hidden, layers, nodes):
    """The architecture section of a bench row: a graph head (2 shared
    layers, 2 head layers) and a node ``mlp`` head, ``max(32, hidden //
    4)`` wide."""
    shared = max(32, hidden // 4)
    return {
        "model_type": model_type,
        "input_dim": 1,
        "hidden_dim": hidden,
        "output_dim": [1, 1],
        "output_type": ["graph", "node"],
        "output_heads": {
            "graph": {
                "num_sharedlayers": 2,
                "dim_sharedlayers": shared,
                "num_headlayers": 2,
                "dim_headlayers": [shared, shared],
            },
            "node": {"num_headlayers": 2, "dim_headlayers": [shared, shared], "type": "mlp"},
        },
        "task_weights": [1.0, 1.0],
        "num_conv_layers": layers,
        "num_nodes": nodes,
        "edge_dim": None,
        "pna_deg": [0, 0, 16, 32, 64, 32],
        "equivariance": model_type == "EGNN",
        "num_gaussians": 50,
        "num_filters": hidden,
        "radius": 5.0,
    }


def _collate(samples, num_graphs, nodes, degree):
    """One padded batch with both heads' targets, padded for ``num_graphs``
    graphs of ``nodes`` atoms and ``degree`` edges per atom."""
    n_pad, e_pad, g_pad = pad_sizes_for(nodes, nodes * degree, num_graphs)
    return collate_graphs(
        samples, n_pad, e_pad, g_pad, head_types=("graph", "node"), head_dims=(1, 1),
    )


def config_identity(model_type="PNA", hidden=64, num_graphs=64, nodes=90,
                    degree=12, layers=3, bf16=False, dense=False, **_ignored):
    """The row identity a ``bench_model(**kw)`` call produces (the JAX
    package's keys)."""
    return {
        "model": model_type,
        "hidden": hidden,
        "graphs_per_batch": num_graphs,
        "nodes_per_graph": nodes,
        "avg_degree": degree,
        "layers": layers,
        "precision": "bf16" if bf16 else "f32",
        "aggregation": "dense" if dense else "segment",
    }


def bench_model(model_type="PNA", hidden=64, num_graphs=64, nodes=90, degree=12,
                layers=3, bf16=False, dense=False, iters=20, seed=0, device=None,
                trace_path=None):
    """Time the training step of one configuration. Returns the JAX row's
    fields: the identity, ``ms_per_step``, ``graphs_per_sec``,
    ``flops_per_step``, ``achieved_tflops``, ``mfu_pct``, ``device_kind``
    and ``peak_tflops_assumed``, with ``final_loss`` and ``eval_loss``.

    ``device``: the card unless ``"cpu"``.
    ``trace_path``: one more step runs under ``torch.profiler`` and its
    Chrome trace is written there."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = resolve_device(device)
    samples = make_graphs(num_graphs, nodes, degree, seed)
    batch = _collate(samples, num_graphs, nodes, degree)
    if dense:
        batch = attach_neighbor_lists(batch)
    model = create_model_config(
        _arch(model_type, hidden, layers, nodes), device=dev, aggregation="segment", seed=seed,
    )
    trainer = Trainer(model, {
        "Optimizer": {"type": "AdamW", "learning_rate": 1e-3},
        "mixed_precision": bool(bf16),
    })
    state = trainer.init_state(batch)
    dbatch = trainer.put_batch(batch)

    with FlopCounterMode(display=False) as counter:
        state, metrics = trainer.train_step(state, dbatch)  # warm step
    flops = int(counter.get_total_flops())
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.train_step(state, dbatch)
    if on_card:
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        dt = (time.perf_counter() - t0) / iters
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"the loss is not finite after {iters + 1} steps: {loss}")
    eval_loss = float(trainer.eval_step(state, dbatch)["loss"])
    if trace_path is not None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            state, metrics = trainer.train_step(state, dbatch)
            if on_card:
                torch.cuda.synchronize(dev)
        prof.export_chrome_trace(str(trace_path))

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak = PEAK_TFLOPS.get(kind, {}).get("bf16" if bf16 else "f32")
    tflops = flops / dt / 1e12
    return {
        **config_identity(model_type=model_type, hidden=hidden, num_graphs=num_graphs,
                          nodes=nodes, degree=degree, layers=layers, bf16=bf16, dense=dense),
        "ms_per_step": dt * 1e3,
        "graphs_per_sec": num_graphs / dt,
        "flops_per_step": flops,
        "achieved_tflops": tflops,
        "mfu_pct": 100.0 * tflops / peak if peak else None,
        "device_kind": kind,
        "peak_tflops_assumed": peak,
        "final_loss": loss,
        "eval_loss": eval_loss,
    }

