"""The training-step benchmark with MFU (port of ``benchmarks/model_bench.py``).

:func:`bench_model` builds a model and a batch as the JAX package's
``bench_model`` does (``make_graphs`` -> ``_collate`` -> the dense
neighbour lists when asked -> ``create_model_config(_arch(...))`` ->
``Trainer`` with AdamW at lr 1e-3 and ``mixed_precision = bf16``), takes
one warm step (on the card: the step's capture, then its first replay),
then times ``iters`` steps with CUDA events around them and one
synchronise at the end, then takes one ``eval_step``: the captured step,
the program the JAX package's ``bench_model`` times. Beside it,
``eager_ms_per_step`` times ``iters`` more steps of the same body run
eagerly (``steps.train_step``, one launch per op from Python): a second
measurement of the same step, not a mode. :data:`MXU_HEADLINE` is the JAX package's
headline configuration (``bench.py:517-518``), :data:`MXU_ROWS` its
MXU-scale rows of the eight other stacks (``bench.py:291-292,302-311``):
GIN, GAT, SAGE, MFC, SchNet and EGNN at hidden 256, CGCNN at ``input_dim``
256 (its width; hidden 64), DimeNet at hidden 128, each in segment f32
and dense bf16. A DimeNet batch carries its triplet tables (and, dense,
the lists' slot tables).

``flops_per_step`` is the matmul work of one step (forward and backward),
counted from the products' shapes by ``torch.utils.flop_counter
.FlopCounterMode`` on the first eager step. XLA's count, which the JAX package
reports, also counts elementwise work, so the two are not the same
number. MFU is against the precision's peak of the card (NVIDIA's data
sheet for the H100 SXM: 989 TFLOP/s bf16 dense, 67 TFLOP/s f32 outside
the tensor cores); a card the table does not know, or the CPU, gives
``mfu_pct: None``. A batch without the lists takes the port's ``segment``
mode, the row's ``aggregation``. Not ported: ``remat`` (conv
checkpointing) and ``mesh`` (``ROADMAP.md``).
"""

import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.graph import collate_graphs, compute_triplets, pack_triplets, pad_sizes_for
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.obs.ledger import PEAK_FLOPS
from hydragnn_tpu_torch.ops.dense_agg import attach_neighbor_lists
from hydragnn_tpu_torch.train import Trainer, steps
from hydragnn_tpu_torch.utils import resolve_device

MXU_HEADLINE = dict(model_type="PNA", hidden=256, num_graphs=64, nodes=90,
                    degree=12, layers=3, dense=True, bf16=True)
# the MXU-scale matrix of the other eight stacks on the oc20 shape, in
# segment f32 and in dense bf16: hidden 256 (``bench.py:302-305``), CGCNN
# at its width, input_dim 256 (``:291-292``; its hidden-256 rows run at
# width 1), DimeNet at hidden 128 (``:309-311``)
_OC20 = dict(num_graphs=64, nodes=90, degree=12, layers=3)
MXU_ROWS = [
    dict(model_type=m, **width, **_OC20, **mode)
    for m, width in (
        ("GIN", {"hidden": 256}),
        ("SAGE", {"hidden": 256}),
        ("SchNet", {"hidden": 256}),
        ("EGNN", {"hidden": 256}),
        ("GAT", {"hidden": 256}),
        ("MFC", {"hidden": 256}),
        ("CGCNN", {"hidden": 64, "input_dim": 256}),
        ("DimeNet", {"hidden": 128}),
    )
    for mode in ({}, {"dense": True, "bf16": True})
]

# peak dense TFLOP/s by torch.cuda.get_device_name() and precision: the
# live MFU gauge's table (obs/ledger.PEAK_FLOPS), so that the two cannot
# drift apart
PEAK_TFLOPS = {kind: {prec: flops / 1e12 for prec, flops in row.items()}
               for kind, row in PEAK_FLOPS.items()}


def make_graphs(num_graphs, nodes, degree, seed=0, input_dim=1):
    """Synthetic molecule-scale graphs: ~``nodes`` atoms, ``degree``
    incident edges per node (ring-offset structure), random positions, the
    edge length as ``edge_attr``, ``input_dim`` node features, and targets
    ``[sum x]`` and ``x[:, :1]`` (the JAX package's ``make_graphs``, draw
    for draw)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        lo = max(2, nodes - 10)  # ring edges need >= 2 nodes
        n = int(rng.integers(lo, nodes + 1))
        g = GraphData(
            x=rng.random((n, input_dim)).astype(np.float32),
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


def _arch(model_type, hidden, layers, nodes, input_dim=1):
    """The architecture section of a bench row: a graph head (2 shared
    layers, 2 head layers) and a node ``mlp`` head, ``max(32, hidden //
    4)`` wide, and every stack's own keys."""
    shared = max(32, hidden // 4)
    return {
        "model_type": model_type,
        "input_dim": input_dim,
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
        "max_neighbours": 50,
        "num_gaussians": 50,
        "num_filters": hidden,
        "radius": 5.0,
        "basis_emb_size": 8,
        "envelope_exponent": 5,
        "int_emb_size": 64,
        "out_emb_size": 128,
        "num_after_skip": 2,
        "num_before_skip": 1,
        "num_radial": 6,
        "num_spherical": 7,
    }


def _collate(samples, num_graphs, nodes, degree, with_triplets=False):
    """One padded batch with both heads' targets, padded for ``num_graphs``
    graphs of ``nodes`` atoms and ``degree`` edges per atom; with
    ``with_triplets``, DimeNet's triplet tables (``t_pad``: the total
    rounded up to 8)."""
    n_pad, e_pad, g_pad = pad_sizes_for(nodes, nodes * degree, num_graphs)
    batch = collate_graphs(
        samples, n_pad, e_pad, g_pad, head_types=("graph", "node"), head_dims=(1, 1),
    )
    if not with_triplets:
        return batch
    trips = [compute_triplets(s.edge_index, s.num_nodes) + (s.num_nodes, s.num_edges)
             for s in samples]
    return batch.with_extras({k: torch.from_numpy(v) for k, v in pack_triplets(trips, n_pad).items()})


def config_identity(model_type="PNA", hidden=64, num_graphs=64, nodes=90,
                    degree=12, layers=3, bf16=False, dense=False, input_dim=1, **_ignored):
    """The row identity a ``bench_model(**kw)`` call produces (the JAX
    package's keys; ``input_dim`` only where it is not 1)."""
    ident = {
        "model": model_type,
        "hidden": hidden,
        "graphs_per_batch": num_graphs,
        "nodes_per_graph": nodes,
        "avg_degree": degree,
        "layers": layers,
        "precision": "bf16" if bf16 else "f32",
        "aggregation": "dense" if dense else "segment",
    }
    if input_dim != 1:
        ident["input_dim"] = input_dim
    return ident


def bench_model(model_type="PNA", hidden=64, num_graphs=64, nodes=90, degree=12,
                layers=3, bf16=False, dense=False, iters=20, seed=0, device=None,
                trace_path=None, input_dim=1):
    """Time the training step of one configuration. Returns the JAX row's
    fields: the identity, ``ms_per_step``, ``graphs_per_sec``,
    ``flops_per_step``, ``achieved_tflops``, ``mfu_pct``, ``device_kind``
    and ``peak_tflops_assumed``, with ``final_loss`` and ``eval_loss``,
    and beside them ``eager_ms_per_step`` and the steps taken each way
    (``captured_steps``: the warm step, the timed ones and the profiled
    one; ``eager_steps``).

    ``device``: the card unless ``"cpu"``.
    ``trace_path``: one more step runs under ``torch.profiler`` and its
    Chrome trace is written there. ``input_dim``: the node features' width
    (CGCNN's conv width)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = resolve_device(device)
    samples = make_graphs(num_graphs, nodes, degree, seed, input_dim=input_dim)
    batch = _collate(samples, num_graphs, nodes, degree, with_triplets=model_type == "DimeNet")
    if dense:
        batch = attach_neighbor_lists(batch)
    model = create_model_config(
        _arch(model_type, hidden, layers, nodes, input_dim=input_dim), device=dev,
        aggregation="segment", seed=seed,
    )
    trainer = Trainer(model, {
        "Optimizer": {"type": "AdamW", "learning_rate": 1e-3},
        "mixed_precision": bool(bf16),
    })
    state = trainer.init_state(batch)
    dbatch = trainer.put_batch(batch)
    on_card = dev.type == "cuda"

    def timed(step):
        """Seconds per step of ``iters`` calls of ``step``."""
        if on_card:
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        if on_card:
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / 1e3 / iters, out
        return (time.perf_counter() - t0) / iters, out

    state, metrics = trainer.train_step(state, dbatch)  # warm step: the capture
    dt, (state, metrics) = timed(lambda: trainer.train_step(state, dbatch))
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

    # the same body taken eagerly
    def eager():
        return steps.train_step(state, dbatch, guarded=trainer.guarded,
                                mixed=trainer.precision["mixed"], generator=trainer.generator)

    with FlopCounterMode(display=False) as counter:
        eager()
    flops = int(counter.get_total_flops())
    eager_dt, _ = timed(eager)
    trainer.release()

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak = PEAK_TFLOPS.get(kind, {}).get("bf16" if bf16 else "f32")
    tflops = flops / dt / 1e12
    return {
        **config_identity(model_type=model_type, hidden=hidden, num_graphs=num_graphs,
                          nodes=nodes, degree=degree, layers=layers, bf16=bf16, dense=dense,
                          input_dim=input_dim),
        "ms_per_step": dt * 1e3,
        "eager_ms_per_step": eager_dt * 1e3,
        "captured_steps": 1 + iters + (trace_path is not None),
        "eager_steps": 1 + iters,
        "graphs_per_sec": num_graphs / dt,
        "flops_per_step": flops,
        "achieved_tflops": tflops,
        "mfu_pct": 100.0 * tflops / peak if peak else None,
        "device_kind": kind,
        "peak_tflops_assumed": peak,
        "final_loss": loss,
        "eval_loss": eval_loss,
    }

