#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny size, plain versions, CPU

Phases, in order; any failure raises and exits non-zero:

1. Card: requires ``torch.cuda.is_available()``, prints the card's name and
   power limit (``nvidia-smi``) and turns TF32 off for f32 products.
2. Build: compiles every kernel of the path from ``hydragnn_tpu_torch/csrc``
   with nvcc for sm_90a and prints the build time.
3. Kernels: calls each kernel's wrapper (K1 segment_sum, K2
   segment_moments, K3 fused_gather_moments, K4 fused_gather_sum, K5
   fused_gather_mean, K6 fused_gather_weighted_sum, K7
   fused_egnn_edge_phase) on card tensors at the main path's shapes, holds
   the result against the plain PyTorch version on the same inputs
   (tolerance ``1e-5 * (max |partial sum| + 1)``: atomics add in a
   run-dependent order; K7 ``1e-4 * (max |out| + 1)``: its two 256-term
   dot products per edge also sum in another order). K1 runs at three
   shapes: the pool, the segment mode's sum at the receivers, and that
   sum at K6's 50 columns; K6 at its served 50 filters and at 256. Times,
   with CUDA events: ``ms``, the call (20 calls back to back, so the
   host's work per call can set the pace; the median of 5 such windows,
   taken in turns), for the kernel, its plain version and the one PyTorch
   call that computes the same function, where there is one (K1:
   ``index_add_``; K4 and K5: ``torch.sparse.mm`` of the CSR adjacency,
   :func:`sparse_yardstick`); ``device_ms``, the kernel alone (the same 20
   calls, fewer where they would fill the launch queue, queued behind
   ``torch.cuda._sleep``, so the device runs them back to back; min,
   median and max of 5 repeats), for the kernel and the
   library call. Then samples the SM clock and power draw.
4. Serve: bench.py's MXU-scale row for each of PNA, GIN, SAGE, SchNet and
   EGNN (hidden 256, 3 conv layers, a graph head and a node head of
   64-wide layers, ``benchmarks/model_bench.py:_arch``; random weights from
   a seed, non-trivial BatchNorm statistics where the stack has any)
   served by ``InferenceServer`` to 320 molecule-sized graphs (80-90
   atoms, 12 edges per atom) from four threads, once per aggregation mode.
   Launch counters are zeroed just before each run and read just after;
   every kernel of that family's and mode's path must have launched as
   often as its forwards need. Every response is held against a CPU copy
   of the model (the plain versions) run on the graphs of its batch,
   packed into the same bucket. One full batch of each run is broken down
   on the device.
5. Train: bench.py's MXU-scale PNA row (as in phase 4; seeded targets, a
   graph target ``[1]`` and a node target ``[n, 1]`` per its
   ``output_dim``) trained through ``Trainer`` (``init_state`` ->
   ``put_batch`` -> ``train_step`` with AdamW at lr 1e-3 -> ``eval_step``)
   on the largest bucket's batch (n_pad 5768, e_pad 69120, g_pad 65): in
   f32 in ``fused`` and ``segment`` mode, and with the batch's dense
   neighbour lists (PNA's dense branch) in f32 and in bf16 mixed
   precision. Each run: 1 warm step, 20 timed steps (CUDA events, the
   median of 5 windows of 4 steps), one profiled step. Every step
   launches K3 3 times and K1 4 times (the pool, and K3's backward rule
   summing at the senders) in ``fused`` mode, K2 3 times and K1 once in
   ``segment`` mode, K1 once (the pool) in ``dense`` mode; the counts are
   held per step. Every loss is finite and the last is below the first.
   Step 1 is held against CPU copies of the model taken before it, on
   the same batch: one in float64, the exact step's stand-in, and the
   witness, through the plain versions at the run's precision, which
   shows how far that arithmetic itself lies from it (in float32 up to
   ~1% of a gradient's max: sums that cancel, PNA's one-pass variance);
   in bf16 a second witness takes the batch's graphs in the reverse
   order.
   Per tensor (the loss, each gradient, each BatchNorm statistic), ``|card
   - exact| <= (atol + factor * level) * max|exact| + rtol * |exact|``
   elementwise (the serve phase's rtol 1e-3 and atol 1e-4; ``level`` the
   witness's error relative to each tensor's max, in f32 the largest over
   the tensor's kind, in bf16 the tensor's own, the larger of its two
   witnesses'; ``factor`` ``F32_FACTOR`` or ``BF16_FACTOR``), and every
   updated
   parameter within the serve bound plus what AdamW's first step makes of
   the gradient's error (:func:`hold_step_against_cpu`). The profiled
   step's device time is split into forward, backward and optimizer
   (:func:`split_trace`). One ``{"train": ...}`` line per run.
   Then the JAX package's headline, ``MXU_HEADLINE``, through the port's
   ``bench_model(**MXU_HEADLINE, iters=20)``: one ``{"train": ...}``
   line with ms per step, graphs/s, the step's
   matmul FLOPs and MFU, the device split and the card's name and power
   limit. PNA is also served once more in phase 4 on a plan whose batches
   carry the dense lists (``plan_from_samples(need_neighbors=True)``);
   building the lists is host work, in ``pack_ms_host``.
6. Prints one JSON line per kernel case, the card's name and power limit,
   the ``{"kernels": [...]}`` summary (per kernel, its main case's
   ``ms`` and median ``device_ms`` beside the bound, the plain version's
   ``plain_ms`` and the library call's ``library_ms`` and
   ``library_device_ms``; for K2 and K6, which no one PyTorch call
   computes, ``reference_device_ms``: K1's at the same receivers shape,
   which streams the same ``[E, D]`` bytes; ``launches`` counts phases 4
   and 5), and as the last line ``{"ok": true, "device": {"platform":
   "gpu", ...}}``.

``--cpu-rehearsal`` runs phases 3-5 at a tiny size on the CPU through the
plain versions, to check the script's control flow without a card. It
times nothing on a device and never prints the success line.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from hydragnn_tpu_torch.benchmarks.model_bench import (
    MXU_HEADLINE,
    MXU_ROWS,
    _arch,
    bench_model,
    make_graphs,
)
from hydragnn_tpu_torch.graph import collate_graphs
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.ops import (
    KERNELS,
    _build,
    fused_mp,
    launch_counts,
    reset_launch_counts,
)
from hydragnn_tpu_torch.ops.dense_agg import attach_neighbor_lists
from hydragnn_tpu_torch.ops.fused_mp import egnn_tolerance
from hydragnn_tpu_torch.ops.segment_kernels import atomic_tolerance
from hydragnn_tpu_torch.serve import (
    InferenceServer,
    ModelRegistry,
    plan_from_samples,
)
from hydragnn_tpu_torch.train import Trainer
from hydragnn_tpu_torch.utils.timing import call_ms, device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# benchmarks/model_bench.py:_arch at bench.py's MXU_HEADLINE (PNA, hidden
# 256, 3 layers, 90-atom graphs, degree 12); edge_dim None as there
FULL = dict(hidden=256, layers=3, nodes=90, degree=12, graphs=320, batch=64)
TINY = dict(hidden=16, layers=2, nodes=12, degree=4, graphs=24, batch=4)

# K2-K6 are one kernel (gather_reduce.cuh) behind the C entries of
# segment.cu (K2) and fused_mp.cu (K3-K6)
SOURCE = {
    "segment_sum": "hydragnn_tpu_torch/csrc/segment.cu",
    "segment_moments": "hydragnn_tpu_torch/csrc/gather_reduce.cuh",
    "fused_gather_moments": "hydragnn_tpu_torch/csrc/gather_reduce.cuh",
    "fused_gather_sum": "hydragnn_tpu_torch/csrc/gather_reduce.cuh",
    "fused_gather_mean": "hydragnn_tpu_torch/csrc/gather_reduce.cuh",
    "fused_gather_weighted_sum": "hydragnn_tpu_torch/csrc/gather_reduce.cuh",
    "fused_egnn_edge_phase": "hydragnn_tpu_torch/csrc/fused_egnn.cu",
}
# the pallas_call each kernel replaces (K3-K7 are the edge ops of one)
REPLACES = {
    "segment_sum": "hydragnn_tpu/ops/pallas_segment.py:125",
    "segment_moments": "hydragnn_tpu/ops/pallas_segment.py:200",
    "fused_gather_moments": "hydragnn_tpu/ops/fused_mp.py:322",
    "fused_gather_sum": "hydragnn_tpu/ops/fused_mp.py:322",
    "fused_gather_mean": "hydragnn_tpu/ops/fused_mp.py:322",
    "fused_gather_weighted_sum": "hydragnn_tpu/ops/fused_mp.py:322",
    "fused_egnn_edge_phase": "hydragnn_tpu/ops/fused_mp.py:322",
}
FAMILIES = ("PNA", "GIN", "SAGE", "SchNet", "EGNN")
# each family's conv aggregation in "fused" mode (in "segment" mode PNA's
# is K2 and the others' the gather in PyTorch, then K1)
FUSED_KERNEL = {
    "PNA": "fused_gather_moments",
    "GIN": "fused_gather_sum",
    "SAGE": "fused_gather_mean",
    "SchNet": "fused_gather_weighted_sum",
    "EGNN": "fused_egnn_edge_phase",
}
SCHNET_FILTERS = 50  # model_bench's num_gaussians: SchNet's filters (swapped)
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4  # card (atomics, cuBLAS) against CPU
TRAIN_CONFIG = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
TRAIN_WINDOWS, TRAIN_WINDOW_STEPS = 5, 4  # 20 timed steps
STACK_TRAIN_WINDOWS = 2  # GIN, SAGE, SchNet, EGNN: 8 timed steps a run
HEADLINE_ITERS = 20  # bench.py's bench_headline_mxu: bench_model(**MXU_HEADLINE, iters=20)


def aggregation_of(mode):
    """The model's ``aggregation`` for a run's mode: a ``dense`` batch
    takes the lists' branch whatever it is."""
    return "fused" if mode == "dense" else mode


def launches_per_forward(cfg, mode):
    """``{kernel: launches}`` one forward of ``cfg``'s stack needs (mode
    ``dense``: PNA's neighbour-list branch runs no kernel)."""
    family, layers = cfg["model_type"], cfg["num_conv_layers"]
    counts = {name: 0 for name in KERNELS}
    counts["segment_sum"] = 1  # global_mean_pool
    if mode == "dense":
        return counts
    if mode == "fused":
        counts[FUSED_KERNEL[family]] = layers
    elif family == "PNA":
        counts["segment_moments"] = layers
    else:
        counts["segment_sum"] += layers
    if family == "SchNet" and cfg["equivariance"]:
        counts["segment_sum"] += layers - 1  # the coordinate update's sum
    return counts


def arch(size, model_type="PNA"):
    shared = max(32, size["hidden"] // 4)
    return {
        "model_type": model_type,
        "input_dim": 1,
        "hidden_dim": size["hidden"],
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
        "num_conv_layers": size["layers"],
        "num_nodes": size["nodes"],
        "edge_dim": None,
        "pna_deg": [0, 0, 16, 32, 64, 32],
        "equivariance": model_type == "EGNN",
        "num_gaussians": SCHNET_FILTERS,
        "num_filters": size["hidden"],
        "radius": 5.0,
    }


def sparse_yardstick(x, senders, receivers, num_segments, edge_mask, count=False):
    """``(A, xs)`` such that ``torch.sparse.mm(A, xs)`` is K4's function
    (``count=False``: ``[S, D]``) or K5's packed ``[sum | deg]``
    (``count=True``: ``[S, D + 1]``), the library call K4 and K5 are held
    against. ``A`` is CSR with value ``mask[e]`` at ``(receivers[e],
    senders[e])``; an edge whose receiver lies out of range adds nothing and
    is dropped. An edge whose sender lies out of range gathers a zero row:
    for K4 it is dropped too; for K5 it still counts, so ``xs`` is ``[x |
    1]`` with one more row ``[0 | 1]``, at which such an edge points."""
    n, d = x.shape
    keep = (receivers >= 0) & (receivers < num_segments)
    snd_ok = (senders >= 0) & (senders < n)
    if count:
        cols = torch.where(snd_ok, senders, n)
        ones = torch.ones((n + 1, 1), dtype=x.dtype, device=x.device)
        xs = torch.cat([torch.cat([x, x.new_zeros((1, d))]), ones], dim=1)
    else:
        keep = keep & snd_ok
        cols, xs = senders, x
    idx = torch.stack([receivers[keep], cols[keep]]).long()
    vals = edge_mask[keep].to(torch.float32)
    a = torch.sparse_coo_tensor(idx, vals, (num_segments, xs.shape[0]), check_invariants=True)
    return a.coalesce().to_sparse_csr(), xs


def median(triple):
    """The median of a ``device_ms`` ``[min, median, max]``, or ``None``."""
    return None if triple is None else triple[1]


def min_max(triple):
    return None if triple is None else [triple[0], triple[2]]


def emit(obj):
    print(json.dumps(obj), flush=True)


# ---- phase 1 ----------------------------------------------------------------


def card_line(query="name,power.limit"):
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def clocks_line():
    """SM clock, power draw and temperature, sampled right after a timed
    window (a card may run below its peak clock)."""
    return card_line("clocks.sm,power.draw,power.limit,temperature.gpu")


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}",
        flush=True,
    )
    return card


# ---- phase 2 ----------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    for src in _build.SOURCES:
        _build.load(src[: -len(".cu")])
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s into {out_dir.relative_to(_build.REPO_ROOT)}", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}", flush=True)


# ---- phase 3 ----------------------------------------------------------------


def timings(fn, plain, library, device):
    """Call and device times of a kernel's wrapper, its plain version's
    call time, and the call and device times of one PyTorch library call
    for the same function where there is one."""
    calls = call_ms([fn, plain] if library is None else [fn, plain, library], device)
    return dict(
        ms=calls[0],
        device_ms=device_ms(fn, device),
        plain_ms=calls[1],
        library_ms=None if library is None else calls[2],
        library_device_ms=None if library is None else device_ms(library, device),
    )


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def largest_take(plan, graphs):
    """The graphs of the main path's largest batch: the last bucket filled
    greedily with the graphs it admits."""
    b = plan.num_buckets - 1
    take, n, e = [], 0, 0
    for g in graphs:
        if plan.admit(g)[0] != b:
            continue
        if not plan.fits_batch(b, n, e, len(take), plan.request_sizes(g)):
            break
        take.append(g)
        n += g.num_nodes
        e += g.num_edges
    return take, b


def largest_batch(plan, graphs):
    """The main path's largest packed batch (inputs only)."""
    take, b = largest_take(plan, graphs)
    return plan.pack(take, b)[0]


def phase_kernels(plan, graphs, hidden, device):
    """Each kernel against its plain version at the main path's shapes."""
    batch = largest_batch(plan, graphs).to(device)
    n_pad, e_pad, g_pad = batch.num_nodes, batch.num_edges, batch.num_graphs
    rng = np.random.default_rng(1)
    node_mask = batch.node_mask[:, None]
    edge_mask = batch.edge_mask
    e_valid = int(edge_mask.sum())

    def rand(rows, cols, mask=None):
        t = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32)).to(device)
        return t if mask is None else torch.where(mask, t, 0.0)

    seg_sum, seg_sum_plain = KERNELS["segment_sum"]
    seg_mom, seg_mom_plain = KERNELS["segment_moments"]
    fgm, fgm_plain = KERNELS["fused_gather_moments"]
    cases = []

    # K1: global_mean_pool's sum, [n_pad, hidden] by sorted graph ids; and
    # the segment mode's sum at the receivers, [e_pad, hidden] edge-masked
    # into n_pad rows (3 of every 4 K1 launches of a segment-mode forward),
    # and at K6's width (K6's reference: the same w bytes streamed)
    rcv, snd = batch.receivers, batch.senders
    for rows, d, ids, segs, mask, what in (
        (n_pad, hidden, batch.node_graph, g_pad, node_mask, "pool"),
        (e_pad, hidden, rcv, n_pad, edge_mask[:, None], "receivers"),
        (e_pad, SCHNET_FILTERS, rcv, n_pad, edge_mask[:, None], "receivers"),
    ):
        x = rand(rows, d, mask)
        got, ref = seg_sum(x, ids, segs), seg_sum_plain(x, ids, segs)
        nbytes = (rows * d + rows + segs * d) * 4
        cases.append(dict(
            kernel="segment_sum", case=f"{what} [{rows},{d}] -> [{segs},{d}]",
            main=what == "pool", err=float((got - ref).abs().max()),
            tol=atomic_tolerance(seg_sum_plain(x.abs(), ids, segs)),
            **timings(
                lambda: seg_sum(x, ids, segs), lambda: seg_sum_plain(x, ids, segs),
                lambda: torch.zeros((segs, d), device=device).index_add_(0, ids, x),
                device,
            ),
            bound=bound(nbytes, rows * d),
        ))

    # K2: the segment mode's moments of z at the receivers, D = 1 and hidden
    for d in (1, hidden):
        z = rand(e_pad, d, edge_mask[:, None])
        got, ref = seg_mom(z, rcv, n_pad), seg_mom_plain(z, rcv, n_pad)
        tol = atomic_tolerance(seg_sum_plain(torch.cat([z.abs(), z * z], 1), rcv, n_pad))
        nbytes = (e_pad * d + e_pad + 2 * n_pad * d + n_pad) * 4
        cases.append(dict(
            kernel="segment_moments", case=f"moments [{e_pad},{d}] -> [{n_pad},{d}]",
            main=d == hidden, err=max(float((g - r).abs().max()) for g, r in zip(got, ref)),
            tol=tol,
            **timings(
                lambda: seg_mom(z, rcv, n_pad),
                lambda: seg_mom_plain(z, rcv, n_pad),
                None, device,
            ),
            bound=bound(nbytes, e_pad * (3 * d + 1)),
        ))

    # K3: the fused mode's statistics pass, D = 1 and hidden, with and
    # without the edge encoding (the main path has no edge features)
    for d in (1, hidden):
        yj = rand(n_pad, d)
        for with_ze in (False, True):
            ze = rand(e_pad, d) if with_ze else None
            got = fgm(yj, snd, rcv, n_pad, edge_mask, ze=ze)
            ref = fgm_plain(yj, snd, rcv, n_pad, edge_mask, ze=ze)
            zr = ref[3]
            tol = atomic_tolerance(seg_sum_plain(torch.cat([zr.abs(), zr * zr], 1), rcv, n_pad))
            nbytes = (
                n_pad * d * 4 + (e_pad * d * 4 if with_ze else 0) + e_pad  # yj, ze, bool mask
                + 2 * e_pad * 4 + n_pad * (2 * d + 1) * 4 + e_pad * d * 4  # ids, out, z
            )
            cases.append(dict(
                kernel="fused_gather_moments",
                case=f"gather+moments yj [{n_pad},{d}] E {e_pad}" + (" +ze" if with_ze else ""),
                main=d == hidden and not with_ze,
                err=max(float((g - r).abs().max()) for g, r in zip(got, ref)), tol=tol,
                **timings(
                    lambda: fgm(yj, snd, rcv, n_pad, edge_mask, ze=ze),
                    lambda: fgm_plain(yj, snd, rcv, n_pad, edge_mask, ze=ze),
                    None, device,
                ),
                bound=bound(nbytes, e_pad * d * (4 + with_ze) + e_pad),
            ))

    # K4 / K5: GIN's sum and SAGE's mean at the receivers, D = 1 (layer 0)
    # and hidden; the node table's padding rows are zero, as after a layer
    ids_bytes = 2 * e_pad * 4 + e_pad  # senders, receivers, bool mask
    fgs, fgs_plain = KERNELS["fused_gather_sum"]
    fgmean, fgmean_plain = KERNELS["fused_gather_mean"]
    for d in (1, hidden):
        x = rand(n_pad, d, node_mask)
        tol = atomic_tolerance(fgs_plain(x.abs(), snd, rcv, n_pad, edge_mask))
        got, ref = fgs(x, snd, rcv, n_pad, edge_mask), fgs_plain(x, snd, rcv, n_pad, edge_mask)
        a, xs = sparse_yardstick(x, snd, rcv, n_pad, edge_mask)
        cases.append(dict(
            kernel="fused_gather_sum", case=f"gather+sum x [{n_pad},{d}] E {e_pad}",
            main=d == hidden, err=float((got - ref).abs().max()), tol=tol,
            **timings(
                lambda: fgs(x, snd, rcv, n_pad, edge_mask),
                lambda: fgs_plain(x, snd, rcv, n_pad, edge_mask),
                lambda: torch.sparse.mm(a, xs),
                device,
            ),
            bound=bound(2 * n_pad * d * 4 + ids_bytes, 2 * e_pad * d),
        ))
        got = fgmean(x, snd, rcv, n_pad, edge_mask)
        ref = fgmean_plain(x, snd, rcv, n_pad, edge_mask)
        a1, xs1 = sparse_yardstick(x, snd, rcv, n_pad, edge_mask, count=True)
        cases.append(dict(
            kernel="fused_gather_mean", case=f"gather+mean x [{n_pad},{d}] E {e_pad}",
            main=d == hidden, err=max(float((g - r).abs().max()) for g, r in zip(got, ref)),
            tol=tol,
            **timings(
                lambda: fgmean(x, snd, rcv, n_pad, edge_mask),
                lambda: fgmean_plain(x, snd, rcv, n_pad, edge_mask),
                lambda: torch.sparse.mm(a1, xs1),
                device,
            ),
            bound=bound(n_pad * (2 * d + 1) * 4 + ids_bytes, e_pad * (2 * d + 1) + n_pad * d),
        ))

    # K6: SchNet's filtered sum, D = its 50 filters (float2 chunks), w
    # masked; and at 256 (float4)
    fgw, fgw_plain = KERNELS["fused_gather_weighted_sum"]
    for d in (SCHNET_FILTERS, hidden):
        h, w = rand(n_pad, d), rand(e_pad, d, edge_mask[:, None])
        got, ref = fgw(h, w, snd, rcv, n_pad), fgw_plain(h, w, snd, rcv, n_pad)
        cases.append(dict(
            kernel="fused_gather_weighted_sum",
            case=f"gather*w+sum h [{n_pad},{d}] w [{e_pad},{d}]",
            main=d == SCHNET_FILTERS, err=float((got - ref).abs().max()),
            tol=atomic_tolerance(fgw_plain(h.abs(), w.abs(), snd, rcv, n_pad)),
            **timings(
                lambda: fgw(h, w, snd, rcv, n_pad),
                lambda: fgw_plain(h, w, snd, rcv, n_pad),
                None, device,
            ),
            # h and w read, out written, both id arrays
            bound=bound((2 * n_pad * d + e_pad * d) * 4 + 2 * e_pad * 4, 2 * e_pad * d),
        ))

    # K7: EGNN's edge phase at the senders, with the coordinate parameters
    # (layers 0-1 of the main path) and without (the last layer); the
    # batch's own positions, so padded edges have zero length
    egnn, egnn_plain = KERNELS["fused_egnn_edge_phase"]
    lim = 1.0 / np.sqrt(hidden)

    def unif(*shape):
        return torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32)).to(device)

    y_snd, y_rcv, pos = rand(n_pad, hidden), rand(n_pad, hidden), batch.pos
    for coord in (True, False):
        params = [unif(hidden), unif(hidden, hidden), unif(hidden)]
        if coord:
            params += [unif(hidden, hidden), unif(hidden), unif(hidden, 1)]
        args = (y_snd, y_rcv, pos, params, snd, rcv, n_pad, edge_mask)
        got, ref = egnn(*args), egnn_plain(*args)
        g = 2 if coord else 1  # H x H products per edge
        nbytes = (
            (2 * n_pad * hidden + 3 * n_pad + sum(p.numel() for p in params)) * 4
            + ids_bytes + n_pad * (hidden + (4 if coord else 1)) * 4
        )
        ops = e_pad * (2 * hidden * hidden * g + 9 * hidden + 4 * hidden * (g - 1) + 34)
        cases.append(dict(
            kernel="fused_egnn_edge_phase",
            case=f"edge MLP H {hidden} E {e_pad}" + (" +coord" if coord else ""),
            main=coord, err=float((got - ref).abs().max()), tol=egnn_tolerance(ref),
            **timings(
                lambda: egnn(*args),
                lambda: egnn_plain(*args),
                None, device,
            ),
            bound=bound(nbytes, ops),
        ))

    cases += rule_cases(batch, hidden, rng, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        print(f"clocks after the kernel timings: {clocks_line()}", flush=True)
    for c in cases:
        c["bound_ms"], c["bound_by"] = c.pop("bound")
        emit({"kernel_case": c})
        if not c["err"] <= c["tol"]:
            raise AssertionError(
                f"{c['kernel']} {c['case']}: kernel and plain version differ by "
                f"{c['err']:.3g} > {c['tol']:.3g}"
            )
    status = (
        "built, launched and within tolerance" if device.type == "cuda"
        else "not built (cpu rehearsal: plain version against itself)"
    )
    print(f"kernels: K1-K7 ({', '.join(KERNELS)}) {status} ({len(cases)} cases)",
          flush=True)
    return cases


def plain_grad(plain, args, g):
    """The plain version of a backward rule: ``torch.autograd.grad`` of
    ``plain(*args)`` (a kernel's plain version; its first output where it
    has several) with respect to every argument, pulled back from ``g``."""
    leaves = [a.detach().requires_grad_(True) for a in args]
    out = plain(*leaves)
    return torch.autograd.grad(out[0] if isinstance(out, tuple) else out, leaves, g)


def rule_cases(batch, hidden, rng, device):
    """The backward rules of K4-K7 (``ops/fused_mp.py``, ``*_rule``: what
    each ``*_vjp`` Function's backward runs) on card tensors at the main
    path's shapes, each held against its plain version: ``torch.autograd``
    through the kernel's plain forward on the same inputs. K4's and K5's
    rules (K4 with the ids swapped; K5 scales the cotangent by ``1 /
    max(deg, 1)`` first) at D = hidden, with ``torch.sparse.mm`` of the
    transposed adjacency as the library yardstick; K6's (``d_h``: K6
    swapped; ``d_w`` in PyTorch) at its 50 filters and at hidden; K7's
    (``d_y_snd``, ``d_y_rcv``, ``d_pos`` and the six parameters) with the
    coordinate parameters, tolerance :func:`egnn_tolerance` of each
    gradient."""
    n_pad, e_pad = batch.num_nodes, batch.num_edges
    snd, rcv, edge_mask = batch.senders, batch.receivers, batch.edge_mask
    ids_bytes = 2 * e_pad * 4 + e_pad

    def rand(rows, cols, mask=None):
        t = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32)).to(device)
        return t if mask is None else torch.where(mask, t, 0.0)

    def err_tol(got, ref, tols):
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        worst = max(range(len(errs)), key=lambda i: errs[i] / tols[i])
        return errs[worst], tols[worst]

    cases = []
    fgs, fgs_plain = KERNELS["fused_gather_sum"]
    fgmean, fgmean_plain = KERNELS["fused_gather_mean"]
    x = rand(n_pad, hidden, batch.node_mask[:, None])
    g = rand(n_pad, hidden)
    _, deg = fgmean_plain(x, snd, rcv, n_pad, edge_mask)
    g_scaled = g / torch.clamp(deg, min=1.0)
    r_deg = torch.clamp(deg[:, 0], min=1.0)[torch.where((rcv >= 0) & (rcv < n_pad), rcv, 0)]
    for name, fn, plain, mask, cot in (
        ("fused_gather_sum",
         lambda: fused_mp.fused_gather_sum_rule(g, snd, rcv, n_pad, edge_mask),
         lambda: plain_grad(lambda t: fgs_plain(t, snd, rcv, n_pad, edge_mask), [x], g),
         edge_mask, g),
        ("fused_gather_mean",
         lambda: fused_mp.fused_gather_mean_rule(g, deg, snd, rcv, n_pad, edge_mask),
         lambda: plain_grad(lambda t: fgmean_plain(t, snd, rcv, n_pad, edge_mask), [x], g),
         edge_mask.to(torch.float32) / r_deg, g_scaled),
    ):
        got, (ref,) = fn(), plain()
        a, xs = sparse_yardstick(g, rcv, snd, n_pad, mask)  # the transposed adjacency
        deg_bytes = n_pad * 4 if name == "fused_gather_mean" else 0
        cases.append(dict(
            kernel=name, rule=True, case=f"backward rule d_x [{n_pad},{hidden}] E {e_pad}",
            main=True, err=float((got - ref).abs().max()),
            tol=atomic_tolerance(fgs_plain(cot.abs(), rcv, snd, n_pad, edge_mask)),
            **timings(fn, plain, lambda: torch.sparse.mm(a, xs), device),
            # the function's bytes: g (and deg) and the ids read, d_x written
            bound=bound(2 * n_pad * hidden * 4 + deg_bytes + ids_bytes,
                        2 * e_pad * hidden + (n_pad * hidden if deg_bytes else 0)),
        ))

    fgw, fgw_plain = KERNELS["fused_gather_weighted_sum"]
    for d in (SCHNET_FILTERS, hidden):
        h, w, g = rand(n_pad, d), rand(e_pad, d, edge_mask[:, None]), rand(n_pad, d)
        fn = lambda: fused_mp.fused_gather_weighted_sum_rule(g, h, w, snd, rcv)  # noqa: E731
        plain = lambda: plain_grad(  # noqa: E731
            lambda a, b: fgw_plain(a, b, snd, rcv, n_pad), [h, w], g)
        got, ref = fn(), plain()
        err, tol = err_tol(got, ref, [
            atomic_tolerance(fgw_plain(g.abs(), w.abs(), rcv, snd, n_pad)),
            1e-6 * (float(ref[1].abs().max()) + 1.0),  # one product per element
        ])
        cases.append(dict(
            kernel="fused_gather_weighted_sum", rule=True,
            case=f"backward rule d_h, d_w h [{n_pad},{d}] w [{e_pad},{d}]",
            main=d == SCHNET_FILTERS, err=err, tol=tol,
            **timings(fn, plain, None, device),
            # g, h, w read; d_h, d_w written; both id arrays
            bound=bound((3 * n_pad * d + 2 * e_pad * d) * 4 + 2 * e_pad * 4, 3 * e_pad * d),
        ))

    egnn, egnn_plain = KERNELS["fused_egnn_edge_phase"]
    lim = 1.0 / np.sqrt(hidden)

    def unif(*shape):
        return torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32)).to(device)

    y_snd, y_rcv, pos = rand(n_pad, hidden), rand(n_pad, hidden), batch.pos
    params = [unif(hidden), unif(hidden, hidden), unif(hidden), unif(hidden, hidden),
              unif(hidden), unif(hidden, 1)]
    g = rand(n_pad, hidden + 4)
    fn = lambda: fused_mp.fused_egnn_edge_phase_rule(  # noqa: E731
        g, y_snd, y_rcv, pos, params, snd, rcv, edge_mask)
    plain = lambda: plain_grad(  # noqa: E731
        lambda a, b, p, *ps: egnn_plain(a, b, p, list(ps), snd, rcv, n_pad, edge_mask),
        [y_snd, y_rcv, pos] + params, g)
    d_y_snd, d_y_rcv, d_pos, _, d_params = fn()
    got, ref = [d_y_snd, d_y_rcv, d_pos] + list(d_params), plain()
    err, tol = err_tol(got, ref, [egnn_tolerance(r) for r in ref])
    nbytes = (
        (n_pad * (hidden + 4) + 2 * n_pad * hidden + 3 * n_pad) * 4  # g, y_snd, y_rcv, pos
        + 2 * sum(p.numel() for p in params) * 4 + ids_bytes  # params and their gradients
        + (2 * n_pad * hidden + 3 * n_pad) * 4  # d_y_snd, d_y_rcv, d_pos
    )
    # the edge body again, then each H x H product's input and weight
    # gradients (twice its forward's operations)
    cases.append(dict(
        kernel="fused_egnn_edge_phase", rule=True,
        case=f"backward rule H {hidden} E {e_pad} +coord",
        main=True, err=err, tol=tol, **timings(fn, plain, None, device),
        bound=bound(nbytes, e_pad * (3 * 2 * hidden * hidden * 2 + 30 * hidden)),
    ))
    return cases


# ---- phase 4 ----------------------------------------------------------------


def set_bn_stats(model, seed):
    """Non-trivial BatchNorm running statistics, from a numpy seed."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            f = buf.shape[0]
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0.0, 0.3, f).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, f).astype(np.float32)))


def phase_serve(mode, cfg, plan, graphs, device, card, threads=4):
    family = cfg["model_type"]
    model = create_model_config(cfg, device=device, aggregation=aggregation_of(mode), seed=0)
    set_bn_stats(model, seed=0)
    registry = ModelRegistry()
    registry.register(family.lower(), model)
    submitted = [0.0] * len(graphs)
    futures = [None] * len(graphs)

    def submit(indices):
        for i in indices:
            submitted[i] = time.monotonic()
            futures[i] = server.submit(graphs[i])

    reset_launch_counts()
    # room for the whole burst: the smoke measures serving, not shedding
    server = InferenceServer(registry, plan, queue_capacity=len(graphs), device=device)
    server.start()
    t0 = time.monotonic()
    workers = [
        threading.Thread(target=submit, args=(range(k, len(graphs), threads),))
        for k in range(threads)
    ]
    for w in workers:
        w.start()
    for w in workers:
        w.join(600)
        if w.is_alive():
            raise RuntimeError("a submitting thread did not finish")
    answers = [f.result(600) for f in futures]
    server.stop()
    counts = launch_counts()
    snap = server.metrics.snapshot()

    forwards = snap["batches_total"] + plan.num_buckets  # + one warmup per bucket
    if device.type == "cuda":
        expected = {k: forwards * v for k, v in launches_per_forward(cfg, mode).items()}
        if counts != expected:
            raise AssertionError(f"{family} {mode}: launches {counts}, expected {expected}")

    # every response against a CPU copy of the model (the plain versions)
    # run on the graphs of its batch, packed into the same bucket; a graph's
    # outputs do not depend on its row within the batch
    ref_model = copy.deepcopy(model).cpu()
    by_batch = {}
    for i, f in enumerate(futures):
        by_batch.setdefault(f.batch_seq, []).append(i)
    worst = 0.0
    with torch.inference_mode():
        for idx in by_batch.values():
            bucket = plan.admit(graphs[idx[0]])[0]
            batch, coords = plan.pack([graphs[i] for i in idx], bucket)
            outs = [o.numpy() for o in ref_model(batch)]
            for i, (g, off, n) in zip(idx, coords):
                for ihead, kind in enumerate(cfg["output_type"]):
                    want = outs[ihead][g] if kind == "graph" else outs[ihead][off : off + n]
                    got = answers[i][ihead]
                    if got.shape != want.shape or not np.isfinite(got).all():
                        raise AssertionError(f"{family} {mode}: bad response {i} head {ihead}")
                    np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                    worst = max(worst, float(np.abs(got - want).max()))

    lat = np.asarray([f.done_at - s for f, s in zip(futures, submitted)]) * 1e3
    wall = max(f.done_at for f in futures) - t0
    result = {
        "family": family,
        "mode": mode,
        "requests": len(graphs),
        "batches": snap["batches_total"],
        "launches": counts,
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "graphs_per_s": len(graphs) / wall,
        "max_abs_err_vs_cpu": worst,
        "padding_waste": server.metrics.padding_waste_ratio(),
        "card": card,
    }
    emit({"serve": result})
    if device.type == "cuda":
        breakdown(family, mode, model, plan, graphs, device, card)
    return result


def breakdown(family, mode, model, plan, graphs, device, card, iters=5):
    """Where one full batch's time goes: host packing, the forward with
    its transfers (host clock, synchronised), and the device's share of it
    by kernel (``torch.profiler``; "not measured" where it shows none)."""
    packs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        batch = largest_batch(plan, graphs)
        packs.append((time.perf_counter() - t0) * 1e3)

    def forward():
        with torch.inference_mode():
            outs = model(batch.to(device))
            return torch.cat([o.reshape(-1) for o in outs]).cpu()

    forward()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        forward()
        walls.append((time.perf_counter() - t0) * 1e3)
    forward_ms = float(np.median(walls))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        forward()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit({"breakdown": {
        "family": family,
        "mode": mode,
        "batch": f"n_pad {batch.num_nodes} e_pad {batch.num_edges} g_pad {batch.num_graphs}",
        "pack_ms_host": float(np.median(packs)),
        "forward_ms_host_synced": forward_ms,
        "device_ms": device_ms if by_name else "not measured",
        "device_busy_share": device_ms / forward_ms if by_name else "not measured",
        "top_device_ms": [[k, v] for k, v in top],
        "clocks": clocks_line(),
        "card": card,
    }})


# ---- phase 5 ----------------------------------------------------------------

TRAIN_PHASES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


def launches_per_train_step(cfg, mode):
    """``{kernel: launches}`` one training step of ``cfg``'s stack needs:
    the forward's, and in ``fused`` mode each backward rule's. K3's rule
    sums at the senders through K1, once a layer; K4's and K5's launch K4
    with the ids swapped, K6's K6, for every layer but the first of GIN and
    SAGE (whose input, the batch's ``x``, takes no gradient) and for every
    layer of SchNet (whose ``h = x @ lin1`` does); K7's folds through K1 at
    the senders and at the receivers, and again for ``pos`` in every layer
    after an equivariant one. The pool's and K2's rules are gathers,
    ``segment`` mode's gather has PyTorch's own backward, and ``dense`` mode
    runs no kernel but the pool."""
    family, layers = cfg["model_type"], cfg["num_conv_layers"]
    counts = launches_per_forward(cfg, mode)
    if mode != "fused":
        return counts
    if family == "PNA":
        counts["segment_sum"] += layers
    elif family in ("GIN", "SAGE"):
        counts["fused_gather_sum"] += layers - 1
    elif family == "SchNet":
        counts["fused_gather_weighted_sum"] += layers
    elif family == "EGNN":
        counts["segment_sum"] += 2 * layers + 2 * (layers - 1) * bool(cfg["equivariance"])
    return counts


def set_targets(graphs, seed):
    """Seeded targets per ``arch``'s ``output_dim``: a graph target ``[1]``
    and a node target ``[n, 1]``, functions of the inputs plus noise."""
    rng = np.random.default_rng(seed)
    for g in graphs:
        noise = 0.05 * rng.standard_normal(g.num_nodes + 1)
        g.targets = [
            np.array([2.0 * g.x.mean() - 0.5 + noise[0]], np.float32),
            (np.sin(3.0 * g.x) + noise[1:, None]).astype(np.float32),
        ]


def train_batch(plan, graphs, cfg, dense=False, reverse=False):
    """The largest bucket's batch, with the heads' targets (and with
    ``dense`` the neighbour lists, at the widths its edges need; with
    ``reverse`` its graphs in the reverse order: the same step, summed in
    another order)."""
    take, b = largest_take(plan, graphs)
    if reverse:
        take = take[::-1]
    lay = plan.layouts[b]
    batch = collate_graphs(
        take, lay.n_pad, lay.e_pad, lay.g_pad,
        head_types=tuple(cfg["output_type"]), head_dims=tuple(cfg["output_dim"]),
    )
    return attach_neighbor_lists(batch) if dense else batch


def train_config(bf16=False):
    return {**TRAIN_CONFIG, "mixed_precision": bool(bf16)}


def cpu_step(model, host, bf16=False):
    """Step 1 of ``model`` (a CPU copy) on ``host``: its loss."""
    trainer = Trainer(model, train_config(bf16))
    return trainer.train_step(trainer.init_state(host), host)[1]["loss"]


class _Torch64:
    """``torch``, with ``float32`` meaning ``float64``."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@contextlib.contextmanager
def float64_port():
    """The port computes in float32 by name (``torch.float32`` casts and
    checks); inside the block every module of the package sees ``torch``
    through :class:`_Torch64` and the default dtype is float64."""
    swapped = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("hydragnn_tpu_torch") or mod is None:
            continue
        for attr, old, new in (("torch", torch, _Torch64()),
                               ("_F32", torch.float32, torch.float64)):
            if getattr(mod, attr, None) is old:
                setattr(mod, attr, new)
                swapped.append((mod, attr, old))
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(default)
        for mod, attr, old in swapped:
            setattr(mod, attr, old)


class Float32Watch(TorchDispatchMode):
    """Records each operation that gives a float32 tensor."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in tree_leaves(out)):
            self.seen.add(str(func))
        return out


def as_float64(batch):
    def conv(t):
        return t.double() if t is not None and t.is_floating_point() else t

    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
              if f.name != "extras"}  # the lists: integer and bool tensors
    return dataclasses.replace(batch, **{
        k: tuple(conv(t) for t in v) if k == "targets" else conv(v) for k, v in fields.items()
    })


def cpu_references(model, host, bf16=False, reversed_host=None):
    """Step 1 of CPU copies of ``model`` (taken before any step) on ``host``:
    the witnesses, through the plain versions in float32 (with ``bf16``, in
    bf16 mixed precision: the card's own arithmetic; then also on
    ``reversed_host``, the same graphs in the reverse order, whose sums
    round in another order), and in float64, the exact step's stand-in
    (:func:`float64_port`; a dispatch mode watches every operation of that
    step, backward and optimizer included, and it fails if any gives a
    float32 tensor). Returns ``([(witness model, loss), ...], (f64 model,
    loss))``."""
    if bf16 and reversed_host is None:
        raise ValueError("a bf16 step needs its second witness: pass reversed_host")
    witness = copy.deepcopy(model).cpu()
    f64 = copy.deepcopy(witness).double()
    second = copy.deepcopy(witness) if bf16 else None
    with float64_port(), Float32Watch() as watch:
        loss64 = cpu_step(f64, as_float64(host))
    if watch.seen:
        raise AssertionError(f"float32 in the float64 step: {sorted(watch.seen)}")
    witnesses = [(witness, cpu_step(witness, host, bf16))]
    if bf16:
        witnesses.append((second, cpu_step(second, reversed_host, bf16)))
    return witnesses, (f64, loss64)


# The card against the exact step may lie F32_FACTOR times as far as the
# f32 CPU's worst tensor of the kind, relative to each tensor's scale:
# max(4, 1.25 times the most any card run has needed, rounded up). Over 21
# card runs (PR 7) the most was 1.77, so 4 (PERF.md). One near-tied max on
# seed 0, whose gradient the atomics send to either edge, needs 3.24 in
# about one step in sixteen (PERF.md, PR 8; tools/step_repeat_events.py).
F32_FACTOR = 4.0
# A bf16 step is held per tensor against two bf16 CPU steps as the
# witnesses (the batch's graphs in both orders; its level is each tensor's
# own, the larger of the two, not its kind's worst): by the same rule,
# 1.25 times the most the card needed over tools/train_step_tolerance.py
# --bf16 --modes dense (seeds 0-9), rounded up, and at least 4. The most
# was 1.99, so 4 (PERF.md; with one witness two seeds needed 16.9 and 37.1,
# where it had landed near the exact value by chance).
BF16_FACTOR = 4.0
ZERO_GRAD = 1e-6  # a gradient below this share of the largest is zero exactly


def snapshot(model):
    """The gradients, parameters and statistics of ``model``, on the host."""
    host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    return {
        "grad": {n: host(p.grad) for n, p in model.named_parameters()},
        "param": {n: host(p) for n, p in model.named_parameters()},
        "stat": {n: host(b) for n, b in model.named_buffers()},
    }


def step_tensors(snap, loss):
    """``{(kind, name): float64 tensor}``: the loss, each gradient, each
    updated parameter and each BatchNorm statistic of a :func:`snapshot`."""
    out = {("loss", "loss"): torch.tensor([float(loss)], dtype=torch.float64)}
    for kind in ("grad", "param", "stat"):
        out.update({(kind, n): t.double() for n, t in snap[kind].items()})
    return out


def hold_step_against_cpu(card, card_loss, cpu, exact, bf16=False):
    """Step 1 on the card against the exact step (float64 on the CPU), with
    the CPU step at the card's precision as the witness of what that
    arithmetic gives: ``card`` is the card model's :func:`snapshot`,
    ``cpu`` the witnesses and ``exact`` the exact ``(model, loss)`` from
    :func:`cpu_references`, ``bf16`` the step's precision.

    Per tensor ``t`` (the loss, each gradient, each BatchNorm statistic)
    with scale ``s`` = its exact ``max |value|`` (for a gradient that is
    zero in exact arithmetic, below ``ZERO_GRAD`` of the largest, the
    largest gradient: its float32 value is rounding of terms that cancel),
    the witness's level is ``max |cpu - exact| / s``: in f32 the largest
    over the tensors of ``t``'s kind, in bf16 ``t``'s own, the larger of
    its two witnesses' (bf16's level over a kind spans orders of
    magnitude, and its worst would hold every gradient to nothing; one
    witness can land close to the exact value by chance on an
    ill-conditioned tensor, two orders seldom both do). The card must hold ``|card - exact| <= (atol +
    factor * level) * s + rtol * |exact|`` elementwise (the serve phase's
    rtol 1e-3 and atol 1e-4; ``factor`` ``F32_FACTOR`` or
    ``BF16_FACTOR``). Each updated parameter adds what AdamW's first step
    (``lr * g / (|g| + eps)``, nearly ``lr * sign(g)``) makes of a gradient
    error ``dg`` within the gradient's bound: ``lr * dg * eps / ((|g| -
    dg)+ + eps)^2``, at most ``2 lr``.

    Returns the per-tensor rows, the violations and the levels per kind
    (the worst); each row also holds the card and the witness against the
    serve phase's bound alone (``atol * s + rtol * |exact|``), which
    float32 arithmetic does not meet everywhere."""
    lr = TRAIN_CONFIG["Optimizer"]["learning_rate"]
    eps = 1e-8
    factor = BF16_FACTOR if bf16 else F32_FACTOR
    want = step_tensors(snapshot(exact[0]), exact[1])
    got = step_tensors(card, card_loss)
    witnesses = [step_tensors(snapshot(m), loss) for m, loss in cpu]
    top_grad = max(float(t.abs().max()) for (k, _), t in want.items() if k == "grad" and t.numel())
    scale = {}
    for key, t in want.items():
        top = float(t.abs().max()) if t.numel() else 0.0
        scale[key] = top_grad if key[0] == "grad" and top <= ZERO_GRAD * top_grad else top
    own, level = {}, {}
    for key, t in want.items():
        if key[0] != "param" and t.numel() and scale[key] > 0:
            own[key] = max(float((w[key] - t).abs().max()) for w in witnesses) / scale[key]
            level[key[0]] = max(level.get(key[0], 0.0), own[key])
    rows, bad, bounds = [], [], {}
    for key in sorted(want, key=lambda k: ("loss", "grad", "stat", "param").index(k[0])):
        t, s = want[key], scale[key]
        if not t.numel():
            continue
        kind, name = key
        stated = SERVE_ATOL * s + SERVE_RTOL * t.abs()
        if kind == "param":
            g, dg = want[("grad", name)], bounds[name]
            allowed = stated + torch.clamp(
                lr * dg * eps / (torch.clamp(g.abs() - dg, min=0.0) + eps) ** 2, max=2 * lr)
            room = None
        else:
            room = (own.get(key, 0.0) if bf16 else level[kind]) * s
            allowed = stated + factor * room
            if kind == "grad":
                bounds[name] = allowed
        err = (got[key] - t).abs()
        over = float((err - stated).clamp(min=0.0).max())
        row = {
            "kind": kind, "name": name, "scale": s,
            "err": float(err.max()),
            "cpu_err": max(float((w[key] - t).abs().max()) for w in witnesses),
            "worst_over_tol": float((err / allowed).max()),
            # the least factor that passes, and the smallest fault
            # relative to the scale that the bound could miss
            "factor_needed": None if room is None else
            (over / room if room > 0 else (0.0 if over == 0 else None)),
            "reach": float(allowed.max()) / s if s > 0 else None,
            "card_outside_stated": bool((err > stated).any()),
            "cpu_outside_stated": bool(((witnesses[0][key] - t).abs() > stated).any()),
        }
        rows.append(row)
        if not bool((err <= allowed).all()):
            bad.append(row)
    return rows, bad, level


def outside_serve_bound(rows):
    """Per kind, how many tensors of the card and of the witness's CPU step
    lie outside the serve phase's bound alone, of how many."""
    out = {}
    for r in rows:
        n = out.setdefault(r["kind"], {"card": 0, "cpu_witness": 0, "of": 0})
        n["card"] += r["card_outside_stated"]
        n["cpu_witness"] += r["cpu_outside_stated"]
        n["of"] += 1
    return out


def split_trace(path):
    """Device time of one profiled step by phase and by op, and the number
    of device ops, from the profiler's trace: each kernel, copy or fill is
    put in the phase
    (``train_step.forward``, ``.backward``, ``.optimizer``; else ``other``)
    whose range on the host holds the call that launched it (matched by
    correlation id; the backward's launches come from autograd's thread
    while the main thread waits inside the backward range)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges = [
        (ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"]) for ev in events
        if ev.get("cat") == "user_annotation" and ev.get("name") in TRAIN_PHASES
    ]
    launched_at = {
        ev["args"]["correlation"]: ev["ts"] for ev in events
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {})
    }
    by_phase = {name: 0.0 for name in TRAIN_PHASES + ("other",)}
    by_op, backward_ops, count = {}, {}, 0
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        count += 1
        ms = ev.get("dur", 0.0) / 1e3
        t = launched_at.get(ev.get("args", {}).get("correlation"))
        phase = next((n for lo, hi, n in ranges if t is not None and lo <= t <= hi), "other")
        by_phase[phase] += ms
        key = ev["name"][:60]
        by_op[key] = by_op.get(key, 0.0) + ms
        if phase == "train_step.backward":
            backward_ops[key] = backward_ops.get(key, 0.0) + ms
    return by_phase, by_op, backward_ops, count


def trace_split(trace, ms_per_step):
    """A profiled step's device time from its trace (:func:`split_trace`),
    by phase, with the busy share against ``ms_per_step``."""
    by_phase, by_op, backward_ops, device_ops = split_trace(trace)
    device_ms = sum(by_phase.values())
    measured = device_ms > 0
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top_bwd = sorted(backward_ops.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        device_ms_per_step={k.split(".")[-1]: v for k, v in by_phase.items()}
        if measured else "not measured",
        device_ms_total=device_ms if measured else "not measured",
        device_busy_share=device_ms / ms_per_step if measured else "not measured",
        device_ops_per_step=device_ops,
        top_device_ms=[[k, v] for k, v in top],
        top_backward_device_ms=[[k, v] for k, v in top_bwd],
        clocks=clocks_line(),
    )


def phase_bench(name, row, size, device, card):
    """One ``bench_model`` row (``row``: its keyword arguments) through the
    port's ``bench_model``: 1 warm step, 20 steps between CUDA events, one
    ``eval_step``, then one profiled step; every step and the evaluation
    launch what :func:`launches_per_train_step` and
    :func:`launches_per_forward` say (the row's mode: ``dense`` with the
    lists, else ``bench_model``'s ``segment``). The CPU rehearsal runs the
    row at the tiny size. Prints one ``{"train": ...}`` line; returns the
    launches."""
    on_card = device.type == "cuda"
    kw = dict(row) if on_card else dict(
        row, hidden=size["hidden"], num_graphs=size["batch"],
        nodes=size["nodes"], degree=size["degree"], layers=size["layers"])
    iters = HEADLINE_ITERS if on_card else 2
    trace = _build.REPO_ROOT / "build" / "chip_smoke" / f"bench_{name}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    reset_launch_counts()
    result = bench_model(**kw, iters=iters, device=device, trace_path=trace if on_card else None)
    counts = launch_counts()
    cfg = _arch(kw["model_type"], kw["hidden"], kw["layers"], kw["nodes"])
    mode = "dense" if kw.get("dense") else "segment"
    per_step = launches_per_train_step(cfg, mode)
    per_eval = launches_per_forward(cfg, mode)
    n_steps = 1 + iters + on_card
    if on_card and counts != {k: n_steps * v + per_eval[k] for k, v in per_step.items()}:
        raise AssertionError(f"{name}: {n_steps} steps and eval launched {counts}")
    if not np.isfinite(result["eval_loss"]):
        raise AssertionError(f"{name}: eval loss {result['eval_loss']}")
    result = {"config": name, **result,
              "launches_per_step": {k: v for k, v in per_step.items() if v}}
    if on_card:
        result.update(trace_split(trace, result["ms_per_step"]))
    result.update(launches=counts, card=card)
    emit({"train": result})
    return counts


def phase_train(mode, cfg, plan, graphs, device, card, bf16=False, windows=TRAIN_WINDOWS):
    """Training of ``cfg``'s stack through the port's entry points:
    ``Trainer`` -> ``init_state`` -> ``put_batch`` -> 1 + ``windows`` x 4
    ``train_step`` (AdamW; with ``bf16``, bf16 mixed precision) -> one
    profiled step -> ``eval_step``, on the largest bucket's batch
    (``dense``: with the neighbour lists). Returns the kernel launches of
    the run."""
    model = create_model_config(cfg, device=device, aggregation=aggregation_of(mode), seed=0)
    host = train_batch(plan, graphs, cfg, dense=mode == "dense")
    precision = "bf16" if bf16 else "f32"
    factor = BF16_FACTOR if bf16 else F32_FACTOR
    # step 1 on CPU copies first, so that none of their host threads runs
    # while the card is timed
    reversed_host = train_batch(plan, graphs, cfg, dense=mode == "dense", reverse=True) \
        if bf16 else None
    cpu, exact = cpu_references(model, host, bf16, reversed_host)
    trainer = Trainer(model, train_config(bf16))
    if trainer.precision["mixed"] != bf16:
        raise AssertionError(f"the trainer resolved {trainer.precision}, not {precision}")
    state = trainer.init_state(host)
    batch = trainer.put_batch(host)
    per_step = launches_per_train_step(cfg, mode)
    launches = {name: 0 for name in KERNELS}
    on_card = device.type == "cuda"
    family = cfg["model_type"]
    what = f"{family} {mode} {precision}"

    def steps(n):
        nonlocal state
        reset_launch_counts()
        losses = []
        for _ in range(n):
            state, met = trainer.train_step(state, batch)
            losses.append(met["loss"])
        counts = launch_counts()
        if on_card and counts != {k: n * v for k, v in per_step.items()}:
            raise AssertionError(f"{what} train: {n} steps launched {counts}, "
                                 f"expected {per_step} per step")
        for k, v in counts.items():
            launches[k] += v
        return losses

    first = steps(1)[0]
    step1 = snapshot(model)

    # each window: CUDA events around 4 steps, and the host's clock around
    # issuing them (close to the events' time when the host sets the pace)
    window_ms, host_ms = [], []
    losses = [first]
    for _ in range(windows):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
        losses += steps(TRAIN_WINDOW_STEPS)
        if on_card:
            end.record()
            host_ms.append((time.perf_counter() - t0) * 1e3 / TRAIN_WINDOW_STEPS)
            window_ms.append((start, end))
    losses = [float(v) for v in torch.stack(losses).cpu()]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what} train: losses {losses}")
    rows, bad, level = hold_step_against_cpu(step1, first, cpu, exact, bf16)
    closest = sorted(rows, key=lambda r: -r["worst_over_tol"])[:8]
    emit({"train_check": {"family": family, "mode": mode, "precision": precision,
                          "tensors": len(rows),
                          "cpu_level": level, "closest": closest, "violations": bad}})
    if bad:
        raise AssertionError(f"{what} train step 1 against the exact step: {bad}")
    # SchNet and EGNN (no encoder BatchNorm, mlp heads) have no statistics
    worst = {kind: max((r["err"] for r in rows if r["kind"] == kind), default=None)
             for kind in ("loss", "grad", "param", "stat")}
    worst["over_tol"] = max(r["worst_over_tol"] for r in rows)
    need = max((r for r in rows if r["factor_needed"] is not None),
               key=lambda r: r["factor_needed"])
    graphs_per_step = int(host.graph_mask.sum())
    result = {
        "family": family, "mode": mode, "precision": precision,
        "batch": f"n_pad {batch.num_nodes} e_pad {batch.num_edges} g_pad {batch.num_graphs}",
        "graphs_per_step": graphs_per_step,
        "steps": len(losses),
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_err_vs_exact": worst["loss"],
        "max_grad_err_vs_exact": worst["grad"],
        "max_param_err_vs_exact": worst["param"],
        "max_stat_err_vs_exact": worst["stat"],
        "worst_err_over_tolerance": worst["over_tol"],
        "cpu_witness": "bf16 CPU steps, the graphs in both orders" if bf16 else "f32 CPU step",
        "cpu_level": level,
        "factor": factor,
        "factor_needed": need["factor_needed"],
        "factor_needed_by": f"{need['kind']} {need['name']}",
        "outside_serve_bound": outside_serve_bound(rows),
        "launches_per_step": {k: v for k, v in per_step.items() if v},
    }
    if on_card:
        torch.cuda.synchronize()
        per_window = [a.elapsed_time(b) / TRAIN_WINDOW_STEPS for a, b in window_ms]
        ms_per_step = float(np.median(per_window))
        result.update(ms_per_step=ms_per_step, ms_per_step_windows=per_window,
                      host_enqueue_ms_per_step_windows=host_ms,
                      graphs_per_s=graphs_per_step / ms_per_step * 1e3)
        trace = (_build.REPO_ROOT / "build" / "chip_smoke"
                 / f"train_{family}_{mode}_{precision}_trace.json")
        trace.parent.mkdir(parents=True, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            steps(1)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        result.update(trace_split(trace, ms_per_step))
    else:
        result.update(ms_per_step="not measured (cpu rehearsal)",
                      graphs_per_s="not measured (cpu rehearsal)")
    reset_launch_counts()
    ev = trainer.eval_step(state, batch)
    counts = launch_counts()
    if on_card and counts != launches_per_forward(cfg, mode):
        raise AssertionError(f"{what} eval: launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    eval_loss = float(ev["loss"])
    shapes = [tuple(o.shape) for o in ev["outputs"]]
    if not np.isfinite(eval_loss) or shapes != [(batch.num_graphs, 1), (batch.num_nodes, 1)]:
        raise AssertionError(f"{what} eval: loss {eval_loss}, outputs {shapes}")
    result.update(eval_loss=eval_loss, launches=launches, card=card)
    emit({"train": result})
    return launches


# ---- main -------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny size on the CPU through the plain versions; no success line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if args.cpu_rehearsal:
        device, size, card = torch.device("cpu"), TINY, "cpu rehearsal (no device time)"
    else:
        card = phase_card()
        phase_build()
        device, size = torch.device("cuda"), FULL

    graphs = make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0)
    plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3)
    for lay in plan.layouts:
        print(f"bucket: n_pad {lay.n_pad} e_pad {lay.e_pad} g_pad {lay.g_pad}", flush=True)

    dense_plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3,
                                   need_neighbors=True)
    for lay in dense_plan.layouts:
        print(f"dense bucket: n_pad {lay.n_pad} e_pad {lay.e_pad} g_pad {lay.g_pad} "
              f"k_in {lay.k_in} k_out {lay.k_out}", flush=True)

    cases = phase_kernels(plan, graphs, size["hidden"], device)
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    for family in FAMILIES:
        cfg = arch(size, family)
        for mode in ("fused", "segment"):
            add(phase_serve(mode, cfg, plan, graphs, device, card)["launches"])
    # the dense plan: PNA, and GIN and SAGE, which the JAX package's static
    # policy serves on the lists at this width
    for family in ("PNA", "GIN", "SAGE"):
        add(phase_serve("dense", arch(size, family), dense_plan, graphs, device, card)["launches"])

    set_targets(graphs, seed=1)
    for family in FAMILIES:
        # SchNet with its equivariant update here (the bench rows have none)
        cfg = dict(arch(size, family), equivariance=family in ("SchNet", "EGNN"))
        windows = TRAIN_WINDOWS if family == "PNA" else STACK_TRAIN_WINDOWS
        for mode, bf16 in (("fused", False), ("segment", False), ("dense", False),
                           ("dense", True)):
            add(phase_train(mode, cfg, plan, graphs, device, card, bf16=bf16, windows=windows))
    add(phase_bench("MXU_HEADLINE", MXU_HEADLINE, size, device, card))
    for row in MXU_ROWS:
        name = f"MXU_{row['model_type']}_{'dense_bf16' if row.get('dense') else 'segment_f32'}"
        add(phase_bench(name, row, size, device, card))

    # K2 and K6 beside K1 at the same receivers shape: the same [E, D] bytes
    # streamed, a sum where K2 also keeps squares and a count and K6
    # gathers and multiplies (a reference, no yardstick)
    reference = {}
    for name, d in (("segment_moments", size["hidden"]), ("fused_gather_weighted_sum", SCHNET_FILTERS)):
        k1 = next(c for c in cases if c["kernel"] == "segment_sum"
                  and c["case"].startswith(f"receivers [{plan.layouts[-1].e_pad},{d}]"))
        mine = next(c for c in cases if c["kernel"] == name and c["main"])
        reference[name] = (f"segment_sum {k1['case']}", median(k1["device_ms"]))
        print(f"reference: {name} {mine['case']} device_ms {median(mine['device_ms'])} "
              f"beside segment_sum {k1['case']} device_ms {median(k1['device_ms'])}",
              flush=True)
    summary = []
    for name in KERNELS:
        mine = [c for c in cases if c["kernel"] == name and not c.get("rule")]
        main_case = next(c for c in mine if c["main"])
        rule = next((c for c in cases if c["kernel"] == name and c.get("rule") and c["main"]),
                    None)
        summary.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(c["err"] for c in mine),
            "ms": main_case["ms"],
            "device_ms": median(main_case["device_ms"]),
            "device_ms_min_max": min_max(main_case["device_ms"]),
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "library_device_ms": median(main_case["library_device_ms"]),
            "reference": reference.get(name, (None, None))[0],
            "reference_device_ms": reference.get(name, (None, None))[1],
        })
        if rule is not None:  # its backward rule, at the main path's shapes
            summary[-1]["backward_rule"] = {
                "case": rule["case"],
                "max_abs_err": max(c["err"] for c in cases
                                   if c["kernel"] == name and c.get("rule")),
                "ms": rule["ms"],
                "device_ms": median(rule["device_ms"]),
                "device_ms_min_max": min_max(rule["device_ms"]),
                "forward_device_ms": median(main_case["device_ms"]),
                "plain_ms": rule["plain_ms"],
                "bound_ms": rule["bound_ms"],
                "bound_by": rule["bound_by"],
                "library_ms": rule["library_ms"],
                "library_device_ms": median(rule["library_device_ms"]),
            }
    print(f"wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.cpu_rehearsal:
        emit({"kernels": summary})
        print("cpu rehearsal finished: no device was measured", flush=True)
        return 0
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
