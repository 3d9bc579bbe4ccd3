#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny size, plain versions, CPU
    python3 chip_smoke.py --step1-bucket   # the last four's step 1 on the smallest bucket

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
   dot products per edge also sum in another order). K1 runs at five
   shapes: the pool, the segment mode's sum at the receivers, that sum at
   K6's 50 columns, GAT's packed numerator and denominator ``[E+N, 6 *
   257]`` (an odd width: K1's scalar path) and DimeNet's triplets ``[T,
   64]`` onto their edges (the sorted ``trip_ji``, the padded tail at edge
   0); K6 at its served 50 filters and at 256. Times,
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
   EGNN (and the last four stacks, below) (hidden 256, 3 conv layers, a
   graph head and a node head of 64-wide layers, ``benchmarks/model_bench.py:_arch``; random weights from
   a seed, non-trivial BatchNorm statistics where the stack has any)
   served by ``InferenceServer`` to 128 molecule-sized graphs (80-90
   atoms, 12 edges per atom) from four threads, once per aggregation mode.
   Launch counters are zeroed just before each run and read just after;
   every kernel of that family's and mode's path must have launched as
   often as its forwards need. Every response is held against a CPU copy
   of the model (the plain versions) run on the graphs of its batch,
   packed at the smallest pads that hold them (:func:`tight_pack`; the
   bucket's list widths). One full batch of the largest bucket,
   from all the graphs, is broken down on the device.
5. Train: bench.py's MXU-scale PNA row (as in phase 4, at 2 conv layers,
   ``FIVE_TRAIN_LAYERS``; seeded targets, a
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
   the gradient's error (:func:`hold_step_against_cpu`). An f32 step 1
   that fails, and crossed at most ``KINK_FLIPS_MAX`` ReLU kinks within
   float32's reach of the exact input (:func:`kink_flips`), is held again
   against the exact step with those derivatives on the card's side
   (``relu_kinks`` in its ``train_check`` line). The profiled
   step's device time is split into forward, backward and optimizer
   (:func:`split_trace`). One ``{"train": ...}`` line per run.
   Then the JAX package's headline, ``MXU_HEADLINE``, through the port's
   ``bench_model(**MXU_HEADLINE, iters=20)``: one ``{"train": ...}``
   line with ms per step, graphs/s, the step's
   matmul FLOPs and MFU, the device split and the card's name and power
   limit. PNA is also served once more in phase 4 on a plan whose batches
   carry the dense lists (``plan_from_samples(need_neighbors=True)``);
   building the lists is host work, in ``pack_ms_host``.
   The last four stacks (:data:`NEW_FAMILIES`) at their bench rows (GAT
   and MFC hidden 256, CGCNN ``input_dim`` 256 on graphs with 256
   features, DimeNet hidden 128): served on the segment plan (DimeNet's
   with the triplet tables, ``need_triplets``), GAT, MFC and DimeNet also
   on the dense plan (DimeNet's with the slot tables); trained in segment
   f32, dense f32 and dense bf16 (1 + 8 steps; GAT with its attention
   dropout at 0, so that step 1 can be held against the CPU), step 1 held
   as above (with f32 witnesses in both graph orders) on the training
   batch's first ``NEW_STEP1_GRAPHS`` graphs (``--step1-bucket``: on the
   plan's smallest bucket), peak device memory printed; GAT's dropout held on the card
   apart (:func:`phase_dropout`); their ``MXU_ROWS`` through
   ``bench_model``. Every forward launches K1 once a layer (DimeNet twice)
   besides the pool in segment mode, and only the pool on the lists.
6. run_training: the port's public entry points, ``run_training`` then
   ``run_prediction``, on ``unit_test`` data written by
   :func:`write_unit_test_data` (``tests/synthetic.py``'s generator
   without scikit-learn). First ``tests/inputs/ci.json`` as
   ``tests/test_graphs.py`` drives it: PNA, hidden 8, 500 configurations
   (350/75/75), up to 100 epochs with early stopping, on the ``segment``
   branch (K2 per layer and K1 for the pool, forward and step); its head
   errors and sample MAE held to PNA's ceilings (0.20). Then
   ``ci_multihead.json`` at MXU_HEADLINE's width (hidden 256, 3 layers,
   64-wide heads; 640 configurations of 54-128 atoms, radius 1.2, the
   ``total`` path with the plain split, batch 64, 2 epochs), once on the
   default branch (the dense lists by the static policy: K1 only) and
   once under ``HYDRAGNN_AGG=fused`` (K3 and K1); after each,
   ``ModelRegistry.load_checkpoint`` serves the test split through
   ``InferenceServer`` and every response is held against
   ``run_prediction``'s row (rtol 1e-3, atol 1e-4), and one more epoch
   runs under the profiler for the device's busy share. The launches of
   each run equal its training steps times :func:`launches_per_train_step`
   plus its evaluation and prediction forwards times
   :func:`launches_per_forward`. One ``{"run_training": ...}`` line per run:
   epochs, each epoch's losses and wall, graphs/s, ms per step, the host
   collation's share of the training wall, launches, the checkpoint's
   bytes and save time.
7. Prints one JSON line per kernel case, the card's name and power limit,
   the ``{"kernels": [...]}`` summary (per kernel, its main case's
   ``ms`` and median ``device_ms`` beside the bound, the plain version's
   ``plain_ms`` and the library call's ``library_ms`` and
   ``library_device_ms``; for K2 and K6, which no one PyTorch call
   computes, ``reference_device_ms``: K1's at the same receivers shape,
   which streams the same ``[E, D]`` bytes; ``launches`` counts phases 4,
   5 and 6), and as the last line ``{"ok": true, "device": {"platform":
   "gpu", ...}}``.

``--cpu-rehearsal`` runs phases 3-6 at a tiny size on the CPU through the
plain versions, to check the script's control flow without a card. It
times nothing on a device and never prints the success line.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from hydragnn_tpu_torch.benchmarks.model_bench import (
    MXU_HEADLINE,
    MXU_ROWS,
    _arch,
    bench_model,
    make_graphs,
)
from hydragnn_tpu_torch.data.layout import collate_for_layout, sample_triplets
from hydragnn_tpu_torch.graph import collate_graphs, compute_triplets, pack_triplets, pad_sizes_for
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.models.gat import attention_dropout
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
# the last four stacks: no fused kernel of their own (a gather, then K1)
NEW_FAMILIES = ("GAT", "MFC", "CGCNN", "DimeNet")
# their bench.py widths where not hidden 256: CGCNN's conv width is its
# input_dim (hidden 64), DimeNet runs at hidden 128
NEW_WIDTHS = {
    "full": {"CGCNN": dict(hidden=64, input_dim=256), "DimeNet": dict(hidden=128)},
    "tiny": {"CGCNN": dict(hidden=16, input_dim=8), "DimeNet": dict(hidden=16)},
}
GAT_DROPOUT = 0.25  # the JAX package's HydraBase.dropout
# served responses held against a float64 CPU forward (the float32
# recurrence of DimeNet's spherical Bessel functions; tests/test_torch_dimenet.py)
SERVE_AGAINST_F64 = ("DimeNet",)
# the last four stacks' bursts: their first graphs (two full buckets and
# more), every response held against the CPU, whose forwards of these
# stacks take most of the phase's time
NEW_SERVE_REQUESTS = 64
# the earlier five stacks' bursts, cut from 320 to keep the smoke's wall
SERVE_REQUESTS = 128
# the earlier five stacks train at this depth (their bench rows have 3),
# for the same wall: their float64 CPU steps are most of their phase
FIVE_TRAIN_LAYERS = 2
# the last four stacks' step 1, held against the float64 CPU step, takes
# this many graphs of the training batch (a padded shape of its own; with
# --step1-bucket it takes the plan's smallest bucket instead, and the
# wall passes 300 s: PERF.md)
NEW_STEP1_GRAPHS = 16
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
    ``dense``: the neighbour-list branches run no kernel). GAT, MFC and
    CGCNN sum through K1 once a layer, DimeNet twice (the triplets onto
    the edges, the edges onto the nodes)."""
    family, layers = cfg["model_type"], cfg["num_conv_layers"]
    counts = {name: 0 for name in KERNELS}
    counts["segment_sum"] = 1  # global_mean_pool
    if mode == "dense":
        return counts
    if family in NEW_FAMILIES:
        counts["segment_sum"] += layers * (2 if family == "DimeNet" else 1)
    elif mode == "fused":
        counts[FUSED_KERNEL[family]] = layers
    elif family == "PNA":
        counts["segment_moments"] = layers
    else:
        counts["segment_sum"] += layers
    if family == "SchNet" and cfg["equivariance"]:
        counts["segment_sum"] += layers - 1  # the coordinate update's sum
    return counts


def arch(size, model_type="PNA"):
    """``benchmarks/model_bench.py:_arch`` at the run's size, the last four
    stacks at their bench widths (:data:`NEW_WIDTHS`)."""
    width = NEW_WIDTHS["full" if size is FULL else "tiny"].get(model_type, {})
    hidden = width.get("hidden", size["hidden"])
    shared = max(32, hidden // 4)
    return {
        "model_type": model_type,
        "input_dim": width.get("input_dim", 1),
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
        "num_conv_layers": size["layers"],
        "num_nodes": size["nodes"],
        "edge_dim": None,
        "pna_deg": [0, 0, 16, 32, 64, 32],
        "equivariance": model_type == "EGNN",
        "max_neighbours": 50,
        "num_gaussians": SCHNET_FILTERS,
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


def largest_take(plan, graphs, b=None):
    """The graphs of the main path's largest batch: the last bucket (or
    bucket ``b``) filled greedily with the graphs it admits."""
    b = plan.num_buckets - 1 if b is None else b
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


def phase_kernels(plan, graphs, hidden, device, trip_plan=None):
    """Each kernel against its plain version at the main path's shapes
    (``trip_plan``: DimeNet's, whose largest batch gives K1's T-axis
    case)."""
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

    # K1 at the last four stacks' shapes: GAT's numerator and denominator
    # in one sum, [E+N, heads * (hidden + 1)] at the receivers and the
    # self-loops (an odd width: K1's scalar path), and DimeNet's triplets
    # summed onto their edges, [T, int_emb] by the sorted trip_ji with the
    # padded tail at edge 0
    heads = 6
    loops = torch.arange(n_pad, dtype=rcv.dtype, device=device)
    gat_ids = torch.cat([rcv, loops])
    gat_mask = torch.cat([edge_mask, batch.node_mask])[:, None]
    k1_more = [(e_pad + n_pad, heads * (hidden + 1), gat_ids, n_pad, gat_mask, "GAT")]
    if trip_plan is not None:
        tbatch = largest_batch(trip_plan, graphs).to(device)
        k1_more.append((tbatch.extras["trip_ji"].shape[0], 64, tbatch.extras["trip_ji"],
                        tbatch.num_edges, tbatch.extras["trip_mask"][:, None], "DimeNet"))
    for rows, d, ids, segs, mask, what in k1_more:
        x = rand(rows, d, mask)
        got, ref = seg_sum(x, ids, segs), seg_sum_plain(x, ids, segs)
        cases.append(dict(
            kernel="segment_sum", case=f"{what} [{rows},{d}] -> [{segs},{d}]", main=False,
            stack=what, err=float((got - ref).abs().max()),
            tol=atomic_tolerance(seg_sum_plain(x.abs(), ids, segs)),
            **timings(
                lambda: seg_sum(x, ids, segs), lambda: seg_sum_plain(x, ids, segs),
                lambda: torch.zeros((segs, d), device=device).index_add_(0, ids, x),
                device,
            ),
            bound=bound((rows * d + rows + segs * d) * 4, rows * d),
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


def phase_serve(mode, cfg, plan, graphs, device, card, *, pool, threads=4):
    """Serve the burst ``graphs``, hold every response against the CPU,
    and break down one full batch of the largest bucket taken from
    ``pool``."""
    t_run = time.perf_counter()
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
    # run on the graphs of its batch, packed at the pads they need
    # (tight_pack); a graph's outputs depend neither on its row nor on the
    # padding. DimeNet's float32 recurrence amplifies an ulp of sin/cos on
    # short edges, so its responses are held against a float64 CPU
    # forward, with the float32 CPU forward as the witness of that
    # arithmetic (hold_serve_against_f64)
    ref_model = copy.deepcopy(model).cpu()
    f64 = family in SERVE_AGAINST_F64
    ref64 = copy.deepcopy(ref_model).double() if f64 else None
    by_batch = {}
    for i, f in enumerate(futures):
        by_batch.setdefault(f.batch_seq, []).append(i)
    worst = 0.0
    rows = {ihead: ([], [], []) for ihead in range(len(cfg["output_type"]))}
    with torch.inference_mode():
        for idx in by_batch.values():
            bucket = plan.admit(graphs[idx[0]])[0]
            batch, coords = tight_pack(plan, [graphs[i] for i in idx], bucket)
            outs = [o.numpy() for o in ref_model(batch)]
            if f64:
                with float64_port():
                    exact = [o.numpy() for o in ref64(as_float64(batch))]
            for i, (g, off, n) in zip(idx, coords):
                for ihead, kind in enumerate(cfg["output_type"]):
                    pick = (lambda o: o[g]) if kind == "graph" else (lambda o: o[off : off + n])
                    want, got = pick(outs[ihead]), answers[i][ihead]
                    if got.shape != want.shape or not np.isfinite(got).all():
                        raise AssertionError(f"{family} {mode}: bad response {i} head {ihead}")
                    if f64:
                        for r, v in zip(rows[ihead], (got, want, pick(exact[ihead]))):
                            r.append(np.asarray(v, np.float64).reshape(-1))
                        continue
                    np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                    worst = max(worst, float(np.abs(got - want).max()))
    f64_check = None
    if f64:
        f64_check = hold_serve_against_f64(rows)
        if f64_check["violations"]:
            raise AssertionError(f"{family} {mode}: responses against float64: {f64_check}")
        worst = max(h["card_err"] for h in f64_check["heads"])

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
        "against_float64": f64_check,
        "padding_waste": server.metrics.padding_waste_ratio(),
        "card": card,
        "run_s": time.perf_counter() - t_run,  # the check against the CPU included
    }
    emit({"serve": result})
    if device.type == "cuda":
        breakdown(family, mode, model, plan, pool, device, card)
    return result


def tight_pack(plan, samples, bucket):
    """``plan.pack`` of ``samples`` at the smallest pads that hold them
    (the bucket's list widths kept): a graph's outputs depend neither on
    its row nor on the padding, and the CPU's forward then costs what the
    real rows cost, not the bucket's pads."""
    lay = plan.layouts[bucket]
    trips = sum(sample_triplets(g)[0].shape[0] for g in samples) if lay.packs_triplets else 0
    tight = dataclasses.replace(
        lay,
        n_pad=-(-(sum(g.num_nodes for g in samples) + 1) // 8) * 8,
        e_pad=-(-max(sum(g.num_edges for g in samples), 1) // 8) * 8,
        g_pad=len(samples) + 1,
        t_pad=-(-max(trips, 1) // 8) * 8 if lay.packs_triplets else lay.t_pad,
    )
    batch = collate_for_layout(list(samples), tight)
    coords, off = [], 0
    for g, sample in enumerate(samples):
        coords.append((g, off, int(sample.num_nodes)))
        off += int(sample.num_nodes)
    return batch, coords


def hold_serve_against_f64(rows):
    """Responses held against a float64 CPU forward of the same weights, per
    head (``rows[head] = (card, f32 CPU, f64 CPU)`` lists): with ``s`` the
    head's largest float64 magnitude and ``level`` the float32 CPU
    forward's worst error relative to it, every output within ``atol * s +
    rtol * |exact| + F32_FACTOR * level * s`` (the serve phase's rtol and
    atol; :func:`hold_step_against_cpu`'s form)."""
    heads, bad = [], []
    for ihead, (card, cpu, exact) in rows.items():
        card, cpu, exact = (np.concatenate(r) for r in (card, cpu, exact))
        s = float(np.abs(exact).max())
        level = float(np.abs(cpu - exact).max()) / s
        allowed = SERVE_ATOL * s + SERVE_RTOL * np.abs(exact) + F32_FACTOR * level * s
        err = np.abs(card - exact)
        row = {"head": ihead, "scale": s, "cpu_level": level, "card_err": float(err.max()),
               "cpu_err": float(np.abs(cpu - exact).max()),
               "worst_over_tol": float((err / allowed).max())}
        heads.append(row)
        if not bool((err <= allowed).all()):
            bad.append(row)
    return {"factor": F32_FACTOR, "heads": heads, "violations": bad}


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
    and a node target ``[n, 1]``, functions of the first input feature
    plus noise."""
    rng = np.random.default_rng(seed)
    for g in graphs:
        noise = 0.05 * rng.standard_normal(g.num_nodes + 1)
        x = g.x[:, :1]
        g.targets = [
            np.array([2.0 * x.mean() - 0.5 + noise[0]], np.float32),
            (np.sin(3.0 * x) + noise[1:, None]).astype(np.float32),
        ]


def train_batch(plan, graphs, cfg, dense=False, reverse=False, limit=None, bucket=None):
    """The largest bucket's batch (or bucket ``bucket``'s), with the heads'
    targets (DimeNet's with its triplet tables; with ``dense`` the
    neighbour lists, at the widths its edges need, and DimeNet's their
    slot tables; with ``reverse`` its graphs in the reverse order: the same
    step, summed in another order; with ``limit``, its first ``limit``
    graphs only, padded for them)."""
    take, b = largest_take(plan, graphs, bucket)
    lay = plan.layouts[b]
    pads = (lay.n_pad, lay.e_pad, lay.g_pad)
    if limit is not None:
        take = take[:limit]
        pads = pad_sizes_for(max(g.num_nodes for g in take), max(g.num_edges for g in take),
                             len(take))
    if reverse:
        take = take[::-1]
    batch = collate_graphs(
        take, *pads,
        head_types=tuple(cfg["output_type"]), head_dims=tuple(cfg["output_dim"]),
    )
    if cfg["model_type"] == "DimeNet":
        trips = [compute_triplets(g.edge_index, g.num_nodes) + (g.num_nodes, g.num_edges)
                 for g in take]
        batch = batch.with_extras({k: torch.from_numpy(v)
                                   for k, v in pack_triplets(trips, pads[0]).items()})
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


class _KinkReLU(torch.autograd.Function):
    """ReLU whose backward takes the other one-sided derivative at the
    entries its ``state.flip`` marks: the exact step's other value at a
    kink. The mask is read at backward time, so one forward serves several
    backward passes."""

    @staticmethod
    def forward(ctx, x, state, site):
        ctx.save_for_backward(x)
        ctx.state, ctx.site = state, site
        return torch.clamp(x, min=0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        flip = ctx.state.flip.get(ctx.site)
        d = x > 0
        if flip is not None:
            d = d ^ flip
        return g * d.to(g.dtype), None, None


class KinkReLUs:
    """Stands in for every ReLU ``act`` of a model (the stack's, its MLPs'
    and node heads'), in call order: records each call's input
    (``record``), or applies :class:`_KinkReLU` with the current flips."""

    def __init__(self, record=True):
        self.record = record
        self.inputs, self.flip, self.calls = [], {}, 0

    def __call__(self, x):
        site = self.calls
        self.calls += 1
        if self.record:
            self.inputs.append(x.detach().to("cpu", torch.float64, copy=True))
            return F.relu(x)
        return _KinkReLU.apply(x, self, site)

    def install(self, model):
        for m in model.modules():
            if getattr(m, "act", None) is F.relu:
                m.act = self
        return model

    def remove(self, model):
        for m in model.modules():
            if getattr(m, "act", None) is self:
                m.act = F.relu
        return model


def _rows(t):
    """``t`` as rows of its last axis (a 1-D input: one row)."""
    return t.reshape(1, -1) if t.dim() < 2 else t.reshape(-1, t.shape[-1])


def kink_flips(z32, z64, card):
    """The ReLU entries where the card took the other side of the kink
    than the exact step, within float32's reach of it: the card's input
    and the float64 input differ in sign, and both the float64 input and
    the card's distance from it lie within ``F32_FACTOR`` times the row's
    reach, the largest error of the float32 witness's inputs over that
    row (one node's features at that call: the rounding of the same
    inputs). There the exact step's derivative is either one-sided value
    (SAGE's node head has such an entry, PERF.md). ``z32``, ``z64`` and
    ``card``: the inputs of each call, in call order.

    Returns ``{"masks": {call: bool mask}, "count", "flipped", "beyond",
    "nearest"}``: the masks, how many entries they flip, the first 16
    (``[call, float64 input, its row's reach]``), the count of sign
    differences beyond reach (left to the check), and the nonzero float64
    input nearest a kink relative to its row's reach (``[call, input,
    reach]``)."""
    masks, flipped, count, beyond, nearest = {}, [], 0, 0, None
    for site, (a, b, c) in enumerate(zip(z32, z64, card)):
        b2, c2 = _rows(b), _rows(c)
        reach = (_rows(a) - b2).abs().amax(dim=1, keepdim=True).expand_as(b2)
        live = (b2 != 0) & (reach > 0)
        if bool(live.any()):
            rel = torch.where(live, b2.abs() / reach.clamp(min=1e-300), torch.inf)
            at = int(rel.argmin())
            if nearest is None or float(rel.reshape(-1)[at]) < abs(nearest[1]) / nearest[2]:
                nearest = [site, float(b2.reshape(-1)[at]), float(reach.reshape(-1)[at])]
        differ = (c2 > 0) != (b2 > 0)
        if not bool(differ.any()):
            continue
        near = differ & (b2.abs() < F32_FACTOR * reach) & ((c2 - b2).abs() < F32_FACTOR * reach)
        beyond += int((differ & ~near).sum())
        if bool(near.any()):
            masks[site] = near.reshape(b.shape)
            count += int(near.sum())
            flipped += [[site, float(v), float(r)] for v, r in zip(b2[near][:16], reach[near][:16])]
    return {"masks": masks, "count": count, "flipped": flipped[:16], "beyond": beyond,
            "nearest": nearest}


def exact_with_flips(start, host, flips):
    """The exact (float64) step 1 of ``start`` (a CPU copy of the model
    before the step) with the ReLU derivatives at ``flips`` taken on the
    card's side: ``(model, loss)``, as :func:`cpu_references` returns the
    exact step."""
    with float64_port():
        m = copy.deepcopy(start).double()
        acts = KinkReLUs(record=False)
        acts.install(m)
        acts.flip = flips
        loss = cpu_step(m, as_float64(host))
    return m, loss


def cpu_references(model, host, bf16=False, reversed_host=None, kinks=None):
    """Step 1 of CPU copies of ``model`` (taken before any step) on ``host``:
    the witnesses, through the plain versions in float32 (with ``bf16``, in
    bf16 mixed precision: the card's own arithmetic; then also on
    ``reversed_host`` where given, as it must be for bf16: the same graphs
    in the reverse order, whose sums round in another order), and in
    float64, the exact step's stand-in
    (:func:`float64_port`; a dispatch mode watches every operation of that
    step, backward and optimizer included, and it fails if any gives a
    float32 tensor). Returns ``([(witness model, loss), ...], (f64 model,
    loss))``. With ``kinks`` (a dict) and ``bf16`` False, every ReLU's input
    is recorded in both steps: ``kinks`` gets them (``z32``, ``z64``) and a
    copy of the model before the step (``start``), for
    :func:`kink_flips` and :func:`exact_with_flips`."""
    if bf16 and reversed_host is None:
        raise ValueError("a bf16 step needs its second witness: pass reversed_host")
    witness = copy.deepcopy(model).cpu()
    start = copy.deepcopy(witness)
    f64 = copy.deepcopy(witness).double()
    second = None if reversed_host is None else copy.deepcopy(witness)
    record = kinks is not None and not bf16
    z32, z64 = KinkReLUs(), KinkReLUs()
    if record:
        z64.install(f64)
        z32.install(witness)
    with float64_port(), Float32Watch() as watch:
        loss64 = cpu_step(f64, as_float64(host))
    if watch.seen:
        raise AssertionError(f"float32 in the float64 step: {sorted(watch.seen)}")
    witnesses = [(witness, cpu_step(witness, host, bf16))]
    if second is not None:
        witnesses.append((second, cpu_step(second, reversed_host, bf16)))
    if record:
        kinks.update(z32=z32.inputs, z64=z64.inputs, start=start)
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
# The last four stacks' f32 step 1 is held against f32 witnesses in both
# graph orders too: GAT's attention-logit gradients (b_l, b_r, w_r, the
# residue of a softmax's cancelling sum) lay 34x further from the exact
# step on the card than on the one f32 witness, where summation order
# alone moves them that far (PERF.md), so one witness can land near the
# exact value by chance, as in bf16.
TWO_ORDER_F32 = NEW_FAMILIES
ZERO_GRAD = 1e-6  # a gradient below this share of the largest is zero exactly
# A failing f32 step 1 is held again on the card's side of the ReLU kinks
# it crossed within float32's reach (kink_flips) only if it crossed at most
# this many: SAGE's failing steps crossed 1, the five earlier stacks at most
# 4 (GIN) on the card (PERF.md); more is not rounding.
KINK_FLIPS_MAX = 8


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
            "cpu_errs": [float((w[key] - t).abs().max()) for w in witnesses],
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


def hold_step_at_kinks(card, card_loss, cpu, exact, kinks, card_inputs, host):
    """:func:`hold_step_against_cpu` for an f32 step 1 whose ReLU inputs
    were recorded (``kinks`` from :func:`cpu_references`, ``card_inputs``
    the card's): at a kink the exact step takes either one-sided value, so
    a card step that fails against one, having crossed at most
    ``KINK_FLIPS_MAX`` kinks within float32's reach (:func:`kink_flips`),
    is held against the other (:func:`exact_with_flips`). Returns ``(rows,
    bad, level, relu_kinks)``; ``relu_kinks`` reports the crossings and,
    when the step was held again, its violations before."""
    rows, bad, level = hold_step_against_cpu(card, card_loss, cpu, exact)
    flips = kink_flips(kinks["z32"], kinks["z64"], card_inputs)
    relu_kinks = {"flipped_count": flips["count"], "flipped": flips["flipped"],
                  "sign_differences_beyond_reach": flips["beyond"],
                  "nearest": flips["nearest"], "held_on_the_card_side": False}
    if bad and 0 < flips["count"] <= KINK_FLIPS_MAX:
        relu_kinks.update(held_on_the_card_side=True, violations_before=len(bad))
        exact = exact_with_flips(kinks["start"], host, flips["masks"])
        rows, bad, level = hold_step_against_cpu(card, card_loss, cpu, exact)
    return rows, bad, level, relu_kinks


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


def phase_train(mode, cfg, plan, graphs, device, card, bf16=False, windows=TRAIN_WINDOWS,
                step1_graphs=None, step1_bucket=None):
    """Training of ``cfg``'s stack through the port's entry points:
    ``Trainer`` -> ``init_state`` -> ``put_batch`` -> 1 + ``windows`` x 4
    ``train_step`` (AdamW; with ``bf16``, bf16 mixed precision) -> one
    profiled step -> ``eval_step``, on the largest bucket's batch
    (``dense``: with the neighbour lists). With ``step1_graphs``, step 1,
    the one held against the CPU, takes the first ``step1_graphs`` graphs
    of that batch only (the CPU's float64 step at the full batch is most
    of the phase's time for the last four stacks); with ``step1_bucket``,
    the batch of that bucket of ``plan``. Returns the kernel launches of
    the run."""
    t_run = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = create_model_config(cfg, device=device, aggregation=aggregation_of(mode), seed=0)
    # GAT: no attention dropout, so that step 1 can be held against the CPU
    # (a card generator draws other masks than a CPU one); phase_dropout
    # holds the dropout itself, and the bench rows train with it
    model.set_dropout(0.0)
    host = train_batch(plan, graphs, cfg, dense=mode == "dense")
    cut = dict(limit=step1_graphs, bucket=step1_bucket)
    host1 = host if cut == dict(limit=None, bucket=None) else train_batch(
        plan, graphs, cfg, dense=mode == "dense", **cut)
    precision = "bf16" if bf16 else "f32"
    factor = BF16_FACTOR if bf16 else F32_FACTOR
    # step 1 on CPU copies first, so that none of their host threads runs
    # while the card is timed
    two_orders = bf16 or cfg["model_type"] in TWO_ORDER_F32
    reversed_host = train_batch(plan, graphs, cfg, dense=mode == "dense", reverse=True,
                                **cut) if two_orders else None
    kinks = {}
    cpu, exact = cpu_references(model, host1, bf16, reversed_host, kinks=kinks)
    cpu_s = time.perf_counter() - t_run
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

    def steps(n, on=None):
        nonlocal state
        reset_launch_counts()
        losses = []
        for _ in range(n):
            state, met = trainer.train_step(state, batch if on is None else on)
            losses.append(met["loss"])
        counts = launch_counts()
        if on_card and counts != {k: n * v for k, v in per_step.items()}:
            raise AssertionError(f"{what} train: {n} steps launched {counts}, "
                                 f"expected {per_step} per step")
        for k, v in counts.items():
            launches[k] += v
        return losses

    # step 1 records the card's ReLU inputs (for kink_flips), then the
    # model's own ReLU is back for the timed steps
    card_acts = None if bf16 else KinkReLUs()
    if card_acts is not None:
        card_acts.install(model)
    first = steps(1, on=trainer.put_batch(host1))[0]
    if card_acts is not None:
        card_acts.remove(model)
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
    # the loss falls over the steps on the full batch (step 1 may take fewer graphs)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0 if host1 is host else 1]:
        raise AssertionError(f"{what} train: losses {losses}")
    probe = matmul_probe(device)
    if card_acts is None:
        relu_kinks = None
        rows, bad, level = hold_step_against_cpu(step1, first, cpu, exact, bf16)
    else:
        rows, bad, level, relu_kinks = hold_step_at_kinks(step1, first, cpu, exact, kinks,
                                                          card_acts.inputs, host1)
    closest = sorted(rows, key=lambda r: -r["worst_over_tol"])[:8]
    emit({"train_check": {"family": family, "mode": mode, "precision": precision,
                          "tensors": len(rows),
                          "relu_kinks": relu_kinks,
                          "cpu_level": level, "closest": closest, "violations": bad}})
    if bad:
        raise AssertionError(f"{what} train step 1 against the exact step "
                             f"(matmul probe {probe}): {bad}")
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
        "step1_graphs": int(host1.graph_mask.sum()),
        "step1_batch": f"n_pad {host1.num_nodes} e_pad {host1.num_edges} g_pad {host1.num_graphs}",
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_err_vs_exact": worst["loss"],
        "max_grad_err_vs_exact": worst["grad"],
        "max_param_err_vs_exact": worst["param"],
        "max_stat_err_vs_exact": worst["stat"],
        "worst_err_over_tolerance": worst["over_tol"],
        "cpu_witness": f"{precision} CPU step"
                       + ("s, the graphs in both orders" if two_orders else ""),
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
    if on_card:
        result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result.update(cpu_reference_s=cpu_s, run_s=time.perf_counter() - t_run,
                  matmul_probe=matmul_probe(device))
    emit({"train": result})
    return launches


def matmul_probe(device):
    """A float32 product's worst error relative to its float64 value, with
    the matmul flags in force: ~1e-7 in IEEE float32, ~5e-4 where TF32
    rounds the inputs."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    a, b = (torch.randn(256, 256, generator=gen, dtype=torch.float64) for _ in range(2))
    got = (a.to(device, torch.float32) @ b.to(device, torch.float32)).cpu().double()
    want = a @ b
    return {"rel_err": float((got - want).abs().max() / want.abs().max()),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "precision": torch.get_float32_matmul_precision()}


def phase_dropout(plan, graphs, cfg, device, card):
    """GAT's attention dropout on the card, at its segment shape ``[E+N,
    heads]`` from a generator on the card (``Trainer``'s): the kept share
    within 3 sigma of ``1 - rate``, every kept value ``x / (1 - rate)``
    exactly; and a training step of GAT with it, whose loss is finite."""
    batch = largest_batch(plan, graphs)
    rows = batch.num_edges + batch.num_nodes
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((rows, 6), generator=gen, device=device) + 0.5
    y = attention_dropout(x, GAT_DROPOUT, gen)
    kept = y != 0
    share = float(kept.to(torch.float64).mean())
    sigma = float(np.sqrt(GAT_DROPOUT * (1 - GAT_DROPOUT) / x.numel()))
    exact = bool(torch.equal(y[kept], x[kept] / (1.0 - GAT_DROPOUT)))
    model = create_model_config(cfg, device=device, aggregation="segment", seed=0)
    host = train_batch(plan, graphs, cfg)
    trainer = Trainer(model, train_config())
    state, met = trainer.train_step(trainer.init_state(host), host)
    loss = float(met["loss"])
    emit({"dropout": {"family": "GAT", "rate": GAT_DROPOUT, "elements": x.numel(),
                      "kept_share": share, "sigma": sigma, "scaled_exactly": exact,
                      "train_step_loss": loss, "card": card}})
    if abs(share - (1 - GAT_DROPOUT)) > 3 * sigma or not exact or not np.isfinite(loss):
        raise AssertionError(f"GAT dropout: kept {share} (3 sigma {3 * sigma}), "
                             f"scaled exactly {exact}, loss {loss}")


# ---- main -------------------------------------------------------------------


# ---- phase 6: run_training --------------------------------------------------

CI_CONFIGS = 500  # tests/test_graphs.py's num_samples_tot: 350 / 75 / 75
CI_CEILINGS = (0.20, 0.20)  # PNA's head error and sample MAE (tests/test_graphs.py:24-34)
MULTIHEAD_CONFIGS = 640
MULTIHEAD_CELLS = (3, 5)  # BCC cells of 3-4 on a side: 54-128 atoms
# ci_multihead.json at MXU_HEADLINE's width; radius 1.2 holds a BCC atom's
# 8 + 6 neighbours inside a cell
MULTIHEAD_ARCH = dict(hidden_dim=256, num_conv_layers=3, radius=1.2)
MULTIHEAD_TRAINING = dict(batch_size=64, num_epoch=2)
# the stratified split needs as many test samples as composition classes;
# at 54-128 atoms nearly every composition is its own class (428 classes
# in 640 configurations), so both packages' stratified split refuses it
# and the run takes the plain proportional split of the same total path
MULTIHEAD_STRATIFIED = False
RUN_REHEARSAL = dict(ci_configs=40, multihead_configs=40, hidden=8, num_epoch=2)


def bcc_positions(ux, uy, uz):
    """The atoms of ``ux * uy * uz`` BCC unit cells, in
    ``tests/synthetic.py``'s order."""
    cells = np.stack(np.meshgrid(np.arange(ux), np.arange(uy), np.arange(uz),
                                 indexing="ij"), axis=-1).reshape(-1, 3).astype(np.float64)
    return np.stack([cells, cells + 0.5], axis=1).reshape(-1, 3)


def unit_test_text(node_feature, positions, out_x):
    """One ``unit_test`` file (``tests/synthetic.py``'s format and target
    formulas): the graph line ``sum(out) sum(out_x)``, then per atom
    ``feature index x y z out_x out_x^2+feature out_x^3``."""
    out_x2 = out_x ** 2 + node_feature
    out_x3 = out_x ** 3
    total = float(out_x.sum() + out_x2.sum() + out_x3.sum())
    lines = [f"{total:.6g}\t{float(out_x.sum()):.6g}"]
    for i in range(node_feature.shape[0]):
        row = [node_feature[i, 0], float(i), *positions[i], out_x[i, 0], out_x2[i, 0],
               out_x3[i, 0]]
        lines.append("\t".join(f"{v:.2f}" for v in row))
    return "\n".join(lines)


def write_unit_test_data(path, number_configurations, cells=((1, 3), (1, 3), (1, 2)),
                         number_types=3, number_neighbors=2, seed=97):
    """``tests/synthetic.py``'s ``deterministic_graph_data`` without
    scikit-learn (which the card's host lacks): the same draws from the
    same seed (cell sizes, then each atom's type), ``out_x`` the mean type
    of each atom's ``number_neighbors`` nearest atoms (itself first) by
    scipy's k-d tree. Ties between equidistant neighbours on the lattice
    may fall otherwise than scikit-learn's, so the files need not be
    bit-equal; the format and the targets given ``out_x`` are
    (``tests/test_torch_smoke_checks.py``)."""
    from scipy.spatial import cKDTree

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = [rng.integers(lo, hi, number_configurations) for lo, hi in cells]
    for c in range(number_configurations):
        positions = bcc_positions(*(int(s[c]) for s in sizes))
        n = positions.shape[0]
        feature = rng.integers(0, number_types, (n, 1)).astype(np.float64)
        _, idx = cKDTree(positions).query(positions, k=number_neighbors)
        out_x = feature[idx.reshape(n, -1), 0].mean(axis=1, keepdims=True)
        with open(os.path.join(path, f"output{c}.txt"), "w") as f:
            f.write(unit_test_text(feature, positions, out_x))


@contextlib.contextmanager
def run_directory(path, env=None):
    """Run inside ``path`` (logs and serialized data land there), with
    ``env`` set; the working directory and environment come back after."""
    path.mkdir(parents=True, exist_ok=True)
    saved_cwd, saved_env = os.getcwd(), dict(os.environ)
    os.chdir(path)
    os.environ["SERIALIZED_DATA_PATH"] = str(path)
    os.environ.update(env or {})
    try:
        yield
    finally:
        os.chdir(saved_cwd)
        os.environ.clear()
        os.environ.update(saved_env)


def ci_config(name, data_root, configs, rehearsal):
    """``tests/inputs/<name>`` with its raw directories written under
    ``data_root`` (ci.json: three splits at 70/15/15 of ``configs``;
    ci_multihead.json: one ``total`` of ``configs`` at MXU_HEADLINE's
    width)."""
    with open(_build.REPO_ROOT / "tests" / "inputs" / name) as f:
        config = json.load(f)
    perc = config["NeuralNetwork"]["Training"]["perc_train"]
    multihead = "total" in config["Dataset"]["path"]
    for split in config["Dataset"]["path"]:
        num = (configs if split == "total" else int(configs * perc) if split == "train"
               else int(configs * (1 - perc) * 0.5))
        path = data_root / f"{name.split('.')[0]}_{split}_{num}"
        if not path.exists():
            write_unit_test_data(str(path), num,
                                 cells=(MULTIHEAD_CELLS,) * 3 if multihead else
                                 ((1, 3), (1, 3), (1, 2)))
        config["Dataset"]["path"][split] = str(path)
    if multihead:
        arch = config["NeuralNetwork"]["Architecture"]
        arch.update(MULTIHEAD_ARCH)
        width = max(32, arch["hidden_dim"] // 4)  # model_bench._arch's heads
        arch["output_heads"]["graph"].update(dim_sharedlayers=width, dim_headlayers=[width] * 2)
        arch["output_heads"]["node"].update(dim_headlayers=[width] * 2)
        config["NeuralNetwork"]["Training"].update(MULTIHEAD_TRAINING)
        config["Dataset"]["compositional_stratified_splitting"] = MULTIHEAD_STRATIFIED
        if rehearsal:
            arch["hidden_dim"] = RUN_REHEARSAL["hidden"]
    if rehearsal:
        config["NeuralNetwork"]["Training"]["num_epoch"] = RUN_REHEARSAL["num_epoch"]
    return config


def run_and_predict(config, device, mode):
    """``run_training`` then ``run_prediction`` of ``config``, with the
    launch counts of the two together; the loaders (parsed again, as
    ``run_prediction`` parses them) give the batch counts and the test
    split's order."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.data.loaders import dataset_loading_and_splitting

    train_l, val_l, test_l = dataset_loading_and_splitting(copy.deepcopy(config))
    reset_launch_counts()
    t0 = time.perf_counter()
    state = run_training(copy.deepcopy(config), device=device)
    t1 = time.perf_counter()
    error, tasks, true_values, predicted = run_prediction(copy.deepcopy(config), device=device)
    t2 = time.perf_counter()
    counts = launch_counts()
    arch = dict(config["NeuralNetwork"]["Architecture"], equivariance=False)
    history = state.info["history"]
    steps = len(history) * len(train_l)
    forwards = len(history) * (len(val_l) + len(test_l)) + len(test_l)
    per_step, per_forward = launches_per_train_step(arch, mode), launches_per_forward(arch, mode)
    expected = {k: steps * per_step[k] + forwards * per_forward[k] for k in KERNELS}
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"run_training ({mode}): launched {counts}, expected {expected} "
                             f"({steps} steps, {forwards} forwards)")
    if not all(np.isfinite([h["train_loss"] for h in history])) or not np.isfinite(error):
        raise AssertionError(f"run_training ({mode}): losses {history}, error {error}")
    save = state.info["last_save"]
    line = {
        "epochs_run": len(history),
        "train_loss": [h["train_loss"] for h in history],
        "val_loss": [h["val_loss"] for h in history],
        "epoch_wall_s": [h["epoch_s"] for h in history],
        "train_graphs_per_s": [len(train_l.dataset) / h["train_s"] for h in history],
        "ms_per_step": [1e3 * h["train_s"] / len(train_l) for h in history],
        "collate_share_of_train": (sum(h["train_collate_s"] for h in history)
                                   / sum(h["train_s"] for h in history)),
        "steps": steps, "forwards": forwards,
        "launches": {k: v for k, v in counts.items() if v},
        "launches_per_train_step": {k: v for k, v in per_step.items() if v},
        "launches_per_forward": {k: v for k, v in per_forward.items() if v},
        "checkpoint_bytes": save["bytes"],
        "checkpoint_save_s": save["snapshot_s"] + save["write_s"],
        "error": error, "head_error": [float(t) for t in tasks],
        "sample_mae": [float(np.abs(t - p).mean()) for t, p in zip(true_values, predicted)],
        "run_training_s": t1 - t0, "run_prediction_s": t2 - t1,
        "graphs": [len(train_l.dataset), len(val_l.dataset), len(test_l.dataset)],
    }
    return state, counts, line, (train_l, test_l, predicted)


def serve_checkpoint(log_name, test_l, predicted, dense, device):
    """``ModelRegistry.load_checkpoint(log_name)`` served to the test split
    (in ``run_prediction``'s order) through ``InferenceServer``; every
    response held against ``run_prediction``'s rows at the serve phase's
    rtol and atol. Returns the launches and the largest deviation."""
    samples = [test_l.dataset[i] for _, chunk in test_l.batch_tasks() for i in chunk]
    registry = ModelRegistry()
    entry = registry.load_checkpoint(log_name, device=device)
    plan = plan_from_samples(samples, max_batch_graphs=64, need_neighbors=dense)
    reset_launch_counts()
    with InferenceServer(registry, plan, device=device, queue_capacity=len(samples) + 1) as server:
        futures = [server.submit(g, model=entry.name) for g in samples]
        served = [f.result(120) for f in futures]
    counts = launch_counts()
    worst = 0.0
    for ihead, want in enumerate(predicted):
        got = np.concatenate([np.asarray(r[ihead], np.float32).reshape(-1, 1) for r in served])
        if got.shape != want.shape:
            raise AssertionError(f"served head {ihead}: {got.shape} rows for {want.shape}")
        excess = np.abs(got - want) - (SERVE_ATOL + SERVE_RTOL * np.abs(want))
        worst = max(worst, float(np.max(np.abs(got - want))))
        if np.any(excess > 0):
            raise AssertionError(f"served head {ihead} differs from run_prediction by up to "
                                 f"{float(np.max(np.abs(got - want)))}")
    return counts, {"served": len(samples), "max_abs_dev_from_run_prediction": worst}


def profiled_epoch(state, config, train_l, device, name):
    """One more epoch of ``state`` under the profiler: its wall and the
    device's busy share (device time of its kernels, copies and fills
    over the wall)."""
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(state.model, config["NeuralNetwork"]["Training"])
    train_l.set_epoch(MULTIHEAD_TRAINING["num_epoch"])
    trace = _build.REPO_ROOT / "build" / "chip_smoke" / f"run_training_{name}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(state, train_l)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    by_phase, _, _, ops = split_trace(trace)
    device_s = sum(by_phase.values()) / 1e3
    return {"profiled_epoch_s": wall, "profiled_device_s": device_s or "not measured",
            "device_busy_share": device_s / wall if device_s else "not measured",
            "profiled_device_ops": ops}


def phase_run_training(device, card, rehearsal):
    """``run_training`` and ``run_prediction`` through the port's entry
    points (module docstring, phase 6); one ``{"run_training": ...}``
    line per run. Returns the launches."""
    root = _build.REPO_ROOT / "build" / "chip_smoke" / "run_training"
    if root.exists():
        import shutil

        shutil.rmtree(root)
    data = root / "data"
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    configs = RUN_REHEARSAL["ci_configs"] if rehearsal else CI_CONFIGS
    config = ci_config("ci.json", data, configs, rehearsal)
    with run_directory(root / "ci"):
        _, counts, line, _ = run_and_predict(config, device, "segment")
    add(counts)
    mae_ok = all(m < CI_CEILINGS[1] for m in line["sample_mae"])
    err_ok = all(e < CI_CEILINGS[0] for e in line["head_error"] + [line["error"]])
    if not rehearsal and not (mae_ok and err_ok):
        raise AssertionError(f"ci.json PNA misses its ceilings {CI_CEILINGS}: {line}")
    emit({"run_training": {"config": "ci.json", "model": "PNA", "branch": "segment",
                           "ceilings": CI_CEILINGS, "ceilings_met": mae_ok and err_ok,
                           **line, "card": card}})

    configs = RUN_REHEARSAL["multihead_configs"] if rehearsal else MULTIHEAD_CONFIGS
    config = ci_config("ci_multihead.json", data, configs, rehearsal)
    for name, env, mode in (("default", {}, "dense"),
                            ("fused", {"HYDRAGNN_AGG": "fused"}, "fused")):
        with run_directory(root / f"multihead_{name}", env):
            if rehearsal:  # hidden 8 is below the dense policy's width
                mode = "segment" if name == "default" else mode
            state, counts, line, (train_l, test_l, predicted) = run_and_predict(
                config, device, mode)
            add(counts)
            serve_counts, served = serve_checkpoint(state.info["log_name"], test_l, predicted,
                                                    mode == "dense", device)
            path = {k for k, v in launches_per_forward(config["NeuralNetwork"]["Architecture"],
                                                       mode).items() if v}
            if device.type == "cuda" and {k for k, v in serve_counts.items() if v} != path:
                raise AssertionError(f"serving ({name}) launched {serve_counts}, not {path}")
            add(serve_counts)
            if device.type == "cuda":
                served.update(profiled_epoch(state, config, train_l, device, name))
        emit({"run_training": {"config": "ci_multihead.json", "model": "PNA",
                               "width": config["NeuralNetwork"]["Architecture"]["hidden_dim"],
                               "branch": mode, "env": env, **line, **served,
                               "serve_launches": {k: v for k, v in serve_counts.items() if v},
                               "card": card}})
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny size on the CPU through the plain versions; no success line")
    ap.add_argument("--step1-bucket", action="store_true",
                    help="hold the last four stacks' step 1 on the plan's smallest bucket, not "
                         f"on the training batch's first {NEW_STEP1_GRAPHS} graphs (past the "
                         "300 s wall)")
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
    # DimeNet's plans: the triplet tables (t_pad per bucket), and the lists
    # with their slot tables
    trip_plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3,
                                  need_triplets=True)
    trip_dense_plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3,
                                        need_neighbors=True, need_triplets=True)
    for lay in trip_plan.layouts:
        print(f"triplet bucket: n_pad {lay.n_pad} e_pad {lay.e_pad} g_pad {lay.g_pad} "
              f"t_pad {lay.t_pad}", flush=True)
    # CGCNN's graphs carry input_dim features (its width)
    cg_graphs = make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0,
                            input_dim=arch(size, "CGCNN")["input_dim"])
    cg_plan = plan_from_samples(cg_graphs, max_batch_graphs=size["batch"], num_buckets=3)
    # the plans each new stack is served on, and the one it trains on
    new_plans = {
        "GAT": (graphs, {"segment": plan, "dense": dense_plan}),
        "MFC": (graphs, {"segment": plan, "dense": dense_plan}),
        "CGCNN": (cg_graphs, {"segment": cg_plan}),
        "DimeNet": (graphs, {"segment": trip_plan, "dense": trip_dense_plan}),
    }

    t_phase = time.perf_counter()

    def lap(what):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {what}: {now - t_phase:.1f} s", flush=True)
        t_phase = now

    cases = phase_kernels(plan, graphs, size["hidden"], device, trip_plan=trip_plan)
    launches = {name: 0 for name in KERNELS}
    lap("kernels")

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    for family in FAMILIES:
        cfg = arch(size, family)
        for mode in ("fused", "segment"):
            add(phase_serve(mode, cfg, plan, graphs[:SERVE_REQUESTS], device, card,
                            pool=graphs)["launches"])
    # the dense plan: PNA, and GIN and SAGE, which the JAX package's static
    # policy serves on the lists at this width
    for family in ("PNA", "GIN", "SAGE"):
        add(phase_serve("dense", arch(size, family), dense_plan, graphs[:SERVE_REQUESTS], device,
                        card, pool=graphs)["launches"])
    lap("serve (five stacks)")
    # the last four on the segment plan, and GAT, MFC and DimeNet also on
    # the dense one (the JAX package's static policy at these widths)
    for family in NEW_FAMILIES:
        fam_graphs, plans = new_plans[family]
        for mode, fam_plan in plans.items():
            add(phase_serve(mode, arch(size, family), fam_plan, fam_graphs[:NEW_SERVE_REQUESTS],
                            device, card, pool=fam_graphs)["launches"])
    lap("serve (GAT, MFC, CGCNN, DimeNet)")

    set_targets(graphs, seed=1)
    set_targets(cg_graphs, seed=1)
    for family in FAMILIES:
        # SchNet with its equivariant update here (the bench rows have none);
        # at FIVE_TRAIN_LAYERS (the wall's depth cut)
        cfg = dict(arch(size, family), equivariance=family in ("SchNet", "EGNN"),
                   num_conv_layers=min(size["layers"], FIVE_TRAIN_LAYERS))
        windows = TRAIN_WINDOWS if family == "PNA" else STACK_TRAIN_WINDOWS
        for mode, bf16 in (("fused", False), ("segment", False), ("dense", False),
                           ("dense", True)):
            add(phase_train(mode, cfg, plan, graphs, device, card, bf16=bf16, windows=windows))
    lap("train (five stacks)")
    step1 = (dict(step1_bucket=0) if args.step1_bucket else
             dict(step1_graphs=NEW_STEP1_GRAPHS if size is FULL else 2))
    for family in NEW_FAMILIES:
        fam_graphs, plans = new_plans[family]
        cfg = arch(size, family)
        for mode, bf16 in (("segment", False), ("dense", False), ("dense", True)):
            add(phase_train(mode, cfg, plans["segment"], fam_graphs, device, card, bf16=bf16,
                            windows=STACK_TRAIN_WINDOWS,
                            **step1))
    phase_dropout(plan, graphs, arch(size, "GAT"), device, card)
    lap("train (GAT, MFC, CGCNN, DimeNet)")
    add(phase_bench("MXU_HEADLINE", MXU_HEADLINE, size, device, card))
    for row in MXU_ROWS:
        name = f"MXU_{row['model_type']}_{'dense_bf16' if row.get('dense') else 'segment_f32'}"
        add(phase_bench(name, row, size, device, card))
    lap("bench_model")
    add(phase_run_training(device, card, rehearsal=args.cpu_rehearsal))
    lap("run_training")

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
        stacks = [c for c in mine if c.get("stack")]
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
        if stacks:  # K1 at the last four stacks' shapes
            summary[-1]["stack_cases"] = [{
                "case": c["case"], "max_abs_err": c["err"], "ms": c["ms"],
                "device_ms": median(c["device_ms"]), "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"],
                "library_device_ms": median(c["library_device_ms"]),
            } for c in stacks]
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
