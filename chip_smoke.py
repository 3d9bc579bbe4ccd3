#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny size, plain versions, CPU
    python3 chip_smoke.py --step1-bucket   # the last four's step 1 on the smallest bucket

Phases, in order; any failure raises and exits non-zero. Phases 4-6 run
through the port's captured programs (``train/capture.py``): every served
forward, training step and evaluation is a CUDA graph per shape key,
captured once (its warm-up runs the body eagerly once, which counts as a
launch of each kernel it calls) and replayed; a replay adds the launches
its capture recorded, so every launch count below holds replays and
warm-ups alike (``train.capture_counts``).

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
   served by ``InferenceServer`` to 64 molecule-sized graphs (80-90
   atoms, 12 edges per atom) from four threads, once per aggregation mode.
   The server captures each bucket's forward at warmup: its
   ``compiles_total`` must equal the buckets after warmup and after the
   burst; in each stack's first branch a second version is registered
   after the burst and warmed through the running batcher
   (``warm_version``), which must verify (3 compiles, then 0).
   Launch counters are zeroed just before each run and read just after;
   every kernel of that family's and mode's path must have launched as
   often as its forwards need. Every response is held against a CPU copy
   of the model (the plain versions) run on the graphs of its batch,
   packed at the smallest pads that hold them (:func:`tight_pack`; the
   bucket's list widths). One full batch of the largest bucket,
   from all the graphs, is broken down on the device.
   Then the rest of the single-replica server
   (:func:`phase_serve_tenancy`): two tenants on one server with the
   response cache, the cost ledger, the ensemble scorer (PNA at this
   width, ``fused``, 4 versions, K = 4), a tracer and ``/metrics``
   scraped mid-burst, GIN flooding past its quota alongside the burst,
   each tenant's device time from timed replays; and GAT's ``dropout``
   scores against a plain reference (:func:`gat_dropout_scores`).
   Then the serving fleet (:func:`phase_fleet`): two replica processes of
   ``python -m hydragnn_tpu_torch.serve.fleet`` on the one card (PNA at this
   width, ``fused``; v2 checkpoints the phase writes from ``TrainState``s
   of seeded weights), a ``FleetRouter`` in this process under
   closed-loop clients sending the 64 graphs: the router's cost over a
   direct ``predict``, requests a second through 2 replicas and through 1
   at each client count of :data:`FLEET_SWEEP`, then under
   :data:`FLEET_CLIENTS` clients a SIGKILL of replica 1 healed at incarnation 1,
   a hot-swap to ``v2`` (each replica compiling one program a bucket, then
   none; no micro-batch mixing versions), a corrupt candidate rolled back
   with ``v2`` serving, a ``CanaryController`` rejecting a far candidate
   on its MAE gate and promoting a close one (each on its own canary
   process, which the router never sees), one ``FleetAutoscaler`` tick
   adding a replica, and a drift alert raised and cleared on the new
   replica's shifted inputs (``HYDRAGNN_FAULT_SHIFT_INPUTS``). No request
   may be lost; every answer is held against this process's forward of
   its version on the card (the lease names the checkpoint behind each
   replica's version) within K1's and K3's atomic tolerance; every
   replica and canary process must have launched K3 and K1 one forward's
   worth for each of its micro-batches and captures (its final lease);
   every event stream passes ``validate_events``. Last, the CLI (``python -m
   hydragnn_tpu_torch.serve.fleet --spec --dir --replicas 2``) serves both
   replicas' answers and exits 0 on SIGTERM. One ``{"fleet": ...}`` line.
5. Train: bench.py's MXU-scale PNA row (as in phase 4, at 2 conv layers,
   ``FIVE_TRAIN_LAYERS``; seeded targets, a
   graph target ``[1]`` and a node target ``[n, 1]`` per its
   ``output_dim``) trained through ``Trainer`` (``init_state`` ->
   ``put_batch`` -> ``train_step`` with AdamW at lr 1e-3 -> ``eval_step``)
   on the largest bucket's batch (n_pad 5768, e_pad 69120, g_pad 65): in
   f32 in ``fused`` and ``segment`` mode, and with the batch's dense
   neighbour lists (PNA's dense branch) in f32 and in bf16 mixed
   precision. Each run: step 1 (captured at step 1's shape, then the
   graphs freed), the step's capture at the batch's shape, 20 timed
   replays (CUDA events, the median of 5 windows of 4 steps), one profiled
   replay. Every step
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
   line with ms per step of the captured step, the eager body's
   (``eager_ms_per_step``), graphs/s, the step's
   matmul FLOPs and MFU, the replay's device time and busy share and the
   card's name and power limit. PNA is also served once more in phase 4 on a plan whose batches
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
   without scikit-learn), in the four modes of :data:`RUNS`. First
   ``tests/inputs/ci.json`` as ``tests/test_graphs.py`` drives it: PNA,
   hidden 8, 500 configurations (350/75/75), up to 100 epochs with early
   stopping, on the ``segment`` branch (K2 per layer and K1 for the pool,
   forward and step), streaming and then with ``device_resident_dataset``
   (staged epochs and evaluations, the staged predict); its head errors
   and sample MAE held to PNA's ceilings (0.20) both times. Then
   ``ci_multihead.json`` at MXU_HEADLINE's width (hidden 256, 3 layers,
   64-wide heads; 640 configurations of 54-128 atoms, radius 1.2, the
   ``total`` path with the plain split, batch 64, 2 epochs), once on the
   default branch (the dense lists by the static policy: K1 only) with
   ``steps_per_dispatch`` 4 and ``device_prefetch`` 2, and once under
   ``HYDRAGNN_AGG=fused`` (K3 and K1) with ``device_resident_dataset``;
   after each run, ``ModelRegistry.load_checkpoint`` serves the test
   split through ``InferenceServer`` and every response is held against
   ``run_prediction``'s row (rtol 1e-3, atol 1e-4), and two more epochs
   run in the run's mode, the second under the profiler, for the
   device's busy share. The launches of each run equal its training
   steps (and its captures' warm-up steps) times
   :func:`launches_per_train_step` plus its evaluation and prediction
   forwards (and warm-up forwards) times :func:`launches_per_forward`.
   One ``{"run_training": ...}`` line per run:
   epochs, each epoch's losses and wall, graphs/s, ms per step, the host
   collation's share of the training wall, launches, the checkpoint's
   bytes and save time. Then the whole runs (:func:`phase_whole_runs`):
   ``ci.json`` PNA as ``tests/test_graphs.py:240-257`` drives it (300
   configurations, ``device_resident_dataset`` and ``fit_chunk_epochs``
   10: ``Trainer.fit_staged`` chunks, one readback each), held to its
   ceilings, its launches to the count of every epoch the chunks
   dispatched (padded and stopped ones replay too), the tail's plateau
   rates, stop and best epoch to the host trackers run again over its
   validation series (:func:`host_decisions`), then one more chunk
   profiled (ms an epoch, busy share) and :data:`FIT_SYNC_CHUNKS` queued
   under ``torch.cuda.set_sync_debug_mode("error")``
   (:func:`profiled_chunk`); the other eight stacks (:data:`OTHER_STACKS`)
   the same way at 500 configurations, on the branch the data path picks
   for them (the static dense policy), each held to its
   ``tests/test_graphs.py`` ceilings (:data:`THRESHOLDS`); a guarded
   streaming PNA run (``divergence_guard``) with
   ``HYDRAGNN_FAULT_NAN_AT_STEP`` poisoning two steps: 2 skipped, no
   restore, ceilings met, and the guard's cost a step
   (:func:`guard_cost`); and one poisoned step under
   ``HYDRAGNN_NAN_SENTINEL=1``, which must raise ``NonFiniteError``
   naming a parameter (:func:`sentinel_check`). Then the rest of
   ``run_training``'s surface (:func:`phase_formats`): 200 periodic FCC
   NiNb supercells of 108 atoms (:func:`write_cfg_data`) through
   ``run_training`` + ``run_prediction`` with
   ``periodic_boundary_conditions`` at MXU_HEADLINE's width (PNA hidden
   256, 3 layers, ``fused``): every atom 12 in-neighbours across the
   cell, the launches exact, the loss falling, the host seconds of
   ``radius_graph_pbc``, step 1 held against the float64 CPU step; an XYZ
   run the same way; an extxyz slab (``pbc="T T F"``: no edge through the
   vacuum) through ``Trainer``; every optimizer type's 10 captured steps
   against the CPU's eager trajectory, each update against the CPU's rule
   on the card's gradients and state, ``freeze_conv``'s encoder
   bit-equal; conv checkpointing's peak memory and ms a step beside the
   plain step's, its step 1 within the atomic tolerance of it; the bytes a
   compact batch ships. One ``{"formats": ...}`` line each. Then the
   training telemetry (:func:`phase_telemetry`): ``ci_multihead.json`` at
   MXU_HEADLINE's width under ``HYDRAGNN_AGG=fused`` and
   ``HYDRAGNN_OBS_PORT=0``, four ``run_training`` runs: a guarded streaming
   run with one poisoned step, its ``/metrics`` and ``/healthz`` scraped
   and ``/profile?steps=2`` asked after epoch 0 (the trace must name K3's
   and K1's kernels, :data:`TRACE_KERNELS`; the stream every kind of
   :data:`TELEMETRY_REQUIRE`; the report rendered by the CLI, its budget
   checked: exit 0, 1 with the FLOPs halved, 2 on a missing stream); the
   staged run with telemetry off, then on (ms a step within
   :data:`TELEMETRY_OVERHEAD` or the off run's spread); chunked, every
   chunk after the first queued under ``set_sync_debug_mode("error")``.
   Every run's launches exact, every goodput window's fractions summing to
   1, each train bucket's MFU within :data:`TELEMETRY_MFU_TOL` of the
   smoke's own figure (FlopCounterMode's FLOPs of one eager step over the
   ms a step of CUDA events around whole passes of replays, taken outside
   the program layer, :func:`_own_mfu`); then the CLI's
   ``fleet``, ``drift`` and ``trace`` on the serving phases' streams. One
   ``{"telemetry": ...}`` line a run. Then the streaming data plane
   (:func:`phase_stream`): ``examples/multidataset/gfm.json`` at its full
   width through ``run_training`` over three generated shard stores, in
   ``fused`` mode uninterrupted, killed mid-epoch 2 (a process of its
   own) and resumed (the restored state bit for bit, cursor and batch
   digests exact), resumes of the uninterrupted run's epoch-1 checkpoint
   (parameters, past the loss's null space, within
   :data:`STREAM_PARAM_FACTOR` times their own spread of its epoch 2, a
   planted resume with zeroed AdamW moments outside that), and in
   ``segment`` mode; launches exact, residency within one window per
   source; the collation pool, ``DistDataset``, ``FeedbackSink`` and the
   tracer's ``native`` backend. One ``{"stream": ...}`` line a run.
7. Capture: one ``{"capture": ...}`` line of phase 4's compile counters
   and ``warm_version`` results, one of phase 5's ``bench_model`` rows
   (captured and eager ms a step, the replay's busy share and device ops,
   launches per replay); then PNA at the training batch in ``fused``,
   ``segment`` and dense bf16: three replays (from a host batch, a
   device batch, a host batch) and evaluations under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside), and
   a learning rate lowered tenfold after capture, the replayed update
   held against two eager steps at the new rate (:func:`hold_update`).
8. Prints one JSON line per kernel case, the card's name and power limit,
   the ``{"kernels": [...]}`` summary (per kernel, its main case's
   ``ms`` and median ``device_ms`` beside the bound, the plain version's
   ``plain_ms`` and the library call's ``library_ms`` and
   ``library_device_ms``; for K2 and K6, which no one PyTorch call
   computes, ``reference_device_ms``: K1's at the same receivers shape,
   which streams the same ``[E, D]`` bytes; ``launches`` counts phases 4,
   5 and 6 in this process (the streaming phase's in-process runs too) and, for the fleet, its replica and canary
   processes, each from its final lease), and as the last line ``{"ok": true, "device": {"platform":
   "gpu", ...}}``.

``--cpu-rehearsal`` runs phases 3-6 at a tiny size on the CPU through the
plain versions (the fleet's replicas with ``"device": "cpu"``), to check
the script's control flow without a card. It times nothing on a device and
never prints the success line. ``--only-fleet`` runs phases 1, 2 and the
fleet alone, ``--only-formats`` phases 1, 2 and :func:`phase_formats`,
``--only-telemetry`` phases 1, 2 and :func:`phase_telemetry`,
``--only-stream`` phases 1, 2 and :func:`phase_stream`, and none of them
prints the success line.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import pickle
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

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
from hydragnn_tpu_torch.data import GraphData
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
from hydragnn_tpu_torch import coord
from hydragnn_tpu_torch.obs import RunEventLog, Tracer, build_traces, load_span_events
from hydragnn_tpu_torch.obs.drift import load_quality_events
from hydragnn_tpu_torch.obs.events import validate_events
from hydragnn_tpu_torch.serve import (
    AutoscalePolicy,
    CanaryController,
    CanaryGates,
    CandidateChannel,
    CostLedger,
    FleetAutoscaler,
    FleetRouter,
    InferenceServer,
    ModelRegistry,
    ResponseCache,
    ServerOverloaded,
    ServingFleet,
    TenantManager,
    TenantOverQuota,
    UncertaintyScorer,
    plan_from_samples,
)
from hydragnn_tpu_torch.serve import fleet as fleet_mod
from hydragnn_tpu_torch.train import (
    Trainer,
    capture_counts,
    get_learning_rate,
    reset_capture_counts,
    select_optimizer,
    set_learning_rate,
    steps as train_steps,
)
from hydragnn_tpu_torch.train.capture import ProgramSet, invalidated_captures
from hydragnn_tpu_torch.train.checkpoint import save_model
from hydragnn_tpu_torch.train.common import TrainState
from hydragnn_tpu_torch.utils import faults
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
# more at 64; cut to 32 for the whole runs' share of the wall), every
# response held against the CPU, whose forwards of these stacks take most
# of the phase's time
NEW_SERVE_REQUESTS = 32
# the earlier five stacks' bursts, cut from 320 to 128 and then to 64 to
# keep the smoke's wall
SERVE_REQUESTS = 64
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


def phase_serve(mode, cfg, plan, graphs, device, card, *, pool, threads=4, warm=False):
    """Serve the burst ``graphs``, hold every response against the CPU,
    and break down one full batch of the largest bucket taken from
    ``pool``. The server captures one forward per bucket at warmup:
    ``compiles_total`` must equal the buckets after warmup and after the
    burst. With ``warm``, a second version of the model (the same weights)
    is registered after the burst and warmed through the running batcher
    (``warm_version``), which must verify."""
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
    compiles = {"after_warmup": server.metrics.snapshot()["compiles_total"]}
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
    counts = launch_counts()
    snap = server.metrics.snapshot()
    compiles["after_burst"] = snap["compiles_total"]
    warmed = None
    if warm:
        registry.register(family.lower(), copy.deepcopy(model))
        warmed = server.warm_version(family.lower())
    server.stop()
    if compiles != {"after_warmup": plan.num_buckets, "after_burst": plan.num_buckets} or (
            warmed is not None and not warmed["verified"]):
        raise AssertionError(f"{family} {mode}: compiles_total {compiles}, warm_version {warmed}")

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
        "compiles_total": compiles,
        "warm_version": warmed,
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


# ---- phase 4, continued: the rest of the single-replica server -------------

TENANCY_K = 4  # PNA versions registered: the ensemble's members, the scorer's K
TENANCY_FLOOD = 400  # the flooding tenant's graphs at most, sent while the screening runs
TENANCY_FLOOD_GAP_S = 0.0005  # between two flood submits: faster than a flush
TENANCY_FLOOD_QUOTA = 8
TENANCY_FLOOD_NODES = 6  # small molecules, each unique (no cache hit)
TENANCY_ENSEMBLE_GRAPHS = 16  # the ensemble held against the CPU on these
GAT_SCORE_GRAPHS = 32


def parse_prometheus(text):
    """``{series: value}`` of a Prometheus text; raises on a line that is
    neither a comment nor ``name{labels} value``."""
    pattern = re.compile(r'^[a-z_]+(\{[a-z_]+="[^"]*"(,[a-z_]+="[^"]*")*\})? '
                         r"(-?[0-9.e+-]+|nan|inf)$")
    series = {}
    for line in text.splitlines():
        if not line or line.startswith(("# HELP ", "# TYPE ")):
            continue
        if not pattern.match(line):
            raise AssertionError(f"/metrics: unparseable line {line!r}")
        name, value = line.rsplit(" ", 1)
        series[name] = float(value)
    return series


def hold_variance(got, samples):
    """``got`` (one request's variance) against the population variance of
    the reference ``samples`` (its K member outputs). Each sample carries
    at most ``eps = atol * s + rtol * max_k |o_k|`` of error (the serve
    phase's rtol and atol, ``s`` the head's largest output), which moves a
    variance by at most ``4 eps sqrt(var) + 4 eps^2``. Returns the worst
    share of that bound used."""
    stack = np.stack(samples).astype(np.float64)
    want = stack.var(axis=0)
    s = float(np.abs(stack).max()) or 1.0
    eps = SERVE_ATOL * s + SERVE_RTOL * np.abs(stack).max(axis=0)
    allowed = 4 * eps * np.sqrt(want) + 4 * eps * eps
    return float((np.abs(np.asarray(got, np.float64) - want) / allowed).max())


def burst(server, graphs, threads, tenant=None, tracer=None, halfway=None):
    """Submit ``graphs`` from ``threads`` threads; returns the futures, the
    submit times and the traces. ``halfway`` is set once half were
    submitted."""
    futures, submitted = [None] * len(graphs), [0.0] * len(graphs)
    traces = [None if tracer is None else tracer.start(tenant=tenant) for _ in graphs]
    count, lock = [0], threading.Lock()

    def submit(indices):
        for i in indices:
            submitted[i] = time.monotonic()
            futures[i] = server.submit(graphs[i], tenant=tenant, trace=traces[i])
            with lock:
                count[0] += 1
                if halfway is not None and count[0] * 2 >= len(graphs):
                    halfway.set()

    workers = [threading.Thread(target=submit, args=(range(k, len(graphs), threads),))
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(600)
        if w.is_alive():
            raise RuntimeError("a submitting thread did not finish")
    return futures, submitted, traces


def latency_ms(futures, submitted):
    lat = np.asarray([f.done_at - s for f, s in zip(futures, submitted)]) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def hold_responses(futures, graphs, plan, models):
    """Every response against a CPU copy of its model version (``models``:
    ``{name: module}``), run on the graphs of its batch at the pads they
    need (:func:`tight_pack`); returns the largest error."""
    cpu = {name: copy.deepcopy(m).cpu() for name, m in models.items()}
    by_batch = {}
    for i, f in enumerate(futures):
        by_batch.setdefault((f.model_name, f.batch_seq), []).append(i)
    worst = 0.0
    with torch.inference_mode():
        for (name, _), idx in by_batch.items():
            model = cpu[name]
            batch, coords = tight_pack(plan, [graphs[i] for i in idx], plan.admit(graphs[idx[0]])[0])
            outs = [o.numpy() for o in model(batch)]
            for i, (g, off, n) in zip(idx, coords):
                answer = futures[i].result(0)
                for ihead, kind in enumerate(model.output_type):
                    want = outs[ihead][g] if kind == "graph" else outs[ihead][off : off + n]
                    got = answer[ihead]
                    if got.shape != want.shape or not np.isfinite(got).all():
                        raise AssertionError(f"tenancy: bad response {name} {i} head {ihead}")
                    np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                    worst = max(worst, float(np.abs(got - want).max()))
    return worst


def ensemble_check(server, scorer, entry, plan, graphs, device):
    """The scorer's captured variances on one packed batch against the same
    members run eagerly on the card, and against the CPU ensemble on the
    same graphs (:func:`hold_variance`; the worst share of the bound)."""
    take, bucket = largest_take(plan, graphs, b=plan.admit(graphs[0])[0])
    take = take[:TENANCY_ENSEMBLE_GRAPHS]
    batch, coords = plan.pack(take, bucket)
    captured = [v.cpu().numpy() for v in scorer.dispatch(entry, batch)]
    members = [server.registry.get(entry.name, v).model for v in scorer._member_versions(entry)]
    with torch.inference_mode():
        eager = [[o.float().cpu().numpy() for o in m(batch.to(device))] for m in members]
        tight, tcoords = tight_pack(plan, take, bucket)
        cpu = [[o.numpy() for o in copy.deepcopy(m).cpu()(tight)] for m in members]
    worst = {"vs_eager_card": 0.0, "vs_cpu": 0.0}
    max_var = 0.0
    for ihead, kind in enumerate(entry.output_type):
        for (g, off, n), (tg, toff, tn) in zip(coords, tcoords):
            pick = (lambda a: a[g]) if kind == "graph" else (lambda a: a[off : off + n])
            tpick = (lambda a: a[tg]) if kind == "graph" else (lambda a: a[toff : toff + tn])
            got = pick(captured[ihead])
            max_var = max(max_var, float(got.max()))
            worst["vs_eager_card"] = max(worst["vs_eager_card"], hold_variance(
                got, [pick(e[ihead]) for e in eager]))
            worst["vs_cpu"] = max(worst["vs_cpu"], hold_variance(
                got, [tpick(c[ihead]) for c in cpu]))
    if max(worst.values()) > 1.0 or not max_var > 0:
        raise AssertionError(f"tenancy: ensemble variances {worst}, max var {max_var}")
    return dict(worst, max_var=max_var, graphs=len(take), bucket=bucket)


def scorer_timing(server, scorer, entry, plan, graphs, device):
    """ms per dispatch and device ms of the scorer's replay and of the
    forward's, on the largest batch."""
    take, b = largest_take(plan, graphs)
    batch = plan.pack(take, b)[0]
    fwd = lambda: server._compiled(entry, batch, b)  # noqa: E731
    score = lambda: scorer.dispatch(entry, batch)  # noqa: E731
    ms = call_ms([fwd, score], device)
    dev = [device_ms(fwd, device), device_ms(score, device)]
    ratio = None if dev[0] is None else median(dev[1]) / median(dev[0])
    return {"bucket": b, "graphs": len(take), "forward_ms": ms[0], "scorer_ms": ms[1],
            "forward_device_ms": dev[0], "scorer_device_ms": dev[1], "device_ratio": ratio}


def time_dispatches(server, device):
    """CUDA events around each forward and scoring replay the server's
    batcher makes (``_compiled`` and ``_scored`` with ``run``): returns the
    list of ``(model, bucket, start, end)`` it fills (the bucket on a
    forward, None on a scoring call), the ``{(model, bucket): (entry,
    batch)}`` of the batches it saw, and the function that takes the
    wrappers off. A span holds the replay, its batch's copies to the card
    and the host's stalls between them. Nothing is timed on the CPU."""
    marks, seen = [], {}
    if device.type != "cuda":
        return marks, seen, lambda: None
    compiled, scored = server._compiled, server._scored

    def timed(fn, run_at):  # run_at: where ``run`` sits after the batch
        def run(entry, batch, *args, **kwargs):
            if not (args[run_at] if len(args) > run_at else kwargs.get("run", True)):
                return fn(entry, batch, *args, **kwargs)
            bucket = args[0] if fn is compiled else None
            if bucket is not None:
                seen.setdefault((entry.name, bucket), (entry, batch))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(entry, batch, *args, **kwargs)
            end.record()
            marks.append((entry.name, bucket, start, end))
            return out
        return run

    server._compiled = timed(compiled, 1)  # (entry, batch, bucket, run)
    server._scored = timed(scored, 0)  # (entry, batch, run)

    def untime():
        del server._compiled, server._scored

    return marks, seen, untime


def tenant_device_time(server, marks, seen, tenant_of, device):
    """Each tenant's device time under the flood: each of its batches
    priced at the device time of one forward and one scoring replay of its
    (model, bucket), taken with :func:`device_ms` on the idle card after
    the burst (a replay's work does not depend on what waits on the host),
    and its share. Beside them, the CUDA-event spans around the batcher's
    calls during the burst, which also hold the host's stalls, and the
    order in which the batcher dispatched the batches (one letter a batch,
    the tenant's first)."""
    if not marks:
        return None
    torch.cuda.synchronize()
    replay_ms = {}
    for (name, bucket), (entry, batch) in seen.items():
        fwd = device_ms(lambda: server._compiled(entry, batch, bucket), device, iters=5, repeats=3)
        score = device_ms(lambda: server._scored(entry, batch), device, iters=5, repeats=3)
        replay_ms[(name, bucket)] = median(fwd) + median(score)
    tenants = sorted(set(tenant_of.values()))
    ms, spans, batches = ({t: 0.0 for t in tenants}, {t: 0.0 for t in tenants},
                          {t: 0 for t in tenants})
    order = []
    for name, bucket, start, end in marks:
        tenant = tenant_of[name]
        spans[tenant] += start.elapsed_time(end)
        if bucket is not None:
            ms[tenant] += replay_ms[(name, bucket)]
            batches[tenant] += 1
            order.append(tenant[0])
    total = sum(ms.values())
    return {"batches": batches, "dispatch_order": "".join(order), "device_ms": ms,
            "device_share": {t: v / total for t, v in ms.items()},
            "replay_device_ms": {f"{n}:{b}": v for (n, b), v in replay_ms.items()},
            "spans_ms": spans}


def host_costs():
    """Host microseconds of one ``note_batch`` and of tracing one batch of
    64 riders (four spans each, and each trace's finish and flush into a
    no-op sink)."""
    ledger = CostLedger()
    t0 = time.perf_counter()
    for i in range(2000):
        ledger.note_batch("screen", i % 3, 64, batch_seconds=0.001, flops=1e9)
    note_us = (time.perf_counter() - t0) / 2000 * 1e6
    tracer = Tracer(sample=1.0, emit=lambda *a, **k: None)
    t0 = time.perf_counter()
    for _ in range(20):
        traces = [tracer.start(tenant="screen") for _ in range(64)]
        w0 = time.time()
        for t in traces:
            for name in ("queue_wait", "batch_form", "dispatch", "readback"):
                t.record(name, w0, 0.001, bucket=0)
        for t in traces:
            t.finish("ok")
    trace_us = (time.perf_counter() - t0) / 20 * 1e6
    return {"note_batch_us": note_us, "tracing_us_per_batch_of_64": trace_us}


def gat_dropout_scores(plan, graphs, device, card, size):
    """GAT's ``dropout``-mode scores on ``GAT_SCORE_GRAPHS`` graphs in
    ``segment`` mode. The scorer re-seeds its generator before each
    replay, so two dispatches draw the same masks; their variances then
    differ only by K1's atomics, which add in a run-dependent order (two
    replays of the plain eval forward show it): each output within
    ``eps = 1e-5 * (max |output| + 1)`` (K1's tolerance,
    ``segment_kernels.atomic_tolerance``), each variance within ``4 eps
    sqrt(var) + 4 eps^2``. Another seed's masks move the variances past
    100 times that bound. The replay's variances are also held, within
    the same bound, against a plain reference: a copy of the model in
    ``train()`` mode run K times eagerly on the card from a generator
    seeded as the scorer's, then ``torch.var(correction=0)``. Held too:
    the variance drawn (> 0), the running statistics bit-unchanged, K1
    launched K times a forward's a dispatch."""
    cfg = arch(size, "GAT")
    model = create_model_config(cfg, device=device, aggregation="segment", seed=0)
    set_bn_stats(model, seed=0)
    registry = ModelRegistry()
    entry = registry.register("gat", model)
    take, b = largest_take(plan, graphs)
    take = take[:GAT_SCORE_GRAPHS]
    batch = plan.pack(take, b)[0]
    before = [b.clone() for b in model.buffers()]
    scorer = UncertaintyScorer("dropout", samples=TENANCY_K, seed=0, registry=registry,
                               device=device)
    scorer.dispatch(entry, batch, run=False)  # the capture
    reset_launch_counts()
    first = [v.cpu() for v in scorer.dispatch(entry, batch)]
    second = [v.cpu() for v in scorer.dispatch(entry, batch)]
    counts = launch_counts()
    scorer.release()
    plain = copy.deepcopy(model).train()
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        outs = [[o.float() for o in plain(batch, generator=gen)] for _ in range(TENANCY_K)]
    reference = [torch.var(torch.stack([o[i] for o in outs]), dim=0, correction=0).cpu()
                 for i in range(len(first))]
    del plain, outs
    other = UncertaintyScorer("dropout", samples=TENANCY_K, seed=1, registry=registry,
                              device=device)
    moved = [v.cpu() for v in other.dispatch(entry, batch)]
    other.release()

    def forward(b):
        with torch.inference_mode():
            return [o.float() for o in model(b)]

    evals = ProgramSet(device).program("gat_eval", forward)
    e1 = [o.cpu() for o in evals(batch)]
    e2 = [o.cpu() for o in evals(batch)]

    def over_bound(a, b, s):
        eps = 1e-5 * (s + 1.0)
        bound = 4 * eps * torch.sqrt(torch.maximum(a, b)) + 4 * eps * eps
        return float(((a - b).abs() / bound).max())

    scale = [float(o.abs().max()) for o in e1]
    per_forward = launches_per_forward(cfg, "segment")
    expected = {k: 2 * TENANCY_K * v for k, v in per_forward.items()}
    result = {
        "family": "GAT", "mode": "dropout", "graphs": len(take), "samples": TENANCY_K,
        "bit_equal": all(torch.equal(a, b) for a, b in zip(first, second)),
        "max_abs_diff": [float((a - b).abs().max()) for a, b in zip(first, second)],
        "repeat_over_bound": max(over_bound(a, b, s) for a, b, s in zip(first, second, scale)),
        "other_seed_over_bound": max(over_bound(a, b, s) for a, b, s in zip(first, moved, scale)),
        "plain_reference_over_bound": max(over_bound(a, b, s)
                                          for a, b, s in zip(first, reference, scale)),
        "eval_replays_bit_equal": all(torch.equal(a, b) for a, b in zip(e1, e2)),
        "eval_replays_max_abs_diff": [float((a - b).abs().max()) for a, b in zip(e1, e2)],
        "max_var": [float(v.max()) for v in first], "output_scale": scale,
        "running_stats_unchanged": all(torch.equal(a, b) for a, b in zip(before, model.buffers())),
        "launches": counts, "card": card,
    }
    emit({"serve_tenancy_dropout": result})
    if not (result["repeat_over_bound"] <= 1.0 and result["other_seed_over_bound"] > 100.0
            and result["plain_reference_over_bound"] <= 1.0
            and result["running_stats_unchanged"] and min(result["max_var"]) > 0) or (
            device.type == "cuda" and counts != expected):
        raise AssertionError(f"GAT dropout scores: {result}, expected launches {expected}")
    return counts


def phase_serve_tenancy(plan, graphs, device, card, size):
    """Two tenants on one server with the response cache, the cost ledger,
    the ensemble scorer, a tracer at rate 1 and ``/metrics``: PNA at
    ``MXU_HEADLINE``'s width in ``fused`` mode with :data:`TENANCY_K`
    versions (tenant ``screen``, weight 3), and GIN in ``fused`` mode
    (tenant ``flood``, weight 1, quota :data:`TENANCY_FLOOD_QUOTA`). Held:
    every response against the CPU; the captured ensemble against the same
    members eagerly on the card and on the CPU; the scoring program's
    launches K times the forward's per bucket, and the burst's launches
    those of its batches; the flood, sent from its own thread while the
    screening burst runs, shed past its quota while ``screen`` is all
    served, with each tenant's device time (its batches priced at their
    replays' device time, :func:`tenant_device_time`); a permuted resubmit
    answered from the cache with no dispatch; the bill's rows summing to
    the replica-seconds; four spans per traced request; ``compiles_total``
    two per bucket and model, and two per bucket more for a promote; no
    scorer error. Then the scorer's times beside the forward's, the
    latency of the scorer alone, of the cache and the ledger alone and of
    a bare server (no flood), and of cache hits, the host cost of the
    ledger and of tracing, and GAT's dropout scores
    (:func:`gat_dropout_scores`)."""
    t_run = time.perf_counter()
    pna_cfg, gin_cfg = arch(size, "PNA"), arch(size, "GIN")
    registry = ModelRegistry()
    for v in range(TENANCY_K):
        model = create_model_config(pna_cfg, device=device, aggregation="fused", seed=v)
        set_bn_stats(model, seed=v)
        registry.register("pna", model)
    registry.register("gin", create_model_config(gin_cfg, device=device, aggregation="fused"))
    tenants = TenantManager.from_specs([
        {"name": "screen", "model": "pna", "weight": 3.0},
        {"name": "flood", "model": "gin", "weight": 1.0, "quota": TENANCY_FLOOD_QUOTA},
    ])
    out_dir = _build.REPO_ROOT / "build" / "chip_smoke" / "tenancy"
    out_dir.mkdir(parents=True, exist_ok=True)
    events = out_dir / "events.jsonl"
    if events.exists():
        events.unlink()
    log = RunEventLog(str(events))
    tracer = Tracer(sample=1.0, emit=log.emit)
    costs = CostLedger(emit=log.emit)
    scorer = UncertaintyScorer("ensemble", samples=TENANCY_K, registry=registry, device=device)
    server = InferenceServer(registry, plan, queue_capacity=4 * len(graphs), tenants=tenants,
                             cache=ResponseCache(), costs=costs, scorer=scorer,
                             observability_port=0, device=device)
    server.start()
    try:
        compiles = {"after_warmup": server.metrics.snapshot()["compiles_total"]}
        flood_graphs = make_graphs(TENANCY_FLOOD, TENANCY_FLOOD_NODES, degree=4, seed=7)

        marks, seen, untime = time_dispatches(server, device)
        reset_launch_counts()
        # the flood alongside the screening burst, from its own thread: past
        # its quota it is shed at submit, while the screening is all served
        flood, shed, screened = [], [0], threading.Event()

        def flooder():
            for g in flood_graphs:
                if screened.is_set():
                    break
                try:
                    flood.append((g, server.submit(g, tenant="flood")))
                except TenantOverQuota:
                    shed[0] += 1
                time.sleep(TENANCY_FLOOD_GAP_S)

        flooding = threading.Thread(target=flooder)
        flooding.start()
        halfway = threading.Event()
        scrape = {}

        def scrape_metrics():
            halfway.wait(600)
            host, port = server.observability_address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=60) as r:
                scrape["series"] = parse_prometheus(r.read().decode())
            with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
                scrape["health"] = json.loads(r.read())

        scraper = threading.Thread(target=scrape_metrics)
        scraper.start()
        t0 = time.monotonic()
        futures, submitted, traces = burst(server, graphs, 4, tenant="screen", tracer=tracer,
                                           halfway=halfway)
        answers = [f.result(600) for f in futures]
        wall = max(f.done_at for f in futures) - t0
        screened.set()
        flooding.join(120)
        shed = shed[0]
        for _, f in flood:
            f.result(600)
        for t in traces:
            t.finish("ok")
        scraper.join(120)
        counts = launch_counts()
        untime()
        shares = tenant_device_time(server, marks, seen, {"pna": "screen", "gin": "flood"}, device)
        snap = server.metrics.snapshot()
        compiles["after_burst"] = snap["compiles_total"]
        on = latency_ms(futures, submitted)

        # launches: each batch one forward and one scoring replay (K members
        # for PNA, GIN's one version alone)
        pna_batches = len({f.batch_seq for f in futures})
        gin_batches = len({f.batch_seq for _, f in flood})
        per = {"pna": launches_per_forward(pna_cfg, "fused"), "gin": launches_per_forward(gin_cfg, "fused")}
        expected = {k: pna_batches * (1 + TENANCY_K) * per["pna"][k] + gin_batches * 2 * per["gin"][k]
                    for k in KERNELS}
        entry = registry.get("pna")
        fwd_prog = server._programs.programs[f"serve:pna:v{entry.version}"]
        score_prog = scorer.program(entry)
        per_bucket = []
        for key, graph in fwd_prog.graphs.items():
            if graph is not None:  # on the card: one replay's launches of each
                scored = score_prog.graphs[key].launches
                per_bucket.append({k: scored[k] == TENANCY_K * v for k, v in graph.launches.items()})
        if device.type == "cuda" and (counts != expected or not per_bucket
                                      or not all(all(b.values()) for b in per_bucket)):
            raise AssertionError(f"tenancy: launches {counts}, expected {expected}; "
                                 f"scored/forward per bucket {per_bucket}")

        worst = hold_responses(futures, graphs, plan, {"pna": entry.model,
                                                       "gin": registry.get("gin").model})
        worst = max(worst, hold_responses([f for _, f in flood], [g for g, _ in flood], plan,
                                          {"gin": registry.get("gin").model}))
        ensemble = ensemble_check(server, scorer, entry, plan, graphs, device)

        # the cache: the same molecules with their atoms permuted, no dispatch
        batches = server.metrics.snapshot()["batches_total"]
        perm_graphs = []
        for i, g in enumerate(graphs):
            perm = np.random.default_rng(100 + i).permutation(g.num_nodes)
            inv = np.argsort(perm)
            perm_graphs.append(GraphData(x=g.x[perm], pos=g.pos[perm], edge_index=inv[g.edge_index],
                                         edge_attr=g.edge_attr))
        hits, hit_submitted, _ = burst(server, perm_graphs, 4, tenant="screen")
        for f, want in zip(hits, answers):
            got = f.result(60)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("tenancy: a cache hit differs from the cached answer")
        hit_dispatches = server.metrics.snapshot()["batches_total"] - batches
        bill = costs.bill()
        rows = sum(r["device_s"] for r in bill["tenants"].values())

        # the spans: every traced request has its four
        log.close()
        built = build_traces(load_span_events(str(events)))
        four = all({s["name"] for s in t["spans"]} >= {"queue_wait", "batch_form", "dispatch",
                                                       "readback"} for t in built.values())

        timing = scorer_timing(server, scorer, entry, plan, graphs, device)
        # a promote: v4 pinned, v5 registered and warmed through the batcher
        # (its forward and the new member set's scoring program per bucket),
        # then promoted, which drops pna's cached answers
        registry.promote("pna", entry.version)
        model = create_model_config(pna_cfg, device=device, aggregation="fused", seed=TENANCY_K)
        set_bn_stats(model, seed=TENANCY_K)
        registry.register("pna", model)
        warmed = server.warm_version("pna", version=TENANCY_K + 1)
        registry.promote("pna", TENANCY_K + 1)
        cached_after = server.cache.stats()["entries"]
        compiles["after_promote"] = server.metrics.snapshot()["compiles_total"]
        scorer_errors = server.metrics.snapshot()["scorer_errors"]
    finally:
        server.stop()

    # the latency of each part alone, with no flood: the same PNA versions
    # on a server with the scorer only, with the cache and the ledger only,
    # and with neither
    alone_reg = ModelRegistry()
    for v in range(1, TENANCY_K + 1):
        alone_reg.register("pna", registry.get("pna", v).model)
    alone = {}
    for name, extras in (
            ("scorer_only", dict(scorer=UncertaintyScorer(
                "ensemble", samples=TENANCY_K, registry=alone_reg, device=device))),
            ("cache_and_ledger_only", dict(cache=ResponseCache(), costs=CostLedger())),
            ("bare", {})):
        plain = InferenceServer(alone_reg, plan, queue_capacity=len(graphs), device=device,
                                **extras)
        with plain:
            off_futures, off_submitted, _ = burst(plain, graphs, 4)
            for f in off_futures:
                f.result(600)
            if plain.metrics.snapshot()["scorer_errors"]:
                raise AssertionError(f"tenancy: scorer errors on the {name} server")
        if plain.scorer is not None:
            plain.scorer.release()
        alone[name] = latency_ms(off_futures, off_submitted)

    b = plan.num_buckets
    result = {
        "requests": len(graphs), "flood_sent": len(flood) + shed,
        "flood_quota": TENANCY_FLOOD_QUOTA,
        "flood_shed": shed, "batches": {"pna": pna_batches, "gin": gin_batches},
        "launches": counts, "scored_launches_k_times_forward": per_bucket,
        "max_abs_err_vs_cpu": worst, "ensemble": ensemble,
        "latency_all_on_with_flood": on, "latency_alone": alone,
        "latency_cache_hits": latency_ms(hits, hit_submitted), "cache_hit_dispatches": hit_dispatches,
        "graphs_per_s": len(graphs) / wall,
        "cost_share": {t: r["cost_share"] for t, r in bill["tenants"].items()},
        "flood_device_time": shares,
        "bill": bill, "bill_rows_plus_idle_minus_replica_s": rows + bill["idle_s"] - bill["replica_s"],
        "traces": len(built), "four_spans_each": four,
        "scrape": {"series": len(scrape.get("series", {})),
                   "scorer_errors_total": scrape.get("series", {}).get(
                       "hydragnn_serve_scorer_errors_total"),
                   "health_status": scrape.get("health", {}).get("status")},
        "compiles_total": compiles, "warm_version": warmed, "cache_entries_after_promote": cached_after,
        "scorer_errors": scorer_errors, "scorer_timing": timing, "host": host_costs(),
        "card": card,
    }
    problems = []
    if not (0 < shed and len(flood) + shed <= TENANCY_FLOOD):
        problems.append("the flood was not shed")
    if shares is not None and not (shares["batches"]["flood"] == gin_batches
                                   and shares["batches"]["screen"] == pna_batches):
        problems.append(f"device spans {shares['batches']} for batches {result['batches']}")
    if hit_dispatches != 0:
        problems.append("cache hits dispatched")
    if abs(result["bill_rows_plus_idle_minus_replica_s"]) > 1e-5:
        problems.append("the bill's rows do not sum to the replica-seconds")
    if len(built) != len(graphs) or not four:
        problems.append("traced requests without their four spans")
    if "series" not in scrape or result["scrape"]["health_status"] != "ok":
        problems.append("the /metrics scrape failed")
    want = {"after_warmup": 2 * 2 * b, "after_burst": 2 * 2 * b, "after_promote": 2 * 2 * b + 2 * b}
    if compiles != want or not warmed["verified"]:
        problems.append(f"compiles_total {compiles}, expected {want}")
    if cached_after != len(flood):  # gin's answers stay, pna's went
        problems.append("the promote left pna's cached answers")
    if scorer_errors or snap["errors_total"] or any(f.uncertainty is None for f in futures):
        problems.append("scorer errors or unscored responses")
    result["problems"] = problems
    emit({"serve_tenancy": result})
    if problems:
        raise AssertionError(f"serve tenancy: {problems}")
    counts_gat = gat_dropout_scores(plan, graphs, device, card, size)
    result["run_s"] = time.perf_counter() - t_run
    print(f"serve tenancy run_s {result['run_s']:.1f}", flush=True)
    return {k: counts[k] + counts_gat[k] for k in KERNELS}


# ---- phase 4: the serving fleet ---------------------------------------------

FLEET_REPLICAS = 2
FLEET_CLIENTS = 3  # the closed-loop clients through the kill, the swaps, the canary and drift
FLEET_SWEEP = (3, 12, 24)  # the clients of the throughput windows, each at 2 replicas and at 1
FLEET_DEADLINE_S = 30.0  # each routed request's deadline
FLEET_WAIT_S = 240.0  # the longest wait for a boot, a heal, a promote or a decision
FLEET_WINDOW_S = 3.0  # each throughput window
FLEET_OVERHEAD_REQUESTS = 32  # sequential requests: the router against a direct predict
FLEET_CANARY_NOISE = 1e-4  # the close candidate: v2's weights times (1 + this * N(0, 1))
FLEET_SHIFT = 3.0  # HYDRAGNN_FAULT_SHIFT_INPUTS's scale on the autoscaled replica
# every replica's drift knobs: a window of 64 requests drawn from the 64
# graphs scores PSI ~0.3 and KS ~0.2 against a clean one (the count features
# have 64 values a window); a 3x shift scores KS 1
FLEET_DRIFT = {"WINDOW": 64, "PSI": 1.0, "KS": 0.5, "RAISE": 2, "CLEAR": 2, "BINS": 64}


class _LeaseWatch(threading.Thread):
    """Reads every lease of a coordination directory each 20 ms: the first
    serving write of each (kind, member, incarnation), the longest gap
    between two writes of a serving lease, and the checkpoint behind each
    (replica, version) a lease reports active."""

    def __init__(self, coord_dir, fleet):
        super().__init__(name="chip-smoke-lease-watch", daemon=True)
        self.coord_dir, self.fleet = coord_dir, fleet
        self.first_serving, self.spawned, self.last, self.sources = {}, {}, {}, {}
        self.gap = (0.0, None)
        self.halt = threading.Event()

    def run(self):
        while not self.halt.wait(0.02):
            for h in list(self.fleet._replicas.values()):
                if h.proc is not None:
                    self.spawned.setdefault((h.rid, h.incarnation), h.spawned_ts)
            for kind in (fleet_mod.REPLICA, fleet_mod.CANARY):
                for path in sorted((self.coord_dir / f"{kind}s").glob(f"{kind}-*.json")):
                    lease = coord.read_json(str(path))
                    if not lease or "ts" not in lease or "replica" not in lease:
                        continue
                    key = (kind, int(lease["replica"]), int(lease.get("gen", 0)))
                    ts = float(lease["ts"])
                    if lease.get("state") == "serving" and not lease.get("done"):
                        self.first_serving.setdefault(key, ts)
                        prev = self.last.get(key)
                        if prev is not None and ts - prev > self.gap[0]:
                            self.gap = (ts - prev, f"{kind} {key[1]} incarnation {key[2]}")
                        self.last[key] = ts
                    active = lease.get("active") or {}
                    if kind == fleet_mod.REPLICA and active.get("version") is not None:
                        self.sources[(key[1], int(active["version"]))] = active.get("source")

    def boot_s(self):
        """Spawn to serving lease, per replica and incarnation."""
        first = self.first_serving
        return {f"{rid}/{gen}": first[(fleet_mod.REPLICA, rid, gen)] - ts
                for (rid, gen), ts in sorted(self.spawned.items())
                if (fleet_mod.REPLICA, rid, gen) in first}


class _PinnedRouter(FleetRouter):
    """A router that sees one replica only: the 1-replica throughput
    window, through the same discovery, admission and retry code."""

    def __init__(self, coord_dir, rid, **kw):
        super().__init__(coord_dir, **kw)
        self.rid = rid

    def live_replicas(self):
        return [r for r in super().live_replicas() if r[0] == self.rid]


class _FleetLoad:
    """Closed-loop clients routing the fleet's graphs: each outcome with its
    phase, router, number of active clients, times, graph, replica,
    version, micro-batch and heads. Of its ``clients`` threads the first
    ``active`` send; the others wait."""

    def __init__(self, routers, graphs, clients, seed):
        self.routers, self.graphs = routers, graphs
        self.phase, self.route_by, self.active = "steady", "all", clients
        self.records, self.failures = [], []
        self.lock = threading.Lock()
        self.halt = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(k, seed + k), daemon=True)
                        for k in range(clients)]

    def _client(self, k, seed):
        rng = np.random.default_rng(seed)
        while not self.halt.is_set():
            if k >= self.active:
                self.halt.wait(0.01)
                continue
            i = int(rng.integers(len(self.graphs)))
            phase, route_by, active = self.phase, self.route_by, self.active
            router = self.routers[route_by]
            tag = {"phase": phase, "route": route_by, "clients": active}
            t0 = time.perf_counter()
            try:
                raw = router.route(self.graphs[i], deadline_s=FLEET_DEADLINE_S, raw=True)
                rec = dict(tag, t0=t0, t1=time.perf_counter(), ok=True, graph=i,
                           replica=raw["replica"], version=raw["version"],
                           batch_seq=raw["batch_seq"],
                           heads=[np.asarray(h, np.float32) for h in raw["heads"]])
            except ServerOverloaded:
                rec = dict(tag, t0=t0, t1=time.perf_counter(), ok=False)
            except Exception as e:  # a lost request: the phase fails
                with self.lock:
                    self.failures.append(f"{phase}: {type(e).__name__}: {e}")
                continue
            with self.lock:
                self.records.append(rec)

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def stop(self):
        self.halt.set()
        for t in self.threads:
            t.join(FLEET_DEADLINE_S + 30)

    def done(self, pred=lambda r: True):
        with self.lock:
            return [r for r in self.records if pred(r)]

    def window(self, t0, t1):
        """Requests a second answered in ``[t0, t1]``, and their latency."""
        recs = self.done(lambda r: r["ok"] and t0 <= r["t1"] <= t1)
        return len(recs) / (t1 - t0), _latency(recs)


def _latency(records):
    lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in records if r["ok"])
    if not lat:
        return None
    return {"n": len(lat), "p50": lat[len(lat) // 2],
            "p99": lat[min(int(len(lat) * 0.99), len(lat) - 1)]}


def _wait(pred, what, timeout=FLEET_WAIT_S, every=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(every)
    raise AssertionError(f"fleet: timed out after {timeout:.0f} s waiting for {what}")


def _events(stream, kind):
    """The ``kind`` records of one replica's quality events."""
    return [r for r in load_quality_events(stream) if r.get("event") == kind]


def _fleet_artifacts(workdir, graphs, cfg, device, size):
    """The phase's v2 checkpoints, each from a ``TrainState`` (weights from a
    seed, BatchNorm statistics from a numpy seed): ``v1`` (seed 0), ``v2``
    (seed 1), ``broken`` (v2's file read through
    ``HYDRAGNN_FAULT_CORRUPT_CANDIDATE``'s byte-flipped copy), the canary's
    ``close`` (v2 with relative noise) and ``other`` (seed 2); the samples'
    pickle and the fleet spec."""
    ckdir = workdir / "ck"
    models = {}
    for name, seed in (("v1", 0), ("v2", 1), ("other", 2)):
        model = create_model_config(cfg, device=device, aggregation="fused", seed=seed)
        set_bn_stats(model, seed=seed)
        models[name] = model
    close = copy.deepcopy(models["v2"])
    gen = torch.Generator(device="cpu").manual_seed(3)
    with torch.no_grad():
        for p in close.parameters():
            noise = torch.randn(p.shape, generator=gen).to(p.device)
            p.mul_(1.0 + FLEET_CANARY_NOISE * noise)
    models["close"] = close
    for name, model in models.items():
        save_model(TrainState(model=model, optimizer=select_optimizer(TRAIN_CONFIG, model)),
                   name, path=str(ckdir))
    real = str(ckdir / "v2" / "v2.pk")
    old = os.environ.get("HYDRAGNN_FAULT_CORRUPT_CANDIDATE")
    os.environ["HYDRAGNN_FAULT_CORRUPT_CANDIDATE"] = "all"
    try:
        flipped = faults.corrupt_candidate(real)
    finally:
        if old is None:
            del os.environ["HYDRAGNN_FAULT_CORRUPT_CANDIDATE"]
        else:
            os.environ["HYDRAGNN_FAULT_CORRUPT_CANDIDATE"] = old
    (ckdir / "broken").mkdir()
    os.replace(flipped, ckdir / "broken" / "broken.pk")
    samples = workdir / "samples.pkl"
    with open(samples, "wb") as f:
        pickle.dump(list(graphs), f)
    plan_kw = {"max_batch_graphs": size["batch"], "num_buckets": 3}
    spec = {"checkpoint": {"name": "v1", "path": str(ckdir)}, "arch": cfg, "model_name": "pna",
            "samples": str(samples), "plan": plan_kw,
            "server": {"max_wait_s": 0.005, "queue_capacity": 256}}
    if device.type == "cpu":
        spec["device"] = "cpu"  # absent: the replicas serve on the card or refuse to start
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    return ckdir, str(spec_path), plan_kw


def _fleet_references(ckdir, graphs, cfg, plan_kw, device):
    """Every weights' answers to every graph (and ``close``'s to the graphs
    shifted as the autoscaled replica shifts them) from an in-process
    server on the phase's device and the replicas' plan; the forwards'
    launches and the direct predict's latency (``v1``, one request at a
    time)."""
    registry = ModelRegistry()
    for name in ("v1", "v2", "close", "other"):
        registry.load_checkpoint(name, arch_config=cfg, path=str(ckdir), device=device)
    plan = plan_from_samples(graphs, **plan_kw)
    shifted = []
    for g in graphs:
        s = g.clone()
        s.x, s.pos = s.x * FLEET_SHIFT, s.pos * FLEET_SHIFT
        shifted.append(s)
    reset_launch_counts()
    with InferenceServer(registry, plan, queue_capacity=1024, device=device) as server:
        futures = {name: [server.submit(g, model=name) for g in graphs]
                   for name in ("v1", "v2", "close", "other")}
        futures["close_shifted"] = [server.submit(g, model="close") for g in shifted]
        refs = {name: [f.result(FLEET_WAIT_S) for f in fs] for name, fs in futures.items()}
        direct = []
        for g in graphs[:FLEET_OVERHEAD_REQUESTS]:
            t0 = time.perf_counter()
            server.predict(g, model="v1", timeout=FLEET_DEADLINE_S)
            direct.append((t0, time.perf_counter()))
    counts = launch_counts()
    return refs, counts, plan.num_buckets, _latency([{"ok": True, "t0": a, "t1": b}
                                                      for a, b in direct])


def _device_work(coord_dir, cfg, device, problems):
    """Each replica's and canary's final (``done``) lease under
    ``coord_dir``: its micro-batches, its captures and its kernels'
    launches, counted in its own process from 0. A batch replays one
    forward and a capture runs one eager warm-up, so on the card each
    process must have launched (batches + compiles) times one forward's
    kernels (:func:`launches_per_forward`: K3 once a conv layer, K1 once),
    and on the CPU none. A killed incarnation's lease is overwritten by
    its successor's and is not read. Returns ``({member: its work},
    {kernel: launches summed})``."""
    per_forward = launches_per_forward(cfg, "fused")
    rows, total = {}, {k: 0 for k in KERNELS}
    for kind in (fleet_mod.REPLICA, fleet_mod.CANARY):
        for path in sorted((coord_dir / f"{kind}s").glob(f"{kind}-*.json")):
            lease = coord.read_json(str(path)) or {}
            member = f"{kind} {lease.get('replica')} incarnation {lease.get('gen')}"
            if not lease.get("done") or "launches" not in lease:
                problems.append(f"{path.name}: no final lease with its device work")
                continue
            forwards = lease["batches"] + lease["compiles"]
            want = {k: forwards * v if device.type == "cuda" else 0
                    for k, v in per_forward.items()}
            got = {k: int(lease["launches"].get(k, 0)) for k in KERNELS}
            rows[member] = {"batches": lease["batches"], "compiles": lease["compiles"],
                            "launches": {k: v for k, v in got.items() if v or want[k]}}
            if got != want or lease["batches"] == 0:
                problems.append(f"{member}: {lease['batches']} batches and {lease['compiles']} "
                                f"compiles launched {got}, expected {want}")
            for k in KERNELS:
                total[k] += got[k]
    return rows, total


def _hold_answers(load, refs, sources, shifted_replica):
    """Every answer against its version's in-process forward (the lease's
    checkpoint behind the (replica, version) it names), within K1's and
    K3's tolerance ``1e-5 * (max |answer| + 1)`` a head
    (``segment_kernels.atomic_tolerance``); the autoscaled replica's
    shifted requests against the shifted graphs' forward. Returns
    ``(answers held, shifted among them, worst error over its tolerance,
    {weights: answers})``."""
    held = shifted = 0
    worst = 0.0
    by_weights = {}
    for r in load.done(lambda r: r["ok"]):
        source = sources.get((r["replica"], r["version"]))
        if source is None:
            raise AssertionError(f"fleet: no lease named replica {r['replica']}'s "
                                 f"version {r['version']}")
        name = os.path.basename(source)
        cands = [refs[name][r["graph"]]]
        if r["replica"] == shifted_replica and name == "close":
            cands.append(refs["close_shifted"][r["graph"]])
        ratios = []
        for want in cands:
            ratio = 0.0
            for got, w in zip(r["heads"], want):
                if got.shape != w.shape or not np.isfinite(got).all():
                    ratio = np.inf
                    break
                tol = atomic_tolerance(torch.from_numpy(np.asarray(w, np.float32)))
                ratio = max(ratio, float(np.abs(got - w).max()) / tol)
            ratios.append(ratio)
        best = min(ratios)
        if best > 1.0:
            raise AssertionError(f"fleet: replica {r['replica']} v{r['version']} ({name}) "
                                 f"graph {r['graph']}: error {best:.3g} times the tolerance")
        worst = max(worst, best)
        held += 1
        shifted += int(len(ratios) == 2 and ratios[1] < ratios[0])
        by_weights[name] = by_weights.get(name, 0) + 1
    return held, shifted, worst, by_weights


def phase_fleet(graphs, device, card, size, workdir=None):
    """The serving fleet on the card (module docstring, phase 4): two
    replica processes of ``python -m hydragnn_tpu_torch.serve.fleet`` (PNA at
    ``MXU_HEADLINE``'s width, ``fused``), a ``FleetRouter`` in this process
    under :data:`FLEET_CLIENTS` closed-loop clients, through a steady state,
    a SIGKILL, a hot-swap, a corrupt candidate, a canary that rejects one
    candidate and promotes another, an autoscaler tick and a drift alert;
    then the CLI's supervisor (:func:`_fleet_cli`).
    Returns the kernel launches of every replica and canary process,
    read from their final leases (:func:`_device_work`); this process's
    reference forwards are reported apart."""
    t_run = time.perf_counter()
    workdir = pathlib.Path(workdir or _build.REPO_ROOT / "build" / "chip_smoke" / "fleet")
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = arch(size, "PNA")
    saved_env = {k: os.environ.get(k) for k in ("HYDRAGNN_AGG", "PYTHONPATH")}
    # the replicas, the canaries and this process's references run `fused`
    os.environ["HYDRAGNN_AGG"] = "fused"
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_build.REPO_ROOT), saved_env["PYTHONPATH"]) if p)
    problems = []
    try:
        ckdir, spec_path, plan_kw = _fleet_artifacts(workdir, graphs, cfg, device, size)
        refs, counts, num_buckets, direct = _fleet_references(ckdir, graphs, cfg, plan_kw, device)
        if device.type == "cuda" and not (counts["fused_gather_moments"] and counts["segment_sum"]):
            problems.append(f"the reference forwards launched {counts}")
        # the rejected candidate must fail the MAE gate by a margin
        gates = CanaryGates.from_env()
        other_mae = []
        for h in range(2):
            live = np.concatenate([np.ravel(a[h]) for a in refs["v2"]]).astype(np.float64)
            other = np.concatenate([np.ravel(a[h]) for a in refs["other"]]).astype(np.float64)
            tol = max(gates.head_mae_tol, gates.head_mae_rel_tol * float(np.abs(live).mean()))
            other_mae.append(float(np.abs(other - live).mean()) / tol)
        if max(other_mae) < 2.0:
            raise AssertionError(f"fleet: seed 2's weights sit within {max(other_mae):.2f}x the "
                                 "canary's MAE gate of v2's: no rejection to show")
        result = _run_fleet(workdir, ckdir, spec_path, graphs, cfg, refs, num_buckets, direct,
                            gates, problems, device)
        result["cli"] = _fleet_cli(workdir, spec_path, graphs, cfg, refs, problems, device)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launched = {k: result["launches"][k] + result["cli"]["launches"][k] for k in KERNELS}
    result.update(card=card, launches=launched, reference_launches=counts,
                  other_mae_over_gate=other_mae, wall_s=time.perf_counter() - t_run,
                  problems=problems)
    emit({"fleet": result})
    if problems:
        raise AssertionError(f"fleet: {problems}")
    return launched


def _fleet_cli(workdir, spec_path, graphs, cfg, refs, problems, device):
    """The supervisor as users start it: ``python -m
    hydragnn_tpu_torch.serve.fleet --spec --dir --replicas`` in its own
    process, until both replicas serve; one routed answer per replica held
    against ``v1``'s forward; SIGTERM, then a clean exit with every lease
    released, and the replicas' device work (:func:`_device_work`)."""
    coord_dir = workdir / "cli"
    cmd = [sys.executable, "-m", "hydragnn_tpu_torch.serve.fleet", "--spec", spec_path,
           "--dir", str(coord_dir), "--replicas", str(FLEET_REPLICAS)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd)
    try:
        _wait(lambda: (coord.read_json(str(coord_dir / "fleet.json")) or {}).get("live")
              == FLEET_REPLICAS or proc.poll() is not None, "the CLI's replicas")
        if proc.poll() is not None:
            raise AssertionError(f"fleet: the CLI exited with {proc.returncode}")
        out = {"serving_s": time.perf_counter() - t0}
        router = FleetRouter(str(coord_dir), max_attempts=6, retry_base_delay_s=0.05)
        seen = set()
        for i in range(4 * FLEET_REPLICAS):
            raw = router.route(graphs[i], deadline_s=FLEET_DEADLINE_S, raw=True)
            seen.add(raw["replica"])
            for got, want in zip(raw["heads"], refs["v1"][i]):
                got = np.asarray(got, np.float32)
                tol = atomic_tolerance(torch.from_numpy(np.asarray(want, np.float32)))
                if got.shape != want.shape or float(np.abs(got - want).max()) > tol:
                    problems.append(f"the CLI's replica {raw['replica']} answered graph {i} off")
        out["replicas_answered"] = sorted(seen)
        proc.send_signal(signal.SIGTERM)
        out["exit_code"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    leases = [coord.read_json(str(p)) for p in sorted((coord_dir / "replicas").glob("*.json"))]
    out["leases_done"] = [bool(lease and lease.get("done")) for lease in leases]
    if out["exit_code"] != 0 or len(seen) != FLEET_REPLICAS or not all(out["leases_done"]):
        problems.append(f"the CLI: {out}")
    out["device_work"], out["launches"] = _device_work(coord_dir, cfg, device, problems)
    return out


def _run_fleet(workdir, ckdir, spec_path, graphs, cfg, refs, num_buckets, direct, gates,
               problems, device):
    coord_dir = workdir / "coord"
    env = {"HYDRAGNN_AGG": "fused", "PYTHONPATH": os.environ["PYTHONPATH"]}
    env.update({f"HYDRAGNN_DRIFT_{k}": str(v) for k, v in FLEET_DRIFT.items()})
    fleet = ServingFleet(str(coord_dir), FLEET_REPLICAS, spec_path=spec_path, env=env,
                         log_dir=str(workdir / "log"))
    watch = _LeaseWatch(coord_dir, fleet)
    controller = load = None
    out = {"config": "MXU_HEADLINE's width: PNA hidden %d, %d conv layers, fused, f32"
                     % (cfg["hidden_dim"], cfg["num_conv_layers"]),
           "replicas": FLEET_REPLICAS, "clients": FLEET_CLIENTS, "num_buckets": num_buckets,
           "drift_knobs": FLEET_DRIFT}
    try:
        watch.start()
        t0 = time.perf_counter()
        fleet.start(wait_serving=True, timeout=FLEET_WAIT_S)
        out["fleet_boot_s"] = time.perf_counter() - t0
        if fleet.health()["live"] != FLEET_REPLICAS:
            raise AssertionError(f"fleet: {fleet.health()} after {FLEET_WAIT_S} s")
        router = FleetRouter(str(coord_dir), max_attempts=6, retry_base_delay_s=0.05)
        # the router's own cost: sequential requests on an idle fleet against
        # the in-process server's direct predict of the same graphs
        seq = []
        for g in graphs[:FLEET_OVERHEAD_REQUESTS]:
            a = time.perf_counter()
            router.route(g, deadline_s=FLEET_DEADLINE_S)
            seq.append({"ok": True, "t0": a, "t1": time.perf_counter()})
        routed = _latency(seq)
        out["router_overhead_ms"] = {"routed": routed, "direct_predict": direct,
                                     "p50_difference": routed["p50"] - direct["p50"]}
        pinned = _PinnedRouter(str(coord_dir), 0, max_attempts=6, retry_base_delay_s=0.05)
        load = _FleetLoad({"all": router, "one": pinned}, graphs,
                          max(FLEET_SWEEP + (FLEET_CLIENTS,)), 100)
        load.active = FLEET_SWEEP[0]
        load.start()

        # 1. steady state: at each client count, 2 replicas, then 1 (the
        # pinned router); a second's settling before each window
        out["requests_per_s"], out["steady_latency_ms"] = {}, {}
        for clients in FLEET_SWEEP:
            load.active = clients
            for route_by, replicas in (("all", "2"), ("one", "1")):
                load.route_by = route_by
                time.sleep(1.0)
                a = time.perf_counter()
                time.sleep(FLEET_WINDOW_S)
                rps, lat = load.window(a, time.perf_counter())
                out["requests_per_s"].setdefault(str(clients), {})[replicas] = rps
                out["steady_latency_ms"].setdefault(str(clients), {})[replicas] = lat
        load.active, load.route_by = FLEET_CLIENTS, "all"
        rps2 = out["requests_per_s"][str(FLEET_CLIENTS)]["2"]

        # 2. SIGKILL replica 1 mid-load: detected, respawned at incarnation 1
        load.phase = "kill"
        os.kill(fleet.replica_pid(1), signal.SIGKILL)
        t_kill = time.perf_counter()
        _wait(lambda: fleet.metrics.snapshot()["replica_respawns_total"] >= 1, "the respawn")
        out["kill"] = {"heal_s": time.perf_counter() - t_kill,
                       "incarnation": fleet._replicas[1].incarnation,
                       "last_recovery_seconds": fleet.metrics.snapshot()["last_recovery_seconds"]}
        if fleet._replicas[1].incarnation != 1:
            problems.append(f"replica 1 at incarnation {fleet._replicas[1].incarnation}")
        time.sleep(1.0)

        # 3. hot-swap promote to v2 under load
        load.phase = "swap"
        t_swap = time.perf_counter()
        res = fleet.promote("v2", path=str(ckdir), arch_config=cfg, name="pna",
                            timeout=FLEET_WAIT_S)
        t_swapped = time.perf_counter()
        out["promote_v2"] = {"status": res["status"], "propagated": res.get("propagated"),
                             "s": t_swapped - t_swap,
                             "compiles": {rid: {"first_pass": a.get("compiles"),
                                                "later_passes": a.get("later_pass_compiles")}
                                          for rid, a in res.get("acks", {}).items()}}
        if res["status"] != "promoted" or not res.get("propagated"):
            raise AssertionError(f"fleet: the v2 promote {res}")
        if any(a.get("compiles") != num_buckets or a.get("later_pass_compiles") != 0
               for a in res["acks"].values()):
            problems.append(f"promote compiles {res['acks']}, expected {num_buckets} each, "
                            "then 0")
        time.sleep(1.0)

        # 4. the corrupt candidate rolls back loudly; v2 keeps serving
        load.phase = "corrupt"
        res2 = fleet.promote("broken", path=str(ckdir), arch_config=cfg, name="pna",
                             timeout=FLEET_WAIT_S)
        out["promote_broken"] = {"status": res2["status"], "reason": res2.get("reason")}
        if res2["status"] != "rolled_back" or "corrupt" not in (res2.get("reason") or ""):
            problems.append(f"the corrupt candidate: {res2}")
        time.sleep(1.0)

        # 5. the canary: a far candidate rejected, a close one promoted
        load.phase = "canary"
        channel = CandidateChannel(str(workdir / "chan"))
        controller = CanaryController(fleet, channel, spec_path, gates=gates, poll_s=0.05,
                                      boot_timeout_s=FLEET_WAIT_S, promote_timeout_s=FLEET_WAIT_S)
        controller.attach(router)
        controller.start()
        decisions = []
        for name in ("other", "close"):
            man = channel.publish(name, str(ckdir))
            dec = controller.wait_decision(man["seq"], timeout=2 * FLEET_WAIT_S)
            dec["latency_ratio"] = controller.metrics.snapshot().get("latency_ratio")
            decisions.append(dec)
        t_canary = time.perf_counter()
        controller.stop()
        out["canary"] = decisions
        if decisions[0]["verdict"] != "rejected" or "head_mae" not in decisions[0]["reason"]:
            problems.append(f"the far candidate: {decisions[0]}")
        if decisions[1]["verdict"] != "promoted":
            problems.append(f"the close candidate: {decisions[1]}")

        # 6. one autoscaler tick under load adds a replica
        load.phase = "autoscale"
        w = FLEET_DRIFT["WINDOW"]
        fleet.extra_env.update(HYDRAGNN_FAULT_SHIFT_INPUTS=f"{w}:{3 * w}@{FLEET_SHIFT}",
                               HYDRAGNN_FAULT_SHIFT_REPLICA=str(FLEET_REPLICAS))
        policy = AutoscalePolicy(min_replicas=1, max_replicas=FLEET_REPLICAS + 1,
                                 capacity_rps=max(rps2 / 3.0, 1e-3))
        scaler = FleetAutoscaler(fleet, router.autoscale_signals, policy=policy)
        scaler.tick()
        time.sleep(2.0)
        decision = scaler.tick()
        out["autoscale"] = decision
        if fleet.target != FLEET_REPLICAS + 1:
            raise AssertionError(f"fleet: the autoscaler's tick {decision}")
        _wait(lambda: load.done(lambda r: r["ok"] and r["replica"] == FLEET_REPLICAS),
              "an answer from the new replica")

        # 7. drift on the new replica: its shifted windows raise, clean ones clear
        load.phase = "drift"
        stream = str(coord_dir / f"events-replica{FLEET_REPLICAS}.jsonl")

        def statuses():
            return {a["status"] for a in _events(stream, "drift_alert")}

        _wait(lambda: statuses() == {"raised", "cleared"}, "the drift alert raised and cleared")
        time.sleep(0.5)
        load.stop()
        t_end = time.perf_counter()

        done = load.done()
        ok = [r for r in done if r["ok"]]
        retried = int(router.fleet_metrics.snapshot()["retries_total"])
        out["requests"] = {"submitted": len(done) + len(load.failures), "succeeded": len(ok),
                           "shed": len(done) - len(ok), "failed": len(load.failures),
                           "retried": retried, "availability": len(ok) / max(len(done), 1)}
        if load.failures:
            problems.append(f"{len(load.failures)} lost requests: {load.failures[:3]}")
        # steady: the windows at FLEET_CLIENTS clients, through 2 replicas and 1
        out["latency_ms"] = {p: _latency(load.done(
            lambda r, p=p: r["phase"] == p and (p != "steady" or r["clients"] == FLEET_CLIENTS)))
            for p in ("steady", "kill", "swap", "canary", "drift")}
        # no micro-batch mixes versions: one version per (replica, batch) in the swap
        mixed = {}
        for r in load.done(lambda r: r["ok"] and r["phase"] == "swap"):
            mixed.setdefault((r["replica"], r["batch_seq"]), set()).add(r["version"])
        if any(len(v) > 1 for v in mixed.values()):
            problems.append("a micro-batch mixed versions")
        held, shifted, worst, by_weights = _hold_answers(load, refs, watch.sources, FLEET_REPLICAS)
        out["answers"] = {"held": held, "shifted_held": shifted, "by_weights": by_weights,
                          "worst_error_over_tolerance": worst}
        # the weights each stretch may answer from: v1 before the swap, v2
        # (or the close candidate, once its swap starts) after it, then close
        for r in load.done(lambda r: r["ok"]):
            name = os.path.basename(watch.sources[(r["replica"], r["version"])])
            allowed = ({"v1"} if r["t1"] < t_swap else {"v2", "close"}
                       if t_swapped < r["t0"] < t_canary else {"close"}
                       if r["t0"] > t_canary else {"v1", "v2", "close"})
            if name not in allowed:
                problems.append(f"a {r['phase']} answer from {name}")
                break
        if shifted < 2 * w:
            problems.append(f"{shifted} shifted answers held, expected {2 * w} or more")
        keys = ("feature", "head", "kind", "score", "status", "version")
        out["drift"] = {
            "replica": FLEET_REPLICAS, "windows": len(_events(stream, "drift_window")),
            "alerts": [{k: a[k] for k in keys} for a in _events(stream, "drift_alert")],
            # the others' alerts: a promote's reference holds the old version's answers
            "other_replicas_alerts": {
                p.name: [{k: a[k] for k in keys} for a in _events(str(p), "drift_alert")]
                for p in sorted(coord_dir.glob("events-replica*.jsonl")) if str(p) != stream}}
        fleet.emit("fleet_report", submitted=out["requests"]["submitted"],
                   succeeded=len(ok), availability=round(out["requests"]["availability"], 6),
                   shed=out["requests"]["shed"], retried=retried,
                   p50_ms=out["latency_ms"]["steady"]["p50"],
                   p99_ms=out["latency_ms"]["steady"]["p99"],
                   kill_heal_s=round(out["kill"]["heal_s"], 3))
        out["load_s"] = t_end - t0
    finally:
        if load is not None:
            load.stop()
        if controller is not None:
            controller.stop()
        fleet.stop()
        watch.halt.set()
        watch.join(5)
    out["device_work"], out["launches"] = _device_work(coord_dir, cfg, device, problems)
    out["boot_s"] = watch.boot_s()
    out["canary_boot_s"] = {}
    out["heartbeat_gap_max_s"] = {"s": watch.gap[0], "lease": watch.gap[1]}
    # the whole event stream: the supervisor's (the controller emits there
    # too), every replica's and every canary's
    recs = validate_events(str(workdir / "log" / "events.jsonl"), require=[
        "replica_lost", "replica_respawned", "fleet_degraded", "model_promoted",
        "model_rollback", "canary_started", "canary_rejected", "canary_promoted",
        "fleet_scaled", "fleet_report"])
    for ev in recs:
        if ev["event"] == "replica_respawned":
            out["kill"]["downtime_s"] = ev["downtime_s"]
        if ev["event"] == "canary_started":
            key = str(ev["candidate"])
            first = watch.first_serving.get((fleet_mod.CANARY, ev["candidate"], 0))
            out["canary_boot_s"][key] = None if first is None else first - ev["ts"]
    streams = sorted(coord_dir.glob("events-*.jsonl"))
    for p in streams:
        validate_events(str(p))
    out["event_streams"] = [p.name for p in streams]
    out["events"] = {k: sum(1 for r in recs if r["event"] == k) for k in sorted(
        {r["event"] for r in recs})}
    lost = [r for r in recs if r["event"] == "replica_lost"]
    if [r["replica"] for r in lost] != [1] or lost[0]["reason"] != "exit_-9":
        problems.append(f"replica_lost events {lost}")
    return out


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
        self.captured = False

    def __call__(self, x):
        site = self.calls
        self.calls += 1
        if self.record:
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                # a captured step: the graph's own copy, which its replay
                # fills (the capture's warm-up records go: they are a
                # different run of the same step); read with card_inputs()
                if not self.captured:
                    self.inputs, self.captured = [], True
                self.inputs.append(x.detach().clone())
            else:
                self.inputs.append(x.detach().to("cpu", torch.float64, copy=True))
            return F.relu(x)
        return _KinkReLU.apply(x, self, site)

    def card_inputs(self):
        """The recorded inputs on the host, in float64 (after the replay
        that fills a captured step's)."""
        return [t.to("cpu", torch.float64) for t in self.inputs]

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


def _graph_tensors(batch):
    """The batch's tensors but its neighbour lists (``extras``), by name."""
    names, tensors = batch.leaves()
    return {n: t for n, t in zip(names, tensors) if not n.startswith("extras.")}


def _same_start(model, host, first):
    """Whether ``model``'s weights and statistics and ``host``'s graphs
    equal, bit for bit, those that ``first`` recorded."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    graphs = _graph_tensors(host)
    return (state.keys() == first["state"].keys() and graphs.keys() == first["graphs"].keys()
            and all(torch.equal(state[k], first["state"][k]) for k in state)
            and all(torch.equal(graphs[k], first["graphs"][k]) for k in graphs))


def cpu_references(model, host, bf16=False, reversed_host=None, kinks=None, shared=None):
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
    :func:`kink_flips` and :func:`exact_with_flips`.

    With ``shared`` (a dict kept across one stack's runs), the float64
    step is taken once, by the first run, and the others reuse it: each
    later run's model must start from the same weights and statistics and
    its batch hold the same graphs, bit for bit (its branch's neighbour
    lists aside), else it raises. The branches compute one function; their
    float64 steps, through different plain versions, agree to float64's
    rounding (in a parameter, to what AdamW's first step makes of a
    gradient that is rounding noise)."""
    if bf16 and reversed_host is None:
        raise ValueError("a bf16 step needs its second witness: pass reversed_host")
    witness = copy.deepcopy(model).cpu()
    start = copy.deepcopy(witness)
    second = None if reversed_host is None else copy.deepcopy(witness)
    if shared:
        if not _same_start(model, host, shared):
            raise AssertionError("the shared float64 step: another start or other graphs")
        f64, loss64, z64 = shared["exact"]
    else:
        f64, z64 = copy.deepcopy(witness).double(), KinkReLUs()
        z64.install(f64)  # its inputs serve every f32 run of the stack
        with float64_port(), Float32Watch() as watch:
            loss64 = cpu_step(f64, as_float64(host))
        if watch.seen:
            raise AssertionError(f"float32 in the float64 step: {sorted(watch.seen)}")
        z64.remove(f64)
        if shared is not None:
            shared.update(exact=(f64, loss64, z64), graphs=_graph_tensors(host),
                          state={k: v.detach().cpu().clone()
                                 for k, v in model.state_dict().items()})
    record = kinks is not None and not bf16
    z32 = KinkReLUs()
    if record:
        z32.install(witness)
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
    (``train_step.forward``, ``.backward``, ``.optimizer``, ``replay``: a
    captured program's graph, whose kernels the graph's launch issued;
    else ``other``) whose range on the host holds the call that launched it (matched by
    correlation id; the backward's launches come from autograd's thread
    while the main thread waits inside the backward range)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges = [
        (ev["ts"], ev["ts"] + ev.get("dur", 0),
         "replay" if ev["name"].startswith("replay.") else ev["name"]) for ev in events
        if ev.get("cat") == "user_annotation"
        and (ev.get("name") in TRAIN_PHASES or ev.get("name", "").startswith("replay."))
    ]
    launched_at = {
        ev["args"]["correlation"]: ev["ts"] for ev in events
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {})
    }
    by_phase = {name: 0.0 for name in TRAIN_PHASES + ("replay", "other")}
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


def replay_split(path):
    """``{program: [device ms, device ops]}`` of a profiled trace, each
    kernel, copy and fill put in the captured program whose
    ``replay.<name>`` range on the host launched it (as
    :func:`split_trace` matches them); ``other`` for the rest."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges = [(ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"][len("replay."):])
              for ev in events if ev.get("cat") == "user_annotation"
              and ev.get("name", "").startswith("replay.")]
    launched_at = {
        ev["args"]["correlation"]: ev["ts"] for ev in events
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {})
    }
    out = {}
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched_at.get(ev.get("args", {}).get("correlation"))
        name = next((n for lo, hi, n in ranges if t is not None and lo <= t <= hi), "other")
        row = out.setdefault(name, [0.0, 0])
        row[0] += ev.get("dur", 0.0) / 1e3
        row[1] += 1
    return out


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
    port's ``bench_model``: 1 warm step (the step's capture, then a
    replay), 20 replays between CUDA events, one ``eval_step``, one
    profiled replay, then the same body eagerly (1 + 20 steps:
    ``eager_ms_per_step``); every step, warm-up and evaluation
    launch what :func:`launches_per_train_step` and
    :func:`launches_per_forward` say (the row's mode: ``dense`` with the
    lists, else ``bench_model``'s ``segment``). The CPU rehearsal runs the
    row at the tiny size. Prints one ``{"train": ...}`` line; returns it."""
    on_card = device.type == "cuda"
    kw = dict(row) if on_card else dict(
        row, hidden=size["hidden"], num_graphs=size["batch"],
        nodes=size["nodes"], degree=size["degree"], layers=size["layers"])
    iters = HEADLINE_ITERS if on_card else 2
    trace = _build.REPO_ROOT / "build" / "chip_smoke" / f"bench_{name}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    reset_launch_counts()
    before = capture_counts()
    result = bench_model(**kw, iters=iters, device=device, trace_path=trace if on_card else None)
    counts = launch_counts()
    warm = {k: capture_counts()[k] - before[k] for k in ("warm_steps", "warm_forwards")}
    cfg = _arch(kw["model_type"], kw["hidden"], kw["layers"], kw["nodes"])
    mode = "dense" if kw.get("dense") else "segment"
    per_step = launches_per_train_step(cfg, mode)
    per_eval = launches_per_forward(cfg, mode)
    # the captured steps (and the capture's warm-up step), the eager ones,
    # and the captured eval (and its warm-up forward)
    n_steps = result["captured_steps"] + warm["warm_steps"] + result["eager_steps"]
    n_evals = 1 + warm["warm_forwards"]
    if on_card and counts != {k: n_steps * v + n_evals * per_eval[k]
                              for k, v in per_step.items()}:
        raise AssertionError(f"{name}: {n_steps} steps and {n_evals} evals launched {counts}")
    if not np.isfinite(result["eval_loss"]):
        raise AssertionError(f"{name}: eval loss {result['eval_loss']}")
    result = {"config": name, **result,
              "launches_per_replay": {k: v for k, v in per_step.items() if v}}
    if on_card:
        result.update(trace_split(trace, result["ms_per_step"]))
    result.update(launches=counts, card=card)
    emit({"train": result})
    return result


def phase_train(mode, cfg, plan, graphs, device, card, bf16=False, windows=TRAIN_WINDOWS,
                step1_graphs=None, step1_bucket=None, shared=None):
    """Training of ``cfg``'s stack through the port's entry points:
    ``Trainer`` -> ``init_state`` -> ``put_batch`` -> 1 + ``windows`` x 4
    ``train_step`` (AdamW; with ``bf16``, bf16 mixed precision) -> one
    profiled step -> ``eval_step``, on the largest bucket's batch
    (``dense``: with the neighbour lists). With ``step1_graphs``, step 1,
    the one held against the CPU, takes the first ``step1_graphs`` graphs
    of that batch only (the CPU's float64 step at the full batch is most
    of the phase's time for the last four stacks); with ``step1_bucket``,
    the batch of that bucket of ``plan``. ``shared``: the stack's float64
    step, taken by its first run (:func:`cpu_references`). Returns the
    kernel launches of the run."""
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
    cpu, exact = cpu_references(model, host1, bf16, reversed_host, kinks=kinks, shared=shared)
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

    def steps(n, on=None, prepare=False):
        """``n`` captured steps (a new shape captures first: its warm-up
        step runs eagerly and counts; ``prepare``: the capture alone),
        their launches held to the steps the card ran."""
        nonlocal state
        reset_launch_counts()
        warm0 = capture_counts()["warm_steps"]
        losses = []
        if prepare:
            trainer.prepare_step(state, batch)
        for _ in range(n):
            state, met = trainer.train_step(state, batch if on is None else on)
            losses.append(met["loss"])
        counts = launch_counts()
        ran = n + capture_counts()["warm_steps"] - warm0
        if on_card and counts != {k: ran * v for k, v in per_step.items()}:
            raise AssertionError(f"{what} train: {ran} steps launched {counts}, "
                                 f"expected {per_step} per step")
        for k, v in counts.items():
            launches[k] += v
        return losses

    # step 1 records the card's ReLU inputs (for kink_flips), then the
    # model's own ReLU is back, and the timed steps capture afresh
    card_acts = None if bf16 else KinkReLUs()
    if card_acts is not None:
        card_acts.install(model)
    first = steps(1, on=trainer.put_batch(host1))[0]
    step1 = snapshot(model)
    if card_acts is not None:
        card_acts.remove(model)
        card_acts.inputs = card_acts.card_inputs()
        trainer.release()
    steps(0, prepare=True)  # the timed windows replay only

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
    warm0 = capture_counts()["warm_forwards"]
    ev = trainer.eval_step(state, batch)  # captured: its warm-up forward, then the replay
    counts = launch_counts()
    ran = 1 + capture_counts()["warm_forwards"] - warm0
    if on_card and counts != {k: ran * v for k, v in launches_per_forward(cfg, mode).items()}:
        raise AssertionError(f"{what} eval: {ran} forwards launched {counts}")
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
    trainer.release()
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


# ---- phase 7: capture ------------------------------------------------------------


def hold_update(cap, eagers, start, lr, rel):
    """A replayed step's parameter updates against two eager steps' from
    the same state: within ``rel`` relative plus ``1e-2 lr`` where the
    eager gradient is above ``1e-3`` of its tensor's largest, within
    ``2 lr`` below it (Adam's update there is ``lr`` times a sign that
    rounding can flip), each plus 4 times the two eager steps' own spread
    (the atomics' order; Adam's first moment cancels over the steps, so an
    update's relative error can exceed its gradient's). Returns the
    largest update of the replay."""
    first, second = (dict(m.named_parameters()) for m in eagers)
    moved = 0.0
    for name, p in cap.named_parameters():
        q = first[name]
        du, de = (p - start[name]).double(), (q - start[name]).double()
        spread = float((de - (second[name] - start[name]).double()).abs().max())
        ge = q.grad.double().abs()
        sure = ge > 1e-3 * float(ge.max())
        bound = rel * de.abs() + 1e-2 * lr + 4 * spread
        bad = ((du - de).abs() > bound)[sure].any() or \
            ((du - de).abs()[~sure] > 2 * lr + 4 * spread).any()
        if bool(bad):
            worst = float(((du - de).abs() - bound)[sure].max()) if bool(sure.any()) else None
            raise AssertionError(f"replayed update of {name} differs from the eager one "
                                 f"(worst excess {worst}, lr {lr}, eager spread {spread})")
        moved = max(moved, float(du.abs().max()))
    return moved


def phase_capture(plan, graphs, device, card, served, benched):
    """Phase 7: the captured programs (module docstring). (a) and (b)
    summarise phases 4 and 5; (c) replays PNA at the training batch in
    ``fused``, ``segment`` and dense bf16 under
    ``torch.cuda.set_sync_debug_mode("error")``, then lowers the learning
    rate tenfold and holds the replayed update against an eager step at
    the new rate (:func:`hold_update`)."""
    emit({"capture": {"serve_compiles": [
        {"family": r["family"], "mode": r["mode"], "buckets": plan.num_buckets,
         "compiles_total": r["compiles_total"], "warm_version": r["warm_version"]}
        for r in served]}})
    emit({"capture": {"bench_rows": [
        {k: r.get(k) for k in ("config", "ms_per_step", "eager_ms_per_step",
                               "device_busy_share", "device_ops_per_step",
                               "launches_per_replay")} for r in benched], "card": card}})
    if device.type != "cuda":
        return
    cfg = dict(arch(FULL, "PNA"), num_conv_layers=FIVE_TRAIN_LAYERS)
    for mode, bf16 in (("fused", False), ("segment", False), ("dense", True)):
        model = create_model_config(cfg, device=device, aggregation=aggregation_of(mode), seed=0)
        host = train_batch(plan, graphs, cfg, dense=mode == "dense")
        trainer = Trainer(model, train_config(bf16))
        state, _ = trainer.train_step(trainer.init_state(host), host)  # the captures
        trainer.eval_step(state, host)
        dev = trainer.put_batch(host)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for b in (host, dev, host):
                state, met = trainer.train_step(state, b)
                trainer.eval_step(state, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        lr = get_learning_rate(state.optimizer) / 10
        set_learning_rate(state.optimizer, lr)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        twins = []
        for _ in range(2):  # eager twins: copies of the model and the optimizer's state
            twin = copy.deepcopy(model)
            twin_opt = select_optimizer(train_config(bf16), twin)
            for p, q in zip(model.parameters(), twin.parameters()):
                twin_opt.state[q] = {k: v.clone() for k, v in state.optimizer.state[p].items()}
            set_learning_rate(twin_opt, lr)
            twin_state = dataclasses.replace(state, model=twin, optimizer=twin_opt)
            _, tmet = train_steps.train_step(twin_state, trainer.put_batch(host),
                                             mixed=trainer.precision["mixed"],
                                             generator=trainer.generator)
            twins.append(twin)
        state, met = trainer.train_step(state, host)
        moved = hold_update(model, twins, start, lr, rel=1e-2 if bf16 else 1e-3)
        counts = trainer.programs(state).counts()
        emit({"capture": {"family": "PNA", "mode": mode, "precision": "bf16" if bf16 else "f32",
                          "replays_without_host_sync": 3, "lr_after": lr,
                          "largest_update_after": moved,
                          "loss": float(met["loss"]), "eager_loss": float(tmet["loss"]),
                          "programs": counts, "card": card}})
        if moved > 5 * lr:
            raise AssertionError(f"PNA {mode}: a replay moved a parameter by {moved} at lr {lr}")
        if counts["train_step"]["captures"] != 1 or counts["eval_step"]["captures"] != 1:
            raise AssertionError(f"PNA {mode}: programs {counts}")
        trainer.release()


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


CFG_ALAT = 3.52  # FCC Ni's lattice constant, Angstrom (the JAX package's examples/eam)
CFG_NI, CFG_NB = 28, 41


def fcc_scaled(cells):
    """The scaled coordinates (in [0, 1)) of ``cells``^3 FCC unit cells:
    4 atoms each."""
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], np.float64)
    grid = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"), -1).reshape(-1, 1, 3)
    return (grid + basis[None]).reshape(-1, 3) / cells


def eam_energy(z, pos):
    """An embedded-atom flavour of formation energy a site: ``F(rho_i) =
    -sqrt(rho_i) + 0.05 rho_i``, ``rho_i`` the other atoms' density
    ``exp(-d / 2.5)``, Nb's weighted 1.6 (the JAX package's example)."""
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    rho = (np.exp(-d / 2.5) * np.where(z == CFG_NI, 1.0, 1.6)[None, :]).sum(1)
    return float((-np.sqrt(rho) + 0.05 * rho).sum() / len(z))


def write_cfg_data(path, number_configurations, cells=3, seed=0):
    """NiNb solid solutions in the AtomEye ``.cfg`` format, each with its
    energy in a sibling ``.bulk`` file: ``cells``^3 FCC cells at
    :data:`CFG_ALAT` (108 atoms at 3), a Ni share drawn per configuration
    in [0.3, 0.9], the scaled coordinates jittered by N(0, 0.004), the
    ``H0`` supercell matrix, and mass and symbol lines before each atom's
    row, sorted by species (the layout of the JAX package's
    ``examples/eam``, written here from ``seed``)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    scaled = fcc_scaled(cells)
    n = len(scaled)
    cell = np.eye(3) * CFG_ALAT * cells
    for c in range(number_configurations):
        z = np.where(rng.random(n) < rng.uniform(0.3, 0.9), CFG_NI, CFG_NB)
        jitter = scaled + rng.normal(0, 0.004, scaled.shape)
        lines = [f"Number of particles = {n}", "A = 1.0 Angstrom"]
        lines += [f"H0({i + 1},{j + 1}) = {cell[i, j]:.6f} A" for i in range(3) for j in range(3)]
        lines += [".NO_VELOCITY.", "entry_count = 3"]
        for i in np.argsort(z, kind="stable"):
            ni = z[i] == CFG_NI
            lines += ["58.693" if ni else "92.906", "Ni" if ni else "Nb",
                      f"{jitter[i, 0]:.6f} {jitter[i, 1]:.6f} {jitter[i, 2]:.6f}"]
        base = os.path.join(path, f"config{c}")
        with open(base + ".cfg", "w") as f:
            f.write("\n".join(lines))
        with open(base + ".bulk", "w") as f:
            f.write(f"{eam_energy(z, jitter @ cell):.8f}\n")


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
    split's order. ``mode`` None: the branch the loaders' layout took
    (``dense`` where the batches carry the lists)."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.data.loaders import dataset_loading_and_splitting

    train_l, val_l, test_l = dataset_loading_and_splitting(copy.deepcopy(config))
    if mode is None:  # the branch the data path chose (the static dense policy)
        mode = "dense" if getattr(train_l.layout, "need_neighbors", False) else "segment"
    reset_launch_counts()
    reset_capture_counts()
    t0 = time.perf_counter()
    state = run_training(copy.deepcopy(config), device=device)
    t1 = time.perf_counter()
    error, tasks, true_values, predicted = run_prediction(copy.deepcopy(config), device=device)
    t2 = time.perf_counter()
    counts = launch_counts()
    arch = dict(config["NeuralNetwork"]["Architecture"], equivariance=False)
    history = state.info["history"]
    chunk = int(config["NeuralNetwork"]["Training"].get("fit_chunk_epochs", 0))
    # a chunk replays all its padded epochs, those after a stop included
    epochs = chunk * len({h["chunk"] for h in history}) if chunk else len(history)
    steps = epochs * len(train_l)
    forwards = epochs * (len(val_l) + len(test_l)) + len(test_l)
    per_step, per_forward = launches_per_train_step(arch, mode), launches_per_forward(arch, mode)
    # every program's capture ran its body once eagerly first (warm-up)
    programs = capture_counts()
    expected = {k: (steps + programs["warm_steps"]) * per_step[k]
                + (forwards + programs["warm_forwards"]) * per_forward[k] for k in KERNELS}
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"run_training ({mode}): launched {counts}, expected {expected} "
                             f"({steps} steps, {forwards} forwards, programs {programs})")
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
        "steps": steps, "forwards": forwards, "programs": programs,
        "launches": {k: v for k, v in counts.items() if v},
        "launches_per_train_step": {k: v for k, v in per_step.items() if v},
        "launches_per_forward": {k: v for k, v in per_forward.items() if v},
        "checkpoint_bytes": save["bytes"],
        "checkpoint_save_s": save["snapshot_s"] + save["write_s"],
        "error": error, "head_error": [float(t) for t in tasks],
        "sample_mae": [float(np.abs(t - p).mean()) for t, p in zip(true_values, predicted)],
        "run_training_s": t1 - t0, "run_prediction_s": t2 - t1,
        "graphs": [len(train_l.dataset), len(val_l.dataset), len(test_l.dataset)],
        "branch": mode,
    }
    if chunk:
        line.update(epochs_dispatched=epochs, chunks=len({h["chunk"] for h in history}),
                    chunk_readbacks=state.info["fit_readbacks"],
                    ms_per_epoch=[1e3 * h["epoch_s"] for h in history])
        if state.info["fit_readbacks"] != line["chunks"]:
            raise AssertionError(f"run_training ({mode}): {state.info['fit_readbacks']} "
                                 f"readbacks for {line['chunks']} chunks")
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
    """Two more epochs of ``state`` in the run's mode (streaming with its
    ``steps_per_dispatch`` and ``device_prefetch``, or staged), the second
    under the profiler, after the first captured its programs: the epoch's
    wall and the device's busy share (device time of its kernels, copies
    and fills over the wall)."""
    from torch.profiler import ProfilerActivity, profile

    training = config["NeuralNetwork"]["Training"]
    trainer = Trainer(state.model, training)
    if training.get("device_resident_dataset"):
        staged = trainer.stage_batches(list(train_l))
        epoch = lambda: trainer.train_epoch_staged(state, staged)  # noqa: E731
    else:
        epoch = lambda: trainer.train_epoch(state, train_l)  # noqa: E731
    train_l.set_epoch(MULTIHEAD_TRAINING["num_epoch"])
    epoch()
    trace = _build.REPO_ROOT / "build" / "chip_smoke" / f"run_training_{name}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    by_phase, _, _, ops = split_trace(trace)
    device_s = sum(by_phase.values()) / 1e3
    trainer.release()
    return {"profiled_epoch_s": wall, "profiled_device_s": device_s or "not measured",
            "device_busy_share": device_s / wall if device_s else "not measured",
            "profiled_device_ops": ops,
            "profiled_ms_per_step": 1e3 * wall / len(train_l)}


# the four runs: (config, label, environment, Training keys, branch); the
# multi-head runs at MXU_HEADLINE's width take the new dispatch modes
RUNS = (
    ("ci.json", "streaming", {}, {}, "segment"),
    ("ci.json", "device_resident", {}, {"device_resident_dataset": True}, "segment"),
    ("ci_multihead.json", "default_k4_prefetch2", {},
     {"steps_per_dispatch": 4, "device_prefetch": 2}, "dense"),
    ("ci_multihead.json", "fused_device_resident", {"HYDRAGNN_AGG": "fused"},
     {"device_resident_dataset": True}, "fused"),
)


def phase_run_training(device, card, rehearsal):
    """``run_training`` and ``run_prediction`` through the port's entry
    points (module docstring, phase 6) in the four modes of :data:`RUNS`;
    one ``{"run_training": ...}`` line per run. Returns the launches."""
    root = _build.REPO_ROOT / "build" / "chip_smoke" / "run_training"
    if root.exists():
        import shutil

        shutil.rmtree(root)
    data = root / "data"
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for name, label, env, training, mode in RUNS:
        ci = name == "ci.json"
        configs = (RUN_REHEARSAL["ci_configs" if ci else "multihead_configs"] if rehearsal
                   else CI_CONFIGS if ci else MULTIHEAD_CONFIGS)
        config = ci_config(name, data, configs, rehearsal)
        config["NeuralNetwork"]["Training"].update(training)
        if rehearsal and mode == "dense":  # hidden 8 is below the dense policy's width
            mode = "segment"
        with run_directory(root / f"{name.split('.')[0]}_{label}", env):
            state, counts, line, (train_l, test_l, predicted) = run_and_predict(
                config, device, mode)
            add(counts)
            serve_counts, served = serve_checkpoint(state.info["log_name"], test_l, predicted,
                                                    mode == "dense", device)
            path = {k for k, v in launches_per_forward(config["NeuralNetwork"]["Architecture"],
                                                       mode).items() if v}
            if device.type == "cuda" and {k for k, v in serve_counts.items() if v} != path:
                raise AssertionError(f"serving ({name} {label}) launched {serve_counts}, "
                                     f"not {path}")
            add(serve_counts)
            if device.type == "cuda":
                served.update(profiled_epoch(state, config, train_l, device,
                                             f"{name.split('.')[0]}_{label}"))
        result = {"config": name, "mode": label, "model": "PNA",
                  "width": config["NeuralNetwork"]["Architecture"]["hidden_dim"],
                  "branch": mode, "env": env, "training": training}
        if ci:
            mae_ok = all(m < CI_CEILINGS[1] for m in line["sample_mae"])
            err_ok = all(e < CI_CEILINGS[0] for e in line["head_error"] + [line["error"]])
            if not rehearsal and not (mae_ok and err_ok):
                raise AssertionError(f"ci.json PNA ({label}) misses its ceilings "
                                     f"{CI_CEILINGS}: {line}")
            result.update(ceilings=CI_CEILINGS, ceilings_met=mae_ok and err_ok)
        emit({"run_training": {**result, **line, **served,
                               "serve_launches": {k: v for k, v in serve_counts.items() if v},
                               "card": card}})
    return launches


# ---- phase 6, continued: whole runs, the guard and the sentinel -------------

FIT_CONFIGS = 300  # tests/test_graphs.py:240-257: PNA's whole-training dispatch
FIT_CHUNK = 10  # its fit_chunk_epochs
FIT_SYNC_CHUNKS = 3  # chunks queued under set_sync_debug_mode("error")
# tests/test_graphs.py:24-34: each head's error, then each head's sample MAE
THRESHOLDS = {"SAGE": (0.20, 0.20), "PNA": (0.20, 0.20), "MFC": (0.20, 0.20),
              "GIN": (0.25, 0.20), "GAT": (0.60, 0.70), "CGCNN": (0.50, 0.40),
              "SchNet": (0.20, 0.20), "DimeNet": (0.50, 0.50), "EGNN": (0.20, 0.20)}
OTHER_STACKS = ("GIN", "SAGE", "MFC", "GAT", "CGCNN", "SchNet", "DimeNet", "EGNN")
GUARD_NAN_STEPS = "5,40"  # HYDRAGNN_FAULT_NAN_AT_STEP of the guarded run: two steps
GUARD_COST_STEPS = 50


def ceilings(model_type, line):
    """``tests/test_graphs.py``'s rule: every head's error and the total
    below the first ceiling, every head's sample MAE below the second."""
    err, mae = THRESHOLDS[model_type]
    return (all(e < err for e in line["head_error"] + [line["error"]])
            and all(m < mae for m in line["sample_mae"]))


def fit_meta(log_name):
    """The final checkpoint's ``train_meta``."""
    from hydragnn_tpu_torch.train import checkpoint

    return checkpoint.pop_train_meta(checkpoint.load_state_dict(log_name, fallback=False))


def host_decisions(history, training, meta):
    """The host trackers (``ReduceLROnPlateau``, ``EarlyStopping``,
    ``BestCheckpoint``'s rule) run again over the chunked run's validation
    series: their rates, stop and best epoch against the device tail's
    (the series' rates, the last epoch with the stop flag, the epoch whose
    loss is ``fit_sched.best_val``). Exact: the same inputs."""
    from hydragnn_tpu_torch.train.scheduler import EarlyStopping, ReduceLROnPlateau

    plateau = ReduceLROnPlateau(lr=float(np.float32(training["Optimizer"]["learning_rate"])))
    early = EarlyStopping(training.get("patience", 5)) if training.get("EarlyStopping") else None
    warmup = training.get("checkpoint_warmup", 10)
    rates, stop, best, best_epoch = [], None, None, None
    for h in history:
        rates.append(float(np.float32(plateau.step(h["val_loss"]))))
        if h["epoch"] >= warmup and (best is None or h["val_loss"] < best):
            best, best_epoch = h["val_loss"], h["epoch"]
        if early is not None and early(h["val_loss"]) and stop is None:
            stop = h["epoch"]
    device_rates = [float(np.float32(h["lr"])) for h in history]
    best_val = float(meta["fit_sched"]["best_val"])
    device_best = next((h["epoch"] for h in history
                        if h["epoch"] >= warmup and np.float32(h["val_loss"]) == best_val), None)
    device_stop = history[-1]["epoch"] if bool(meta["fit_sched"]["stopped"]) else None
    out = {"rates_equal": rates == device_rates, "stop_epoch": device_stop,
           "host_stop_epoch": stop, "best_epoch": device_best, "host_best_epoch": best_epoch,
           "rate_drops": len(set(device_rates)) - 1}
    out["equal"] = (out["rates_equal"] and stop == device_stop and best_epoch == device_best)
    return out


def profiled_chunk(state, config, loaders, device, name):
    """Chunks of the run's state through a new trainer: one to capture,
    one under the profiler (its wall, the device's busy share, ms an
    epoch, each program's device time and ops an epoch), then :data:`FIT_SYNC_CHUNKS` queued under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside one
    raises), each read back after; one readback a chunk."""
    from torch.profiler import ProfilerActivity, profile

    training = config["NeuralNetwork"]["Training"]
    chunk = training["fit_chunk_epochs"]
    trainer = Trainer(state.model, training)
    staged, val, test = (trainer.stage_batches(list(ld)) for ld in loaders)
    fit = lambda: trainer.fit_staged(state, staged, chunk, staged_val=val,  # noqa: E731
                                     staged_test=test)
    fit()
    trace = _build.REPO_ROOT / "build" / "chip_smoke" / f"run_training_{name}_chunk_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        series = fit()[3]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    by_phase, _, _, ops = split_trace(trace)
    device_s = sum(by_phase.values()) / 1e3
    by_program = {name: {"device_ms_per_epoch": ms / chunk, "device_ops_per_epoch": n / chunk}
                  for name, (ms, n) in replay_split(trace).items()}
    dispatch_s = []
    for _ in range(FIT_SYNC_CHUNKS):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            trainer.fit_dispatch(state, staged, chunk, staged_val=val, staged_test=test)
            dispatch_s.append(time.perf_counter() - t0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        trainer.fit_read(state)
    readbacks = trainer.fit_readbacks
    trainer.release()
    if readbacks != 2 + FIT_SYNC_CHUNKS:
        raise AssertionError(f"{readbacks} readbacks for {2 + FIT_SYNC_CHUNKS} chunks")
    return {"profiled_chunk_s": wall, "profiled_ms_per_epoch": 1e3 * wall / chunk,
            "profiled_device_s": device_s or "not measured",
            "device_busy_share": device_s / wall if device_s else "not measured",
            "profiled_device_ops": ops, "profiled_by_program": by_program,
            "profiled_ms_per_step": 1e3 * wall / (chunk * len(loaders[0])),
            "profiled_train_loss_finite": bool(np.isfinite(series["train_loss"]).all()),
            "sync_free_chunks": FIT_SYNC_CHUNKS, "host_queue_s_per_chunk": dispatch_s,
            "profiled_readbacks": readbacks, "profiled_chunks": 2 + FIT_SYNC_CHUNKS}


def guard_cost(state, config, loader, device):
    """The guard's cost a step on the run's first batch: captured steps
    with the guard (the pre-step copy into its buffers, the step with its
    ``finite`` reduction, the scalar read back) against the same steps
    without it, :data:`GUARD_COST_STEPS` each, host clock to a sync, in
    turns (without, with, with, without)."""
    training = config["NeuralNetwork"]["Training"]
    model, optimizer = copy.deepcopy((state.model, state.optimizer))
    bare = dict(training, divergence_guard=False)
    trainers = {"bare": Trainer(model, bare), "guarded": Trainer(model, dict(
        training, divergence_guard=True))}
    st = dataclasses.replace(state, model=model, optimizer=optimizer, info={})
    batch = next(iter(loader))
    for trainer in trainers.values():
        trainer.train_step(st, batch)  # capture
    trainers["guarded"].guard.snapshot(st)  # its buffers, allocated once

    def run(kind):
        trainer = trainers[kind]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GUARD_COST_STEPS):
            if kind == "guarded":
                prev = trainer.guard.snapshot(st)
                _, met = trainer.train_step(st, batch)
                if not bool(met["finite"]):
                    trainer.guard.on_bad_step(st, prev)
            else:
                trainer.train_step(st, batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / GUARD_COST_STEPS

    ms = {"bare": [], "guarded": []}
    for kind in ("bare", "guarded", "guarded", "bare"):
        ms[kind].append(run(kind))
    for trainer in trainers.values():
        trainer.release()
    bare_ms, guarded_ms = min(ms["bare"]), min(ms["guarded"])
    return {"ms_per_step_bare": ms["bare"], "ms_per_step_guarded": ms["guarded"],
            "guard_ms_per_step": guarded_ms - bare_ms}


def sentinel_check(state, config, loader):
    """One poisoned step under ``HYDRAGNN_NAN_SENTINEL=1`` (after a finite
    one, which captures): it must raise ``NonFiniteError`` naming a
    parameter by its key and its JAX path."""
    from hydragnn_tpu_torch.analysis import NonFiniteError

    model, optimizer = copy.deepcopy((state.model, state.optimizer))
    st = dataclasses.replace(state, model=model, optimizer=optimizer, info={})
    batch = next(iter(loader))
    saved = os.environ.get("HYDRAGNN_NAN_SENTINEL")
    os.environ["HYDRAGNN_NAN_SENTINEL"] = "1"
    try:
        trainer = Trainer(model, config["NeuralNetwork"]["Training"])
        trainer.train_step(st, batch)
        try:
            trainer.train_step(st, dataclasses.replace(batch, x=batch.x * float("nan")))
        except NonFiniteError as err:
            origin = err.origin
        else:
            raise AssertionError("a poisoned step passed the NaN sentinel")
        finally:
            trainer.release()
    finally:
        if saved is None:
            os.environ.pop("HYDRAGNN_NAN_SENTINEL")
        else:
            os.environ["HYDRAGNN_NAN_SENTINEL"] = saved
    key = origin["origin"].split(" = ")[0]
    if key not in dict(model.named_parameters()) or " = [0].params[" not in origin["origin"]:
        raise AssertionError(f"the sentinel named {origin}, not a parameter")
    return {"raised": "NonFiniteError", **origin}


def phase_whole_runs(device, card, rehearsal):
    """Phase 6's whole runs (module docstring): PNA's chunked ``ci.json``
    run with its profiled and sync-checked chunks and the tail's decisions
    against the host trackers; the eight other stacks' chunked runs, each
    held to its ceilings; a guarded streaming PNA run with two poisoned
    steps, and the guard's cost a step; the NaN sentinel. One
    ``{"run_training": ...}`` line per run. Returns the launches."""
    root = _build.REPO_ROOT / "build" / "chip_smoke" / "whole_runs"
    if root.exists():
        import shutil

        shutil.rmtree(root)
    data = root / "data"
    launches = {name: 0 for name in KERNELS}
    chunked = {"device_resident_dataset": True, "fit_chunk_epochs": FIT_CHUNK}
    runs = [("PNA", FIT_CONFIGS, "fit_chunk", chunked, {})]
    runs += [(m, CI_CONFIGS, "fit_chunk", chunked, {}) for m in OTHER_STACKS]
    runs += [("PNA", CI_CONFIGS, "guarded_streaming", {"divergence_guard": True},
              {"HYDRAGNN_FAULT_NAN_AT_STEP": GUARD_NAN_STEPS})]
    for model_type, configs, label, training, env in runs:
        configs = RUN_REHEARSAL["ci_configs"] if rehearsal else configs
        config = ci_config("ci.json", data, configs, rehearsal)
        config["NeuralNetwork"]["Architecture"]["model_type"] = model_type
        config["NeuralNetwork"]["Training"].update(training)
        t0 = time.perf_counter()
        with run_directory(root / f"{model_type}_{label}", env):
            state, counts, line, (train_l, test_l, _) = run_and_predict(config, device, None)
            for k, v in counts.items():
                launches[k] += v
            extra = {}
            if label == "fit_chunk":
                meta = fit_meta(state.info["log_name"])
                extra["fit_sched"] = {k: float(v) for k, v in meta["fit_sched"].items()}
                decisions = host_decisions(state.info["history"],
                                           config["NeuralNetwork"]["Training"], meta)
                if not decisions["equal"]:
                    raise AssertionError(f"{model_type}: the tail's decisions differ from the "
                                         f"host trackers': {decisions}")
                extra["tail_decisions"] = decisions
            if model_type == "PNA" and label == "fit_chunk" and device.type == "cuda":
                from hydragnn_tpu_torch.data.loaders import dataset_loading_and_splitting

                loaders = dataset_loading_and_splitting(copy.deepcopy(config))
                extra.update(profiled_chunk(state, config, loaders, device, "ci_fit_chunk"))
            if label == "guarded_streaming":
                guard = state.info["guard"]
                if not rehearsal and guard != {"skipped": 2, "restores": 0}:
                    raise AssertionError(f"the guarded run counted {guard}, not 2 skipped steps "
                                         "and no restore")
                extra["guard"] = guard
                if device.type == "cuda":
                    extra.update(guard_cost(state, config, train_l, device))
                extra["sentinel"] = sentinel_check(state, config, train_l)
        met = ceilings(model_type, line)
        if not rehearsal and not met:
            raise AssertionError(f"ci.json {model_type} ({label}) misses its ceilings "
                                 f"{THRESHOLDS[model_type]}: {line}")
        emit({"run_training": {"config": "ci.json", "mode": label, "model": model_type,
                               "width": config["NeuralNetwork"]["Architecture"]["hidden_dim"],
                               "env": env, "training": training,
                               "ceilings": THRESHOLDS[model_type], "ceilings_met": met,
                               **line, **extra, "phase_s": time.perf_counter() - t0,
                               "card": card}})
    return launches


# ---- phase 6, continued: the raw formats, periodic cells, the optimizers ----

# the CFG run: 200 of examples/eam's NiNb supercells (its default writes
# 300; the periodic radius graph is a Python loop on the host, parsed
# three times by run_and_predict), 3x3x3 FCC cells of 108 atoms
FORMATS_FULL = dict(cfg_configs=200, cells=3, hidden=256, layers=3, epochs=4, batch=32,
                    xyz=96, slab=48, step1_graphs=4, opt_graphs=4, ckpt_graphs=32)
FORMATS_REHEARSAL = dict(cfg_configs=16, cells=2, hidden=8, layers=2, epochs=2, batch=4,
                         xyz=16, slab=12, step1_graphs=2, opt_graphs=2, ckpt_graphs=4)
OPT_TYPES = ("SGD", "Adadelta", "Adagrad", "Adamax", "RMSprop", "LAMB", "FusedLAMB", "Adam",
             "AdamW")
# each type's rate on the card: where 10 steps at this width do not yet
# amplify a rounding difference past the trajectory's tolerance (below)
OPT_RATES = {"SGD": 1e-2, "Adadelta": 3e-2, "Adagrad": 1e-2, "Adamax": 2e-4, "RMSprop": 1e-5,
             "LAMB": 1e-3, "FusedLAMB": 1e-3, "Adam": 5e-5, "AdamW": 1e-4}
OPT_STEPS = 10
# the card's 10 captured steps against the CPU's 10 eager ones. The sums'
# order differs (K3's and K1's atomics) and the sign-like updates of the
# adaptive rules amplify it step by step: on the CPU, weights moved by 1e-6
# of themselves move RMSprop's 10 losses at 1e-3 by 4.7% and Adam's at
# 1e-3 by 2.3%, at these rates by at most 0.07% (rtol 1e-3: 0.66 of it).
# So the trajectory is held at 1e-2, and each captured update exactly:
OPT_LOSS_RTOL, OPT_LOSS_ATOL = 1e-2, 1e-5
# every update against the CPU's rule on the card's own gradients and state:
# 1e-4 of the update plus 3 units in the last place of the parameter it
# lands in. The bias corrections 1 - b^t are float32 on both devices (as in
# optax), and two units in the last place of 0.999^t (a pow on each device)
# move 1 - 0.999^t by 1.2e-4 of itself at step 1 and its square root by
# 6e-5; torch's capturable Adam divides by eps / step size where its CPU
# step multiplies, which can land a unit or two of the parameter apart
OPT_UPDATE_RTOL, OPT_UPDATE_ULPS = 1e-4, 3
CKPT_TIMED_STEPS = 10
SLAB_VACUUM = 2.5  # Angstrom above the slab: under the cutoff, so a z image would connect


@contextlib.contextmanager
def timed_pbc(spent):
    """``spent`` gets the host seconds and calls of the serialized
    loader's ``radius_graph_pbc`` while inside."""
    from hydragnn_tpu_torch.data import serialized

    inner = serialized.radius_graph_pbc

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            spent[0] += time.perf_counter() - t0
            spent[1] += 1

    serialized.radius_graph_pbc = timed
    try:
        yield spent
    finally:
        serialized.radius_graph_pbc = inner


def write_xyz_data(path, number_configurations, cells=2, seed=1):
    """FCC NiNb clusters (``cells``^3 cells, no lattice) as ``.xyz`` files,
    the energy a site on the comment line."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    scaled = fcc_scaled(cells)
    for c in range(number_configurations):
        z = np.where(rng.random(len(scaled)) < rng.uniform(0.3, 0.9), CFG_NI, CFG_NB)
        pos = (scaled + rng.normal(0, 0.004, scaled.shape)) * CFG_ALAT * cells
        rows = [f"{'Ni' if zi == CFG_NI else 'Nb'} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
                for zi, p in zip(z, pos)]
        with open(os.path.join(path, f"cluster{c}.xyz"), "w") as f:
            f.write(f"{len(z)}\n{eam_energy(z, pos):.8f}\n" + "\n".join(rows) + "\n")


def slab_frames(number, cells=3, layers=2, seed=2):
    """FCC Ni(001) slabs, ``cells`` x ``cells`` in plane, ``layers`` cells
    thick, :data:`SLAB_VACUUM` above, ``pbc="T T F"``: extxyz frames with
    an energy and seeded forces."""
    rng = np.random.default_rng(seed)
    scaled = fcc_scaled(1)
    grid = np.stack(np.meshgrid(np.arange(cells), np.arange(cells), np.arange(layers),
                                indexing="ij"), -1).reshape(-1, 1, 3)
    base = ((grid + scaled[None]).reshape(-1, 3)) * CFG_ALAT
    top = float(base[:, 2].max())
    cell = np.diag([cells * CFG_ALAT, cells * CFG_ALAT, top + SLAB_VACUUM])
    frames = []
    for _ in range(number):
        z = np.where(rng.random(len(base)) < 0.7, CFG_NI, CFG_NB)
        pos = base + rng.normal(0, 0.02, base.shape)
        frames.append({"z": z, "pos": pos, "cell": cell, "pbc": np.array([True, True, False]),
                       "info": {"energy": eam_energy(z, pos) * len(z)},
                       "arrays": {"forces": rng.normal(0, 0.1, pos.shape)}})
    return frames, top


def formats_config(name, fmt, raw, size, periodic):
    """``examples/eam/NiNb_EAM_energy.json`` (radius 3.2, 14 neighbours,
    AdamW at 2e-3) at MXU_HEADLINE's width: PNA hidden 256, 3 conv layers,
    64-wide graph head; ``fmt`` data under ``raw`` (the ``total`` path,
    the plain split: nearly every configuration's composition is its own,
    and a stratified split needs two of each)."""
    with open(_build.REPO_ROOT / "examples" / "eam" / "NiNb_EAM_energy.json") as f:
        config = json.load(f)
    config["Verbosity"]["level"] = 0
    ds = config["Dataset"]
    ds.update(name=name, format=fmt, path={"total": str(raw)},
              compositional_stratified_splitting=False)
    arch = config["NeuralNetwork"]["Architecture"]
    width = max(32, size["hidden"] // 4)
    arch.update(periodic_boundary_conditions=periodic, hidden_dim=size["hidden"],
                num_conv_layers=size["layers"])
    arch["output_heads"]["graph"].update(dim_sharedlayers=width, dim_headlayers=[width] * 2)
    config["NeuralNetwork"]["Training"].update(num_epoch=size["epochs"], batch_size=size["batch"])
    return config


def held_first_step(cfg, samples, device):
    """Step 1 of ``cfg``'s PNA (``fused``, AdamW at 1e-3) on the batch of
    ``samples`` through ``Trainer`` on ``device``, held against the port's
    float64 CPU step with the f32 CPU steps as the witnesses, the graphs in
    both orders (:func:`hold_step_at_kinks`, ``F32_FACTOR``). Returns the
    check's line and the launches."""
    host = _graph_batch(samples)
    model = create_model_config(cfg, device=device, aggregation="fused", seed=0)
    kinks = {}
    # a witness in each graph order: one alone can land near the exact value
    reversed_host = _graph_batch(samples[::-1])
    cpu, exact = cpu_references(model, host, False, reversed_host, kinks=kinks)
    trainer = Trainer(model, train_config(False))
    state = trainer.init_state(host)
    acts = KinkReLUs()
    acts.install(model)
    reset_launch_counts()
    state, met = trainer.train_step(state, host)
    counts = launch_counts()
    step1 = snapshot(model)
    acts.remove(model)
    acts.inputs = acts.card_inputs()
    trainer.release()
    rows, bad, level, relu_kinks = hold_step_at_kinks(step1, met["loss"], cpu, exact, kinks,
                                                      acts.inputs, host)
    if bad:
        raise AssertionError(f"formats: the periodic CFG step 1 against the exact step: {bad}")
    return {"tensors": len(rows), "cpu_level": level, "relu_kinks": relu_kinks,
            "worst_err_over_tolerance": max(r["worst_over_tol"] for r in rows),
            "closest": sorted(rows, key=lambda r: -r["worst_over_tol"])[:4],
            "cpu_witness": "f32 CPU steps, the graphs in both orders",
            "factor": F32_FACTOR}, counts


def _launch_check(what, counts, device, steps, forwards, cfg, extra=None):
    """Hold ``counts`` to ``steps`` training steps and ``forwards``
    forwards of ``cfg``'s PNA in ``fused`` mode (``extra``: more launches
    a step), on the card."""
    per_step, per_forward = launches_per_train_step(cfg, "fused"), launches_per_forward(cfg,
                                                                                      "fused")
    want = {k: steps * (per_step[k] + (extra or {}).get(k, 0)) + forwards * per_forward[k]
            for k in KERNELS}
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"formats ({what}): launched {counts}, expected {want} "
                             f"({steps} steps, {forwards} forwards)")


def _graph_batch(samples):
    """``samples`` (with their targets) in one batch padded for them."""
    pads = pad_sizes_for(max(g.num_nodes for g in samples), max(g.num_edges for g in samples),
                         len(samples))
    return collate_graphs(samples, *pads, head_types=tuple(samples[0].target_types),
                          head_dims=tuple(int(t.shape[-1]) for t in samples[0].targets))


def held_optimizer_steps(base, training, freeze, host, device, cfg, add):
    """``OPT_STEPS`` captured steps of a copy of ``base`` on ``device``;
    before each, the training state is read back, and after it a CPU copy
    of the same optimizer takes one step from that state with the card's
    gradients: every parameter the card updated must land on that update
    (``OPT_UPDATE_RTOL`` of it and ``OPT_UPDATE_ULPS`` units in the last
    place of the parameter). Returns the losses, the worst update's share
    of its tolerance and the encoder parameters that stayed bit-equal to
    ``base``'s."""
    from hydragnn_tpu_torch.train.capture import copy_state, state_tensors
    from hydragnn_tpu_torch.train.optimizer import ensure_optimizer_state

    model = copy.deepcopy(base).to(device)
    trainer = Trainer(model, training, freeze_conv=freeze)
    state = trainer.init_state(host)
    twin = copy.deepcopy(base)
    twin_opt = Trainer(twin, training, freeze_conv=freeze).init_state(host).optimizer
    ensure_optimizer_state(state.optimizer)
    ensure_optimizer_state(twin_opt)
    card_state, twin_state = state_tensors(model, state.optimizer), state_tensors(twin, twin_opt)
    reset_launch_counts()
    reset_capture_counts()
    losses, worst = [], 0.0
    for _ in range(OPT_STEPS):
        before = [t.detach().cpu().clone() for t in card_state]
        state, met = trainer.train_step(state, host)
        losses.append(met["loss"])
        copy_state(twin_state, before)
        for p, q in zip(model.parameters(), twin.parameters()):
            q.grad = p.grad.detach().cpu().clone()
        twin_opt.step()
        for p, q, p0 in zip(model.parameters(), twin.parameters(), before):
            got, want = p.detach().cpu(), q.detach()
            ulp = torch.finfo(torch.float32).eps * torch.maximum(want.abs(), got.abs())
            tol = OPT_UPDATE_RTOL * (want - p0).abs() + OPT_UPDATE_ULPS * ulp
            worst = max(worst, float(((got - want).abs() / tol.clamp_min(1e-30)).max()))
    _launch_check(f"{training['Optimizer']['type']} steps", launch_counts(), device,
                  OPT_STEPS + capture_counts()["warm_steps"], 0, cfg)
    add(launch_counts())
    start = dict(base.named_parameters())
    still = [n for n, p in model.named_parameters() if n.startswith("encoder_")
             and torch.equal(p.detach().cpu(), start[n])]
    trainer.release()
    return [float(v) for v in torch.stack(losses).cpu()], worst, still


def phase_formats(device, card, rehearsal):
    """The rest of ``run_training``'s surface on the card (the module
    docstring, phase 6): a periodic CFG run, an XYZ run, an extxyz slab
    through ``Trainer``, every optimizer type, conv checkpointing and the
    compact wire format. One ``{"formats": ...}`` line each. Returns the
    launches."""
    from hydragnn_tpu_torch.data.extxyz import load_extxyz_dir, write_extxyz
    from hydragnn_tpu_torch.data.loaders import create_dataloaders
    from hydragnn_tpu_torch.train.transfer import wire_bytes
    from hydragnn_tpu_torch.utils.config import gather_deg

    size = FORMATS_REHEARSAL if rehearsal else FORMATS_FULL
    root = _build.REPO_ROOT / "build" / "chip_smoke" / "formats"
    if root.exists():
        shutil.rmtree(root)
    on_card = device.type == "cuda"
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 1. the periodic CFG run through the entry points
    t0 = time.perf_counter()
    raw = root / "data" / "cfg"
    write_cfg_data(str(raw), size["cfg_configs"], cells=size["cells"], seed=0)
    config = formats_config("NiNb_pbc", "CFG", raw, size, periodic=True)
    spent = [0.0, 0]
    with timed_pbc(spent), run_directory(root / "cfg_run", {"HYDRAGNN_AGG": "fused"}):
        state, counts, line, (train_l, test_l, _) = run_and_predict(config, device, "fused")
        add(counts)
        with open(os.path.join("logs", state.info["log_name"], "config.json")) as f:
            cfg = json.load(f)["NeuralNetwork"]["Architecture"]
        if on_card:
            line.update(profiled_epoch(state, config, train_l, device, "formats_cfg"))
    samples = list(train_l.dataset)
    degrees = sorted({int(d) for g in samples
                      for d in np.bincount(g.edge_index[1], minlength=g.num_nodes)})
    if degrees != [12]:
        raise AssertionError(f"formats: FCC in-degrees {degrees} across the periodic cell, not 12")
    if not line["train_loss"][-1] < line["train_loss"][0]:
        raise AssertionError(f"formats: the CFG run's loss did not fall: {line['train_loss']}")
    check, counts = held_first_step(cfg, samples[: size["step1_graphs"]], device)
    warm = capture_counts()
    add(counts)
    line.update(pbc_host_s=spent[0], pbc_calls=spent[1],
                pbc_ms_per_sample=1e3 * spent[0] / max(spent[1], 1), in_degrees=degrees,
                step1_check=check, atoms=samples[0].num_nodes, phase_s=time.perf_counter() - t0)
    emit({"formats": {"run": "cfg_periodic", "config": "examples/eam/NiNb_EAM_energy.json",
                      "width": size["hidden"], "branch": "fused", **line, "card": card}})

    # 2. an XYZ run, the same way (clusters: no cell)
    t0 = time.perf_counter()
    raw = root / "data" / "xyz"
    write_xyz_data(str(raw), size["xyz"], cells=2, seed=1)
    config = formats_config("NiNb_clusters", "XYZ", raw, size, periodic=False)
    with run_directory(root / "xyz_run", {"HYDRAGNN_AGG": "fused"}):
        _, counts, line, _ = run_and_predict(config, device, "fused")
    add(counts)
    if not line["train_loss"][-1] < line["train_loss"][0]:
        raise AssertionError(f"formats: the XYZ run's loss did not fall: {line['train_loss']}")
    emit({"formats": {"run": "xyz", "width": size["hidden"], "branch": "fused", **line,
                      "phase_s": time.perf_counter() - t0, "card": card}})

    # 3. an extxyz slab (pbc "T T F") through Trainer: the OC20 path without
    # the shard store
    t0 = time.perf_counter()
    frames, top = slab_frames(size["slab"])
    slab_dir = root / "data" / "slab"
    slab_dir.mkdir(parents=True)
    write_extxyz(str(slab_dir / "slab.extxyz"), frames)
    graphs = load_extxyz_dir(str(slab_dir), radius=3.2, max_neighbours=14)
    across = max(float(np.abs(g.pos[g.edge_index[0], 2] - g.pos[g.edge_index[1], 2]).max())
                 for g in graphs)
    degrees = sorted({int(d) for g in graphs for d in np.bincount(g.edge_index[1])})
    if across > 3.2 or degrees[-1] != 12 or degrees[0] >= 12:
        raise AssertionError(f"formats: the slab's edges reach {across} A in z (slab {top} A "
                             f"thick), in-degrees {degrees}")
    slab_cfg = dict(arch(FULL if not rehearsal else TINY, "PNA"), hidden_dim=size["hidden"],
                    num_conv_layers=size["layers"], output_dim=[1, 3],
                    num_nodes=graphs[0].num_nodes, pna_deg=gather_deg(graphs).tolist())
    n_val = max(1, len(graphs) // 8)
    loaders = create_dataloaders(graphs[: -2 * n_val], graphs[-2 * n_val: -n_val],
                                 graphs[-n_val:], batch_size=max(2, size["batch"] // 2))
    model = create_model_config(slab_cfg, device=device, aggregation="fused", seed=0)
    trainer = Trainer(model, train_config(False))
    state = trainer.init_state(next(iter(loaders[0])))
    reset_launch_counts()
    reset_capture_counts()
    losses = []
    for epoch in range(3):
        loaders[0].set_epoch(epoch)
        state, loss, _ = trainer.train_epoch(state, loaders[0])
        losses.append(loss)
        val_loss, _ = trainer.evaluate(state, loaders[1])
    ran = capture_counts()
    _launch_check("slab", launch_counts(), device, 3 * len(loaders[0]) + ran["warm_steps"],
                  3 * len(loaders[1]) + ran["warm_forwards"], slab_cfg)
    add(launch_counts())
    trainer.release()
    if not (np.isfinite(losses + [val_loss]).all() and losses[-1] < losses[0]):
        raise AssertionError(f"formats: the slab's losses {losses}, validation {val_loss}")
    emit({"formats": {"run": "extxyz_slab", "pbc": "T T F", "frames": len(graphs),
                      "atoms": graphs[0].num_nodes, "max_edge_dz": across, "slab_top_z": top,
                      "in_degrees": degrees, "train_loss": losses, "val_loss": val_loss,
                      "launches": {k: v for k, v in launch_counts().items() if v},
                      "phase_s": time.perf_counter() - t0, "card": card}})

    # 4. every optimizer type: 10 captured steps against the CPU's eager
    # trajectory, and each update against the CPU's rule on its gradients
    t0 = time.perf_counter()
    host = _graph_batch(samples[: size["opt_graphs"]])
    base = create_model_config(cfg, device="cpu", aggregation="fused", seed=0)
    encoder = [n for n, _ in base.named_parameters() if n.startswith("encoder_")]
    runs = []
    for opt_type, freeze in [(t, False) for t in OPT_TYPES] + [("AdamW", True)]:
        training = {"Optimizer": {"type": opt_type, "learning_rate": OPT_RATES[opt_type]}}
        card_l, update_over, still = held_optimizer_steps(base, training, freeze, host, device,
                                                          cfg, add)
        model = copy.deepcopy(base)
        trainer = Trainer(model, training, freeze_conv=freeze)
        state = trainer.init_state(host)
        cpu_l = []
        for _ in range(OPT_STEPS):
            state, met = trainer.train_step(state, host)
            cpu_l.append(float(met["loss"]))
        worst = float(np.max(np.abs(np.subtract(card_l, cpu_l))
                             / (OPT_LOSS_ATOL + OPT_LOSS_RTOL * np.abs(cpu_l))))
        if (worst > 1 or update_over > 1 or not np.isfinite(card_l).all()
                or (freeze and still != encoder)):
            raise AssertionError(f"formats: {opt_type} (freeze_conv {freeze}) on the card "
                                 f"{card_l} against the CPU {cpu_l} ({worst} of the tolerance); "
                                 f"updates {update_over} of theirs; frozen kept {len(still)} "
                                 f"of {len(encoder)}")
        runs.append({"type": opt_type, "freeze_conv": freeze, "lr": OPT_RATES[opt_type],
                     "card_loss": card_l, "cpu_loss": cpu_l, "worst_over_tol": worst,
                     "update_worst_over_tol": update_over,
                     "encoder_bit_equal": f"{len(still)} of {len(encoder)}" if freeze else None})
    emit({"formats": {"run": "optimizers", "steps": OPT_STEPS, "graphs": size["opt_graphs"],
                      "trajectory_rtol": OPT_LOSS_RTOL, "trajectory_atol": OPT_LOSS_ATOL,
                      "update_rtol": OPT_UPDATE_RTOL, "update_ulps": OPT_UPDATE_ULPS,
                      "runs": runs, "phase_s": time.perf_counter() - t0, "card": card}})

    # 5. conv checkpointing: memory and time against the same step without
    # it; 6. the bytes a batch ships, compact and not
    t0 = time.perf_counter()
    host = _graph_batch(samples[: size["ckpt_graphs"]])
    result = {}
    for ck in (False, True):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = create_model_config(dict(cfg, conv_checkpointing=ck), device=device,
                                    aggregation="fused", seed=0)
        trainer = Trainer(model, train_config(False))
        state = trainer.init_state(host)
        reset_launch_counts()
        reset_capture_counts()
        state, met = trainer.train_step(state, host)
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        entry = {"loss": float(met["loss"])}
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CKPT_TIMED_STEPS):
                state, _ = trainer.train_step(state, host)
            end.record()
            torch.cuda.synchronize()
            entry.update(ms_per_step=start.elapsed_time(end) / CKPT_TIMED_STEPS,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            steps = 1 + CKPT_TIMED_STEPS + capture_counts()["warm_steps"]
            # the recompute runs each conv's forward again in the backward
            _launch_check(f"conv_checkpointing {ck}", launch_counts(), device, steps, 0, cfg,
                          extra={FUSED_KERNEL["PNA"]: cfg["num_conv_layers"]} if ck else None)
            add(launch_counts())
        else:
            entry.update(ms_per_step="not measured (cpu rehearsal)",
                         peak_memory_gb="not measured (cpu rehearsal)")
        result[ck] = (entry, grads)
        if not ck:
            compact = trainer.compact(host)
            wire = {"bytes_compact": wire_bytes(compact), "bytes_plain": wire_bytes(host),
                    "pos_placeholder": tuple(compact.pos.shape) == (1, 3),
                    "ids": str(compact.senders.dtype)}
        trainer.release()
    (plain, g0), (checked, g1) = result[False], result[True]
    worst = max(float((g1[n] - g0[n]).abs().max()) / atomic_tolerance(g0[n]) for n in g0)
    loss_over = abs(checked["loss"] - plain["loss"]) / atomic_tolerance(
        torch.tensor([plain["loss"]]))
    if worst > 1 or loss_over > 1:
        raise AssertionError(f"formats: conv checkpointing's step 1 differs: gradients "
                             f"{worst}, loss {loss_over} times the atomic tolerance")
    emit({"formats": {"run": "conv_checkpointing", "graphs": size["ckpt_graphs"],
                      "batch": f"n_pad {host.num_nodes} e_pad {host.num_edges}",
                      "plain": plain, "checkpointed": checked,
                      "grad_over_atomic_tol": worst, "loss_over_atomic_tol": loss_over,
                      "phase_s": time.perf_counter() - t0, "card": card}})
    emit({"formats": {"run": "compact_transfer", "graphs": size["ckpt_graphs"], **wire,
                      "saved_share": 1 - wire["bytes_compact"] / wire["bytes_plain"],
                      "card": card}})
    return launches


# ---- phase 7: training telemetry ------------------------------------------------

TELEMETRY_EPOCHS = 3  # the guarded streaming run
TELEMETRY_STAGED_EPOCHS = 6  # the staged runs: telemetry on against off, past the capture
TELEMETRY_CHUNK = 2  # the chunked run's fit_chunk_epochs: 3 chunks, the first captures
TELEMETRY_NAN_STEP = 3  # HYDRAGNN_FAULT_NAN_AT_STEP of the guarded run: a step of epoch 0
TELEMETRY_PROFILE_STEPS = 2  # /profile?steps=N, asked after epoch 0
TELEMETRY_MFU_TOL = 0.15  # each train bucket's MFU against the smoke's own figure
TELEMETRY_OVERHEAD = 0.03  # ms a step with telemetry on against off (or the off runs' spread)
# the staged runs that the overhead hold pools, in the order they run: off,
# on, on, off, so that a drift of the card's speed across the phase falls on
# both sides alike
TELEMETRY_OVERHEAD_RUNS = (("staged_off", False), ("staged", True), ("staged_on_2", True),
                           ("staged_off_2", False))
TELEMETRY_OWN_PASSES = 3  # the smoke's own figure: passes over every microbatch, timed whole
TELEMETRY_REQUIRE = ("run_manifest", "epoch", "compile", "checkpoint_saved", "guard_skip",
                     "goodput", "profile", "run_end")
# the kernels a trace of the fused PNA step must name: K3's (the gather
# kernel of csrc/gather_reduce.cuh) and K1's (csrc/segment.cu)
TRACE_KERNELS = {"fused_gather_moments": "gather_reduce_kernel",
                 "segment_sum": "segment_sum_runs_kernel"}


class _ScrapeOnFirstScalar:
    """The run's scalar writer, wrapped: at its first scalar (epoch 0's,
    after the epoch's captures) it scrapes the live ``/metrics`` and
    ``/healthz`` and asks ``/profile?steps=N`` from the training thread, as
    the JAX package's telemetry test scrapes through ``writer=``."""

    def __init__(self, inner, scrapes):
        self.inner, self.scrapes = inner, scrapes

    def add_scalar(self, tag, value, step):
        self.inner.add_scalar(tag, value, step)
        if self.scrapes:
            return
        from hydragnn_tpu_torch.obs import runtime

        host, port = runtime.active().address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            self.scrapes["metrics"] = r.read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            self.scrapes["health"] = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/profile?steps={TELEMETRY_PROFILE_STEPS}",
                                    timeout=30) as r:
            self.scrapes["profile"] = json.loads(r.read())

    def add_regions(self, regions, step=0):
        self.inner.add_regions(regions, step)

    def close(self):
        self.inner.close()


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _sync_checked_chunks(orig, checked):
    """``Trainer.fit_dispatch`` with every chunk after the first (which
    captures the programs) queued under ``set_sync_debug_mode("error")``:
    a host sync inside one raises."""
    def fit_dispatch(self, *args, **kw):
        checked.append(len(checked))
        if len(checked) == 1:
            return orig(self, *args, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    return fit_dispatch


def _telemetry_run(root, label, config, env, device, sizes, scrape=None, sync_check=False):
    """One ``run_training`` of ``config`` under ``env`` in ``root/label``:
    its launches held exactly (its steps' and evaluation forwards', the
    captures' warm-ups), its stream validated (every goodput window's
    fractions summing to 1). Returns the state, the records, the counts
    and the run's wall."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.obs.scalars import ScalarWriter
    from hydragnn_tpu_torch.train import driver

    from hydragnn_tpu_torch.obs import runtime

    n_train, n_val, n_test = sizes
    patches = contextlib.ExitStack()
    # every step time the run's ledger took, in order, for the line
    step_times = []
    on_step_time = runtime.RunTelemetry.on_step_time

    def recorded(self, seconds, count=1, compile_s=None):
        step_times.append((self.current_epoch, seconds / max(int(count), 1)))
        return on_step_time(self, seconds, count, compile_s)

    patches.enter_context(_patched(runtime.RunTelemetry, "on_step_time", recorded))
    if scrape is not None:
        class Writer:
            for_run = staticmethod(lambda *a, **k: _ScrapeOnFirstScalar(
                ScalarWriter.for_run(*a, **k), scrape))

        patches.enter_context(_patched(driver, "ScalarWriter", Writer))
    checked = []
    if sync_check and device.type == "cuda":
        patches.enter_context(_patched(Trainer, "fit_dispatch",
                                       _sync_checked_chunks(Trainer.fit_dispatch, checked)))
    with run_directory(root / label, env), patches:
        reset_launch_counts()
        reset_capture_counts()
        t0 = time.perf_counter()
        state = run_training(copy.deepcopy(config), device=device)
        wall = time.perf_counter() - t0
        counts, programs = launch_counts(), capture_counts()
    training = config["NeuralNetwork"]["Training"]
    history = state.info["history"]
    chunk = int(training.get("fit_chunk_epochs", 0))
    epochs = chunk * len({h["chunk"] for h in history}) if chunk else len(history)
    arch_cfg = dict(config["NeuralNetwork"]["Architecture"], equivariance=False)
    per_step = launches_per_train_step(arch_cfg, "fused")
    per_forward = launches_per_forward(arch_cfg, "fused")
    expected = {k: (epochs * n_train + programs["warm_steps"]) * per_step[k]
                + (epochs * (n_val + n_test) + programs["warm_forwards"]) * per_forward[k]
                for k in KERNELS}
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"telemetry run {label}: launched {counts}, expected {expected} "
                             f"({epochs} epochs, programs {programs})")
    if sync_check and device.type == "cuda" and len(checked) < 2:
        raise AssertionError(f"telemetry run {label}: {len(checked)} chunks, none sync-checked")
    stream = root / label / "logs" / state.info["log_name"] / "events.jsonl"
    records = (validate_events(str(stream)) if env.get("HYDRAGNN_TELEMETRY") != "0"
               else [])
    for g in (r for r in records if r["event"] == "goodput"):
        total = sum(g["fractions"].values())
        if abs(total - 1.0) > 1e-6:
            raise AssertionError(f"telemetry run {label}: epoch {g['epoch']}'s goodput "
                                 f"fractions sum to {total}")
    if records and records[-1] != next(r for r in reversed(records) if r["event"] == "run_end"):
        raise AssertionError(f"telemetry run {label}: the stream does not end with run_end")
    ms = [1e3 * h["train_s"] / n_train for h in history]
    return {"state": state, "records": records, "launches": counts, "wall_s": wall,
            "stream": stream, "ms_per_step": ms, "epochs": epochs,
            "sync_checked_chunks": max(len(checked) - 1, 0),
            "step_ms": [[e, round(1e3 * t, 4)] for e, t in step_times]}


def _last_mfu(records):
    """``{bucket: mfu entry}`` of the last goodput window that has one."""
    return next((r["mfu"] for r in reversed(records) if r["event"] == "goodput" and r.get("mfu")),
                {})


def _own_mfu(state, training, batches, device, staged):
    """The smoke's own figure for a train bucket, taken outside the program
    layer (neither its timer hook nor its FLOP accounting):
    FlopCounterMode's FLOPs of one eager forward and backward of a copy of
    the run's model, over the ms a step of a pair of CUDA events around a
    whole pass of replays of the run's program on another copy
    (``epoch_scan`` over the staged batches; or ``train_step`` over the
    batches, each already on the card, back to back), divided by the pass's
    steps: the median of :data:`TELEMETRY_OWN_PASSES` passes; over the
    card's f32 peak (``obs/ledger.PEAK_FLOPS``, 67e12). Returns ``(mfu,
    flops, ms, peak, the passes' ms a step)``."""
    from torch.utils.flop_counter import FlopCounterMode

    from hydragnn_tpu_torch.obs.ledger import PEAK_FLOPS
    from hydragnn_tpu_torch.train.transfer import decompact

    model, optimizer = copy.deepcopy((state.model, state.optimizer))
    trainer = Trainer(model, training)
    st = dataclasses.replace(state, model=model, optimizer=optimizer, info={})
    counter_model = copy.deepcopy(state.model).train()
    first = decompact(trainer.put_batch(batches[0]))
    with FlopCounterMode(display=False) as counter:
        loss, _ = counter_model.loss(counter_model(first), first)
        loss.backward()
    flops = float(counter.get_total_flops())
    del counter_model
    if staged:
        stack = trainer.stage_batches(batches)
        trainer.train_epoch_staged(st, stack)  # the capture
        programs = trainer.programs(st)
        n, one_pass = stack.nb, lambda: programs.epoch_scan(stack, stack.nb)  # noqa: E731
    else:
        trainer.train_step(st, batches[0])  # the capture
        programs = trainer.programs(st)
        on_card = [trainer.put_batch(b) for b in batches]

        def one_pass():
            for b in on_card:
                programs.train_step(b)

        n = len(on_card)
    times = []
    for _ in range(TELEMETRY_OWN_PASSES):
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        begin.record()
        one_pass()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) / n)
    ms = float(np.median(times))
    trainer.release()
    peak = PEAK_FLOPS[torch.cuda.get_device_name(device)]["f32"]
    return flops / (ms / 1e3) / peak, flops, ms, peak, times


def _trace_kernels(path):
    """The kernel names of a Chrome trace the profiler wrote."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def _obs_cli(args):
    """``python -m hydragnn_tpu_torch.obs`` in this process: ``(exit code,
    stdout)``."""
    import io

    from hydragnn_tpu_torch.obs.__main__ import main as obs_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = obs_main(args)
    return rc, out.getvalue(), err.getvalue()


def _budget_checks(run_dir, work, device):
    """The report of ``run_dir`` rendered by the CLI's own process; on the
    card (where the records carry FLOPs and peak bytes) a budget written
    from it, checked (exit 0), the same budget with every FLOPs figure
    halved (exit 1), and a missing stream (exit 2)."""
    rendered = work / "report.md"
    with open(rendered, "w") as f:
        res = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.obs", "report",
                              str(run_dir), "--format", "markdown"], stdout=f,
                             stderr=subprocess.PIPE, text=True, timeout=300,
                             cwd=str(_build.REPO_ROOT))
    if res.returncode != 0:
        raise AssertionError(f"obs report exited {res.returncode}: {res.stderr}")
    if device.type != "cuda":
        return {"report_lines": sum(1 for _ in open(rendered)), "budget": "not on the CPU"}
    budget = work / "budget.json"
    rc, _, err = _obs_cli(["report", str(run_dir), "--write-budget", str(budget)])
    if rc != 0:
        raise AssertionError(f"obs report --write-budget exited {rc}: {err}")
    rc_own, _, err_own = _obs_cli(["report", str(run_dir), "--check-budget", str(budget)])
    with open(budget) as f:
        halved = json.load(f)
    for entry in halved["programs"].values():
        if "flops" in entry:
            entry["flops"] /= 2.0
    halved_path = work / "budget_halved.json"
    with open(halved_path, "w") as f:
        json.dump(halved, f)
    rc_halved, _, err_halved = _obs_cli(["report", str(run_dir), "--check-budget",
                                         str(halved_path)])
    rc_missing, _, _ = _obs_cli(["report", str(work / "no_such_run")])
    if (rc_own, rc_halved, rc_missing) != (0, 1, 2):
        raise AssertionError(f"obs report exit codes: own budget {rc_own} ({err_own}), halved "
                             f"FLOPs {rc_halved} ({err_halved}), missing stream {rc_missing}; "
                             "expected 0, 1, 2")
    return {"report_lines": sum(1 for _ in open(rendered)),
            "budget_programs": len(halved["programs"]),
            "exit_codes": {"own_budget": rc_own, "halved_flops": rc_halved,
                           "missing_stream": rc_missing}}


def phase_telemetry(device, card, rehearsal):
    """Phase 7, training telemetry (``obs/``): ``ci_multihead.json``'s PNA at
    MXU_HEADLINE's width (hidden 256, 3 layers, ``fused``, f32) through
    ``run_training`` with ``HYDRAGNN_OBS_PORT=0``, four runs: a guarded
    streaming run with one poisoned step, its ``/metrics`` and
    ``/healthz`` scraped and ``/profile?steps=2`` asked after epoch 0 (the
    trace must name K3's and K1's kernels; the stream holds every kind of
    :data:`TELEMETRY_REQUIRE`); the staged run twice with telemetry off and
    twice on, in the order of :data:`TELEMETRY_OVERHEAD_RUNS` (the median ms
    a step of the on runs' epochs past the capture within
    :data:`TELEMETRY_OVERHEAD` of the off runs', or of the larger off run's
    own spread); the same chunked, every chunk after the first queued with
    no host sync.
    Each train bucket's MFU (the last goodput window's) is held against the
    smoke's own figure (:func:`_own_mfu`) within :data:`TELEMETRY_MFU_TOL`;
    the report, its budget (exit 0) and the budget with the FLOPs halved
    (exit 1) through the CLI. One ``{"telemetry": ...}`` line a run (with
    the card's clocks read just after it).
    Returns the launches."""
    from hydragnn_tpu_torch.data.loaders import dataset_loading_and_splitting

    root = _build.REPO_ROOT / "build" / "chip_smoke" / "telemetry"
    if root.exists():
        shutil.rmtree(root)
    configs = RUN_REHEARSAL["multihead_configs"] if rehearsal else MULTIHEAD_CONFIGS
    base = ci_config("ci_multihead.json", root / "data", configs, rehearsal)
    base["NeuralNetwork"]["Training"]["num_epoch"] = TELEMETRY_EPOCHS
    # the runs' branch: HYDRAGNN_AGG decides whether the batches carry the
    # dense lists (which a fused model would then take)
    with run_directory(root / "loaders", {"HYDRAGNN_AGG": "fused"}):
        loaders = dataset_loading_and_splitting(copy.deepcopy(base))
    sizes = tuple(len(ld) for ld in loaders)
    batches = list(loaders[0])
    launches = {name: 0 for name in KERNELS}
    on = {"HYDRAGNN_AGG": "fused", "HYDRAGNN_OBS_PORT": "0"}
    staged = dict(device_resident_dataset=True, num_epoch=TELEMETRY_STAGED_EPOCHS)

    def config_of(**training):
        config = copy.deepcopy(base)
        config["NeuralNetwork"]["Training"].update(training)
        return config

    off = {"HYDRAGNN_AGG": "fused", "HYDRAGNN_TELEMETRY": "0"}
    runs = [
        ("guarded_streaming", config_of(divergence_guard=True),
         dict(on, HYDRAGNN_FAULT_NAN_AT_STEP=str(min(TELEMETRY_NAN_STEP, sizes[0] - 1))),
         True, False),
        *((label, config_of(**staged), on if telemetry else off, False, False)
          for label, telemetry in TELEMETRY_OVERHEAD_RUNS),
        ("chunked", config_of(**staged, fit_chunk_epochs=TELEMETRY_CHUNK), on, False, True),
    ]
    results, problems = {}, []
    for label, config, env, scraped, chunked in runs:
        t0 = time.perf_counter()
        scrapes = {} if scraped else None
        run = _telemetry_run(root, label, config, env, device, sizes, scrape=scrapes,
                             sync_check=chunked)
        results[label] = run
        for k, v in run["launches"].items():
            launches[k] += v
        records = run["records"]
        line = {"run": label, "env": env, "epochs": run["epochs"], "wall_s": run["wall_s"],
                "ms_per_step": run["ms_per_step"],
                "launches": {k: v for k, v in run["launches"].items() if v}}
        if records:
            kinds = {}
            for r in records:
                kinds[r["event"]] = kinds.get(r["event"], 0) + 1
            compiles = [r for r in records if r["event"] == "compile"]
            line.update(events=kinds, goodput=[
                {"epoch": g["epoch"], "wall_s": g["wall_s"], "fractions": g["fractions"],
                 "steps": g.get("steps"), "step_s": g.get("step_s")}
                for g in records if g["event"] == "goodput"],
                compiles=[{"name": c["name"], "bucket": c["bucket"], "cost": c["cost"],
                           "memory": c["memory"], "capture_s": c.get("capture_s")}
                          for c in compiles])
            mfu = _last_mfu(records)
            line["mfu"] = mfu
            if device.type == "cuda":
                for bucket, m in mfu.items():
                    if not 0.0 < m["mfu"] < 1.0:
                        problems.append(f"telemetry run {label}: {bucket} MFU {m}")
                prog = "train_step" if label == "guarded_streaming" else "epoch_scan"
                buckets = [b for b in mfu if b.startswith(prog + "/")]
                if len(buckets) != 1 or (label != "chunked" and set(mfu) != set(buckets)):
                    raise AssertionError(f"telemetry run {label}: train buckets {sorted(mfu)}")
                own, flops, own_ms, peak, own_times = _own_mfu(
                    run["state"], config["NeuralNetwork"]["Training"], batches, device,
                    staged=prog == "epoch_scan")
                ratio = mfu[buckets[0]]["mfu"] / own
                line["own_mfu"] = {"mfu": own, "flops": flops, "ms_per_step": own_ms,
                                   "peak_flops": peak, "ratio": ratio,
                                   "passes_ms_per_step": [round(t, 4) for t in own_times]}
                line["step_ms"] = run["step_ms"]
                if abs(ratio - 1.0) > TELEMETRY_MFU_TOL:
                    problems.append(f"telemetry run {label}: MFU {mfu[buckets[0]]} against the "
                                    f"smoke's own {line['own_mfu']}")
        if scraped:
            missing = [k for k in TELEMETRY_REQUIRE if k not in line["events"]]
            if missing:
                raise AssertionError(f"telemetry run {label}: no {missing} in the stream")
            text, health = scrapes["metrics"], scrapes["health"]
            for needle in ("hydragnn_train_epochs_total", "hydragnn_train_graphs_per_second",
                           "hydragnn_train_guard_skips_total 1",
                           "hydragnn_train_heartbeat_age_seconds"):
                if needle not in text:
                    raise AssertionError(f"the mid-run /metrics lacks {needle!r}")
            if health.get("status") != "ok" or scrapes["profile"].get("status") != "armed":
                raise AssertionError(f"mid-run /healthz {health}, /profile {scrapes['profile']}")
            done = [r for r in records if r["event"] == "profile" and r["status"] == "done"]
            if not done:
                raise AssertionError(f"the trace never finished: "
                                     f"{[r for r in records if r['event'] == 'profile']}")
            names = _trace_kernels(done[0]["trace"]) if device.type == "cuda" else set()
            found = {k: sorted(n for n in names if sub in n)[:1]
                     for k, sub in TRACE_KERNELS.items()}
            if device.type == "cuda" and not all(found.values()):
                raise AssertionError(f"the trace names no kernel of {TRACE_KERNELS}: {found}")
            line.update(scrape={"metrics_bytes": len(text), "health": health,
                                "profile": scrapes["profile"]},
                        trace={"path": done[0]["trace"], "kernels": found,
                               "kernel_names": len(names)},
                        report=_budget_checks(run["stream"].parent, root, device))
        if chunked:
            line["sync_checked_chunks"] = run["sync_checked_chunks"]
        if device.type == "cuda":
            line["clocks_after"] = clocks_line()
        line["phase_s"] = time.perf_counter() - t0
        emit({"telemetry": {**line, "card": card}})
    # every staged run's epochs past the first (which captures), pooled by side
    epochs = {label: results[label]["ms_per_step"][1:] for label, _ in TELEMETRY_OVERHEAD_RUNS}
    on_ms = [t for label, telemetry in TELEMETRY_OVERHEAD_RUNS if telemetry for t in epochs[label]]
    off_ms = [t for label, telemetry in TELEMETRY_OVERHEAD_RUNS if not telemetry
              for t in epochs[label]]
    spread = max((max(epochs[label]) - min(epochs[label])) / float(np.median(epochs[label]))
                 for label, telemetry in TELEMETRY_OVERHEAD_RUNS if not telemetry)
    ratio = float(np.median(on_ms)) / float(np.median(off_ms))
    overhead = {"ms_per_step_on": float(np.median(on_ms)),
                "ms_per_step_off": float(np.median(off_ms)),
                "ratio": ratio, "off_spread": spread,
                "limit": max(TELEMETRY_OVERHEAD, spread),
                "runs": {label: {"telemetry": telemetry,
                                 "ms_per_step_median": float(np.median(epochs[label]))}
                         for label, telemetry in TELEMETRY_OVERHEAD_RUNS}}
    emit({"telemetry": {"overhead": overhead, "card": card}})
    if device.type == "cuda" and abs(ratio - 1.0) > overhead["limit"]:
        problems.append(f"telemetry overhead: {overhead}")
    # the CLI's other reports on the serving phases' streams, where this run
    # had them (the fleet's and the tenancy's; not with --only-telemetry)
    smoke = _build.REPO_ROOT / "build" / "chip_smoke"
    clis = {}
    for command, where in (("fleet", smoke / "fleet"), ("drift", smoke / "fleet"),
                           ("trace", smoke / "tenancy")):
        if where.exists():
            rc, out, err = _obs_cli([command, str(where)])
            clis[command] = {"exit": rc, "lines": out.count("\n")}
            if rc != 0:
                problems.append(f"obs {command} {where} exited {rc}: {err.strip()}")
    emit({"telemetry": {"cli_on_serving_streams": clis or "not run: no serving phase's streams",
                        "card": card}})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


# ---- phase 8: the streaming data plane ----------------------------------------


# examples/multidataset/train.py's FAMILIES: elements, atom counts [lo, hi), spread
STREAM_FAMILIES = {
    "molecules": dict(elements=[1, 6, 7, 8], n_lo=4, n_hi=16, spread=1.5),
    "clusters": dict(elements=[26, 28, 78], n_lo=4, n_hi=10, spread=2.2),
    "oxides": dict(elements=[8, 22, 26], n_lo=6, n_hi=14, spread=2.0),
}
STREAM_SAMPLES = 4000  # per family (the users' scale is larger: cut)
STREAM_SHARDS = 16  # each train split's shards: the 2-shard window really bounds residency
STREAM_EPOCHS = 3  # gfm.json's 10, cut
STREAM_QUEUE = 4  # HYDRAGNN_STREAM_QUEUE: the collation thread's batches ahead
STREAM_WORKERS = 4  # HYDRAGNN_NUM_WORKERS of the pool held against one worker
STREAM_FEEDBACK = dict(graphs=40, max_graphs=16)  # served graphs, graphs a pack
STREAM_REHEARSAL = dict(samples=60, shards=4, hidden=8, layers=2, batch=4, dispatch=2)
# resumes of one checkpoint: their mean parameter distance from the
# uninterrupted run's epoch 2, over the leaves outside the loss's null space,
# against their mean distance from one another (on the H100 one pair's
# distance moves 0.02-0.09 between runs, the ratio 0.9-1.7; AdamW moments
# zeroed lie 6.6-31x away)
STREAM_PARAM_FACTOR = 2.5
STREAM_REJOINS = ("rejoin_a", "rejoin_b", "rejoin_c")
# a leaf whose gradient (the root mean square of its AdamW nu) is below this
# share of the median leaf's lies in the loss's null space (_null_leaves)
STREAM_NULL_GRADIENT = 1e-3


def _random_molecule(rng, elements, n_atoms, spread):
    """``examples/common.py``'s ``random_molecule``: atomic numbers and
    jittered positions, overlapping atoms pushed apart."""
    z = rng.choice(elements, size=n_atoms)
    pos = rng.normal(0.0, spread, (n_atoms, 3))
    for _ in range(10):
        d = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(d, axis=-1) + np.eye(n_atoms)
        push = (dist < 0.8) & ~np.eye(n_atoms, dtype=bool)
        if not push.any():
            break
        pos += 0.25 * (d / dist[..., None] * push[..., None]).sum(axis=1)
    return z.astype(np.float32), pos.astype(np.float32)


def _pairwise_energy(z, pos, cutoff=3.0):
    """``examples/common.py``'s ``pairwise_energy`` label."""
    zz = np.asarray(z, np.float64)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    n = len(zz)
    mask = (d < cutoff) & ~np.eye(n, dtype=bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        contrib = np.where(mask, np.sqrt(zz[:, None] * zz[None, :]) / (d + 1.0), 0.0)
    return float(contrib.sum() / (2 * n))


def write_stream_data(root, samples, shards, radius, max_neighbours):
    """The three families of ``examples/multidataset/train.py`` as shard
    stores under ``root``: ``samples`` each, split 90/5/5
    (``split_dataset``), the train split in ``shards`` shards (ranks
    0..shards-1 of one directory), validation and test in one each.
    Returns ``{family: {split: directory}}``."""
    import zlib

    from hydragnn_tpu_torch.data.radius_graph import radius_graph
    from hydragnn_tpu_torch.data.shard_store import ShardWriter
    from hydragnn_tpu_torch.data.split import split_dataset

    out = {}
    for name, spec in STREAM_FAMILIES.items():
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        graphs = []
        for _ in range(samples):
            z, pos = _random_molecule(rng, spec["elements"],
                                      int(rng.integers(spec["n_lo"], spec["n_hi"])),
                                      spec["spread"])
            d = GraphData(x=z.reshape(-1, 1), pos=pos)
            d.edge_index = radius_graph(pos, radius, max_neighbours)
            d.targets = [np.asarray([_pairwise_energy(z, pos)], np.float32)]
            d.target_types = ["graph"]
            graphs.append(d)
        splits = split_dataset(graphs, 0.9, False)
        out[name] = {}
        for split, ds in zip(("trainset", "valset", "testset"), splits):
            label = str(root / f"{name}_{split}")
            parts = np.array_split(np.arange(len(ds)), shards if split == "trainset" else 1)
            for rank, part in enumerate(parts):
                w = ShardWriter(label, rank=rank)
                w.add([ds[i] for i in part])
                w.save()
            out[name][split] = label
    return out


def stream_config(data, rehearsal, epochs, extra_training=None):
    """``examples/multidataset/gfm.json`` at its full width (rehearsal:
    tiny), with one shard-store source per family (its ``weights`` as the
    sources' weights) and ``epochs`` epochs, a resumable save each."""
    with open(_build.REPO_ROOT / "examples" / "multidataset" / "gfm.json") as f:
        config = json.load(f)
    config["Verbosity"]["level"] = 0
    scfg = config["Dataset"]["streaming"]
    weights = scfg.pop("weights")
    scfg["sources"] = [{"format": "shard_store", "name": fam, "train": paths["trainset"],
                        "validate": paths["valset"], "test": paths["testset"],
                        "weight": float(weights[fam])} for fam, paths in data.items()]
    training = config["NeuralNetwork"]["Training"]
    training.update(num_epoch=epochs, resume_every=1, **(extra_training or {}))
    if rehearsal:
        r = STREAM_REHEARSAL
        config["NeuralNetwork"]["Architecture"].update(hidden_dim=r["hidden"],
                                                       num_conv_layers=r["layers"])
        training.update(batch_size=r["batch"], steps_per_dispatch=r["dispatch"])
    return config


def batch_digest(batch):
    """A short digest of a host batch's tensors (its samples, in order)."""
    import hashlib

    h = hashlib.sha1()
    for t in batch.leaves()[1]:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _stream_run(workdir, config, env, device, digests_path=None, restored=None):
    """One ``run_training`` of a streaming ``config`` under ``env`` in
    ``workdir``. Hooks record what the run keeps no record of:

    - ``Trainer._batches``: each training batch with its epoch, held by
      reference and digested (:func:`batch_digest`) after the run, so no
      hashing falls in the step loop's timed data wait (with
      ``digests_path``: digested as it comes and appended to that file line
      by line, so a killed run leaves them); and the evaluation batches,
      counted;
    - ``runtime.stream_epoch_stats``: each epoch's stream statistics (the
      ``stream_*`` gauges: no event carries them, as in the JAX package);
    - with ``restored`` (a dict), ``Trainer.train_epoch``: the state and
      the mix cursor that the first training pass starts from, before its
      first step.

    The rest comes from the run's own records (:func:`_stream_line`): step
    times from its ``goodput`` events, captures from its ``compile``
    events, cursors from its rolling checkpoints. The dispatches are
    ``Trainer._group_plan`` over each epoch's batches. Returns what it
    recorded."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.models.bridge import state_dict_of
    from hydragnn_tpu_torch.obs import runtime
    from hydragnn_tpu_torch.train.checkpoint import _to_host
    from hydragnn_tpu_torch.utils import tracer

    rec = {"train": [], "eval": 0, "stats": []}
    held = []
    sink = open(digests_path, "a", buffering=1) if digests_path else None
    orig_batches = Trainer._batches

    def batches(self, loader, nbatch=None):
        streaming = getattr(loader, "reports_stream_stats", False)
        for batch in orig_batches(self, loader, nbatch):
            if not streaming:
                rec["eval"] += 1
            elif sink is not None:
                sink.write(json.dumps([int(loader.epoch), batch_digest(batch)]) + "\n")
            else:
                held.append((int(loader.epoch), batch))
            yield batch

    orig_stats = runtime.stream_epoch_stats

    def stats(**kw):
        rec["stats"].append(kw)
        return orig_stats(**kw)

    patches = contextlib.ExitStack()
    patches.enter_context(_patched(Trainer, "_batches", batches))
    patches.enter_context(_patched(runtime, "stream_epoch_stats", stats))
    if restored is not None:
        orig_epoch = Trainer.train_epoch

        def train_epoch(self, state, loader):
            if not restored:
                restored["state"] = _to_host(state_dict_of(state), copy=True)
                restored["cursor"] = _plain(loader.state_dict())
            return orig_epoch(self, state, loader)
        patches.enter_context(_patched(Trainer, "train_epoch", train_epoch))
    try:
        with run_directory(workdir, env), patches:
            reset_launch_counts()
            reset_capture_counts()
            t0 = time.perf_counter()
            state = run_training(copy.deepcopy(config), device=device)
            rec["wall_s"] = time.perf_counter() - t0
            rec["launches"], rec["programs"] = launch_counts(), capture_counts()
            rec["tracers"] = sorted(tracer._tracers)
    finally:
        if sink is not None:
            sink.close()
    t0 = time.perf_counter()
    rec["train"] = [[e, batch_digest(b)] for e, b in held]
    rec["digest_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / max(len(held), 1)
    K = int(config["NeuralNetwork"]["Training"].get("steps_per_dispatch", 1))
    groups = [len(g) for e in sorted({e for e, _ in held})
              for g in Trainer._group_plan([b for f, b in held if f == e], K)]
    rec["dispatch"] = {"train_step": sum(1 for n in groups if n == 1),
                       "train_multi": sum(1 for n in groups if n > 1)}
    del held
    rec["history"] = state.info["history"]
    rec["log_name"] = state.info["log_name"]
    rec["final_cursor"] = _plain(state_meta_stream(workdir, rec["log_name"])[0])
    return rec


def _plain(tree):
    """A cursor's nested dict with numpy scalars as ints (comparable, JSON)."""
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()}
    return int(np.asarray(tree))


def state_meta_stream(workdir, log_name, epoch=None):
    """``(stream cursor, state dict)`` of the run's newest checkpoint, or
    of the rolling copy saved after ``epoch``."""
    from hydragnn_tpu_torch.train.checkpoint import (
        load_state_dict,
        parse_checkpoint_bytes,
        pop_train_meta,
        rolling_checkpoints,
    )

    logs = str(pathlib.Path(workdir) / "logs")
    if epoch is None:
        sd = load_state_dict(log_name, path=logs + "/")
        return pop_train_meta(sd)["stream"], sd
    for path in rolling_checkpoints(log_name, path=logs + "/"):
        with open(path, "rb") as f:
            sd = parse_checkpoint_bytes(f.read(), path)
        meta = pop_train_meta(sd)
        if int(np.asarray(meta["epoch"])) == epoch:
            return meta["stream"], sd
    raise AssertionError(f"no rolling checkpoint of epoch {epoch} under {logs}")


def _tree_leaves(tree, prefix=""):
    """``{path: array}`` of a nested dict's leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_tree_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _hold_bitwise(got, want, what):
    """Two state dicts with the same leaves, dtypes, shapes and bytes."""
    a, b = _tree_leaves(got), _tree_leaves(want)
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: leaves {sorted(a.keys() ^ b.keys())} are not in both")
    for k in a:
        if (a[k].dtype, a[k].shape) != (b[k].dtype, b[k].shape) or \
                a[k].tobytes() != b[k].tobytes():
            raise AssertionError(f"{what}: {k} differs ({a[k].dtype}{a[k].shape} against "
                                 f"{b[k].dtype}{b[k].shape})")
    return len(a)


def _adam_nu(sd):
    """The AdamW second moments of a checkpoint's state dict, as its
    ``params`` tree (the ``nu`` subtree of ``opt_state``)."""
    def find(t):
        if isinstance(t, dict):
            if "nu" in t:
                return t["nu"]
            for v in t.values():
                found = find(v)
                if found is not None:
                    return found
        return None
    nu = find(sd["opt_state"])
    if nu is None:
        raise AssertionError("the checkpoint's opt_state holds no AdamW nu")
    return nu


def _null_leaves(sd):
    """``({leaf: reference gradient}, the leaves in the loss's null space)``:
    a leaf's reference gradient is the root mean square of its AdamW
    ``nu`` (the running mean of its squared gradients) in ``sd``; a leaf
    whose reference gradient is below :data:`STREAM_NULL_GRADIENT` times
    the median leaf's has no gradient but rounding (a bias in front of a
    BatchNorm, which cancels it): Adam turns that rounding into steps of
    the learning rate's size in random directions, so two sound runs part
    there by the rate times the steps, whatever the rest does."""
    grad = {k: float(np.sqrt(np.mean(np.asarray(v, np.float64))))
            for k, v in _tree_leaves(_adam_nu(sd)).items()}
    floor = STREAM_NULL_GRADIENT * float(np.median(list(grad.values())))
    return grad, sorted(k for k, g in grad.items() if g < floor)


def _param_distance(a, b, skip=()):
    """``(relative L2 over the leaves not in skip, {leaf: relative L2})``
    between two checkpoints' parameters."""
    la, lb = _tree_leaves(a["params"]), _tree_leaves(b["params"])
    per, num, den = {}, 0.0, 0.0
    for k in la:
        x, y = np.asarray(la[k], np.float64), np.asarray(lb[k], np.float64)
        d, n = float(np.sum((x - y) ** 2)), float(np.sum(x ** 2))
        per[k] = float(np.sqrt(d / max(n, 1e-300)))
        if k not in skip:
            num, den = num + d, den + n
    return float(np.sqrt(num / max(den, 1e-300))), per


def _plant_resume(src, dst, log_name, epoch, change=None):
    """A copy of the run directory ``src`` at ``dst`` that a resume
    continues after ``epoch``: its primary checkpoint is its rolling copy
    of that epoch (the later ones removed), altered by ``change(state
    dict)`` when given (a planted bad resume)."""
    from hydragnn_tpu_torch.train.checkpoint import (
        TRAIN_META_KEY,
        encode,
        parse_checkpoint_bytes,
        rolling_checkpoints,
    )

    shutil.copytree(src, dst)
    logs = str(pathlib.Path(dst) / "logs") + "/"
    chosen = None
    for path in rolling_checkpoints(log_name, path=logs):
        with open(path, "rb") as f:
            sd = parse_checkpoint_bytes(f.read(), path)
        saved = int(np.asarray(sd[TRAIN_META_KEY]["epoch"]))
        if saved == epoch:
            chosen = sd
        elif saved > epoch:
            os.remove(path)
    if chosen is None:
        raise AssertionError(f"no rolling checkpoint of epoch {epoch} under {logs}")
    if change is not None:
        change(chosen)
    (pathlib.Path(logs) / log_name / f"{log_name}.pk").write_bytes(encode(chosen))


def _stream_launch_check(label, rec, cfg, mode, device):
    """The run's K1/K2/K3 launches against its steps and forwards, exactly:
    (train steps + warm-up steps) times one step's and (evaluation batches
    + warm-up forwards) times one forward's."""
    per_step = launches_per_train_step(cfg, mode)
    per_forward = launches_per_forward(cfg, mode)
    steps, forwards = len(rec["train"]), rec["eval"]
    p = rec["programs"]
    expected = {k: (steps + p["warm_steps"]) * per_step[k]
                + (forwards + p["warm_forwards"]) * per_forward[k] for k in KERNELS}
    got = dict(rec["launches"])
    if device.type == "cuda" and got != expected:
        raise AssertionError(f"stream run {label}: launched {got}, expected {expected} "
                             f"({steps} steps, {forwards} forwards, programs {p})")
    if device.type == "cuda":
        used = {k for k, v in per_step.items() if v}
        if not all(got[k] > 0 for k in used):
            raise AssertionError(f"stream run {label}: a kernel of the path never launched: {got}")
    return {"steps": steps, "forwards": forwards, "warm_steps": p["warm_steps"],
            "warm_forwards": p["warm_forwards"], "captures": p["captures"],
            "launches": {k: v for k, v in got.items() if v}}


def _run_events(workdir, rec):
    """The run's own records in its ``events.jsonl`` (validated): a resumed
    run appends to the killed run's stream, so from its own manifest on."""
    stream = pathlib.Path(workdir) / "logs" / rec["log_name"] / "events.jsonl"
    records = validate_events(str(stream), require=["bucket_plan", "compile", "epoch",
                                                    "goodput"])
    start = max(i for i, r in enumerate(records) if r["event"] == "run_manifest")
    return records[start:]


def _captures_by_program(records, first):
    """``{program: {epoch: captures}}`` from the run's compile events (a
    capture belongs to the epoch whose event follows it)."""
    out, epoch = {}, first
    for r in records:
        if r["event"] == "epoch":
            epoch = int(r["epoch"]) + 1
        elif r["event"] == "compile":
            per = out.setdefault(r["name"], {})
            per[epoch] = per.get(epoch, 0) + 1
    return {name: {str(e): n for e, n in sorted(per.items())} for name, per in out.items()}


def _stream_line(label, rec, workdir, window, bound_bytes, launch):
    """The run's ``{"stream": ...}`` line: per epoch its steps, ms a step
    (the epoch's ``goodput`` compute, the CUDA-event step times less the
    captures', over its steps), device busy share (that compute over the
    epoch's train wall), stall seconds, stream bytes/s, the residency
    peaks; the tracer's region seconds over the run; the captures by
    program and epoch; the dispatches; the launches; the cost of one
    batch's digest (taken after the run). Holds the residency to one
    window per source."""
    records = _run_events(workdir, rec)
    goodput = {int(r["epoch"]): r for r in records if r["event"] == "goodput"}
    epochs = []
    for h, st in zip(rec["history"], rec["stats"]):
        e = h["epoch"]
        g = goodput[e]
        compute = g["seconds"]["compute"]
        epochs.append({
            "epoch": e, "steps": g["steps"],
            "ms_per_step": 1e3 * compute / g["steps"] if g["steps"] else None,
            "busy_share": compute / h["train_s"] if h["train_s"] else None,
            "compile_s": g["seconds"]["compile"],
            "train_s": h["train_s"], "stall_s": st["stall_s"],
            "stream_bytes_per_s": st["bytes_per_sec"],
            "open_shards_peak": st["open_shards_peak"],
            "resident_bytes_peak": st["resident_bytes_peak"],
            "oversize_dropped": st["oversize_dropped"], "samples": st["samples"],
            "train_loss": h["train_loss"], "val_loss": h["val_loss"],
        })
        if st["open_shards_peak"] > window or st["resident_bytes_peak"] > bound_bytes:
            raise AssertionError(
                f"stream run {label} epoch {e}: {st['open_shards_peak']} shards and "
                f"{st['resident_bytes_peak']} bytes resident, past one window per source "
                f"({window} shards, {bound_bytes} bytes)")
        if st["oversize_dropped"]:
            raise AssertionError(f"stream run {label} epoch {e}: {st['oversize_dropped']} "
                                 "samples fit no bucket")
        if not np.isfinite(h["train_loss"]) or not np.isfinite(h["val_loss"]):
            raise AssertionError(f"stream run {label} epoch {e}: a loss is not finite")
    regions = [r["regions"] for r in records if r["event"] == "tracer_totals"][-1:]
    first = rec["history"][0]["epoch"] if rec["history"] else 0
    line = {"run": label, "wall_s": rec["wall_s"], "epochs": epochs,
            "tracer_regions_s": regions[0] if regions else None,
            "residency_bound_bytes": bound_bytes,
            "captures_by_program": _captures_by_program(records, first),
            "dispatch": rec["dispatch"], "digest_ms_per_batch": rec["digest_ms_per_batch"],
            "tracers": rec["tracers"], **launch}
    emit({"stream": line})
    return line


def _stream_worker(spec_path):
    """``--stream-run SPEC``: one :func:`_stream_run` in a process of its
    own (the run the fault hook kills); its digests go to the spec's file."""
    with open(spec_path) as f:
        spec = json.load(f)
    device = torch.device(spec["device"])
    _stream_run(pathlib.Path(spec["workdir"]), spec["config"], spec["env"], device,
                digests_path=spec["digests"])
    return 0


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _same_batches(a, b, device, what):
    """Two loaders' epochs give equal batches (compared on ``device``)."""
    n = 0
    for x, y in zip(a, b):
        for s, t in zip(x.leaves()[1], y.leaves()[1]):
            if not torch.equal(s.to(device), t.to(device)):
                raise AssertionError(f"{what}: batch {n} differs")
        n += 1
    return n


def phase_stream(device, card, rehearsal):
    """Phase 8, the streaming data plane (``data/stream/``,
    ``data/shard_store.py``): ``examples/multidataset/gfm.json`` at its full
    width (PNA, hidden 64, 4 conv layers, a graph head of 2 shared layers of
    32 and head layers [64, 32], batch 64, AdamW 2e-3, ``steps_per_dispatch``
    32, a 2-shard window, 4 auto buckets, seed 42, weights 2/1/1) through
    ``run_training`` with one shard-store source per family
    (:func:`write_stream_data`: :data:`STREAM_SAMPLES` samples a family,
    the train splits in :data:`STREAM_SHARDS` shards; samples and epochs
    cut, widths not), the collation thread on (:data:`STREAM_QUEUE`):

    - ``fused`` (K3 and K1) for :data:`STREAM_EPOCHS` epochs, uninterrupted;
    - the same killed mid-epoch 2 by ``HYDRAGNN_FAULT_KILL_AT_STEP`` (a
      process of its own, :func:`_stream_worker`), then resumed: the
      killed run's saved cursor equals the uninterrupted run's after epoch
      1, the resumed run's state (parameters, BatchNorm statistics, AdamW
      moments and step) and cursor before its first step equal the killed
      run's epoch-1 checkpoint bit for bit, its final cursor is the
      uninterrupted run's, and the batch digests of both runs equal the
      uninterrupted run's step for step, exactly;
    - the parameters after epoch 2, over the leaves outside the loss's null
      space (:func:`_null_leaves`), from one state: resumes of the
      uninterrupted run's epoch-1 checkpoint (:data:`STREAM_REJOINS`; their
      mean mutual distance: the atomics' spread over an epoch) within
      :data:`STREAM_PARAM_FACTOR` times that spread of the uninterrupted
      run's epoch 2 on average, and a planted bad resume of it (the AdamW
      moments zeroed) outside it; the epoch-0 weights resumed and the
      killed-and-resumed run (the killed run parts from the uninterrupted
      one before its kill) are reported;
    - ``fused`` for one epoch with the collation inline
      (``HYDRAGNN_STREAM_QUEUE=0``: its stall is the data plane's whole host
      time), its batches the threaded run's;
    - ``segment`` (K2 and K1) for one epoch.

    Each run's launches are held exactly against its steps and forwards and
    its residency to one window per source; one ``{"stream": ...}`` line a
    run. Then the collation pool (:data:`STREAM_WORKERS` workers against
    one, the same batches), ``DistDataset`` (two stores on free ports feed a
    ``GraphLoader`` through an epoch; the batches on the card equal the
    local ones), ``FeedbackSink`` (a server's answered graphs flushed as
    packs that ``ShardDataset`` reads back equal) and the tracer's
    ``native`` backend. Returns the launches of the three in-process runs."""
    from hydragnn_tpu_torch.data.loaders import ConcatDataset, GraphLoader
    from hydragnn_tpu_torch.data.distdataset import DistDataset
    from hydragnn_tpu_torch.data.shard_store import ShardDataset
    from hydragnn_tpu_torch.data.stream import BucketPlanner, ShardStoreSource, sample_nbytes
    from hydragnn_tpu_torch.serve.quality import FeedbackSink

    t0 = time.perf_counter()
    root = _build.REPO_ROOT / "build" / "chip_smoke" / "stream"
    if root.exists():
        shutil.rmtree(root)
    r = STREAM_REHEARSAL
    base = stream_config({}, rehearsal, STREAM_EPOCHS)
    arch_cfg = base["NeuralNetwork"]["Architecture"]
    scfg = base["Dataset"]["streaming"]
    window = int(scfg["window_shards"])
    data = write_stream_data(root / "dataset", r["samples"] if rehearsal else STREAM_SAMPLES,
                             r["shards"] if rehearsal else STREAM_SHARDS,
                             arch_cfg["radius"], arch_cfg["max_neighbours"])
    t_data = time.perf_counter() - t0
    # one window per source: the two largest shards of each train store
    bound_bytes = 0
    for paths in data.values():
        src = ShardStoreSource(paths["trainset"])
        sizes = sorted(sum(sample_nbytes(d) for d in src.read_shard(i))
                       for i in range(src.num_shards()))
        bound_bytes += sum(sizes[-window:])
    cfg = dict(arch_cfg, equivariance=False)
    fused_env = {"HYDRAGNN_AGG": "fused", "HYDRAGNN_STREAM_QUEUE": str(STREAM_QUEUE)}
    config = stream_config(data, rehearsal, STREAM_EPOCHS)
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    full = _stream_run(root / "full", config, fused_env, device)
    full_launch = _stream_launch_check("full", full, cfg, "fused", device)
    add(full["launches"])
    _stream_line("full", full, root / "full", window, bound_bytes, full_launch)
    per_epoch = [sum(1 for e, _ in full["train"] if e == k) for k in range(STREAM_EPOCHS)]
    kill_step = per_epoch[0] + per_epoch[1] + per_epoch[2] // 2
    log_name = full["log_name"]

    # the killed run: a process of its own, killed mid-epoch 2
    killed_dir = root / "killed"
    killed_dir.mkdir(parents=True)
    spec = {"workdir": str(killed_dir), "config": config, "device": str(device),
            "env": dict(fused_env, HYDRAGNN_FAULT_KILL_AT_STEP=str(kill_step)),
            "digests": str(root / "killed_digests.jsonl")}
    spec_path = root / "killed_spec.json"
    spec_path.write_text(json.dumps(spec))
    t_kill = time.perf_counter()
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                           "--stream-run", str(spec_path)], cwd=str(_build.REPO_ROOT),
                          capture_output=True, text=True, timeout=600)
    t_kill = time.perf_counter() - t_kill
    if proc.returncode != faults.KILL_EXIT_CODE:
        raise AssertionError(f"the killed stream run exited {proc.returncode}, not "
                             f"{faults.KILL_EXIT_CODE}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    killed = [json.loads(ln) for ln in (root / "killed_digests.jsonl").read_text().splitlines()]
    if killed != full["train"][: len(killed)] or len(killed) < kill_step + 1:
        raise AssertionError(f"the killed run's {len(killed)} batch digests differ from the "
                             f"uninterrupted run's (killed at step {kill_step})")
    cursor_killed, sd_killed = state_meta_stream(killed_dir, log_name, epoch=1)
    cursor_full_1, sd_full_1 = state_meta_stream(root / "full", log_name, epoch=1)
    if _plain(cursor_killed) != _plain(cursor_full_1):
        raise AssertionError(f"the killed run saved cursor {_plain(cursor_killed)} after epoch "
                             f"1, the uninterrupted run {_plain(cursor_full_1)}")

    # the resume, from the killed run's checkpoint: its state and cursor
    # before the first step are the checkpoint's, bit for bit
    resume_config = copy.deepcopy(config)
    resume_config["NeuralNetwork"]["Training"]["continue"] = 1
    restored = {}
    resumed = _stream_run(killed_dir, resume_config, fused_env, device, restored=restored)
    restored_leaves = _hold_bitwise(restored["state"], sd_killed,
                                    "the resumed run's state before its first step against "
                                    "the killed run's epoch-1 checkpoint")
    # the saved cursor, its epoch moved on to the first resumed one
    start_cursor = _plain(cursor_killed)
    start_cursor["epoch"] = start_cursor["mix"]["epoch"] = 2
    if restored["cursor"] != start_cursor:
        raise AssertionError(f"the resumed run started epoch 2 from cursor "
                             f"{restored['cursor']}, not the killed run's saved {start_cursor}")
    resumed_launch = _stream_launch_check("resumed", resumed, cfg, "fused", device)
    add(resumed["launches"])
    _stream_line("resumed", resumed, killed_dir, window, bound_bytes, resumed_launch)
    tail = [item for item in full["train"] if item[0] == 2]
    if resumed["train"] != tail:
        raise AssertionError(f"the resumed run's {len(resumed['train'])} batch digests differ "
                             f"from the uninterrupted run's epoch 2 ({len(tail)})")
    if resumed["final_cursor"] != full["final_cursor"]:
        raise AssertionError(f"the resumed run's final cursor {resumed['final_cursor']} is not "
                             f"the uninterrupted run's {full['final_cursor']}")

    # the parameters: the killed run parts from the uninterrupted one
    # before its kill (the atomics, amplified by training), so its resume
    # is held on the data and the restored state above. The parameter hold
    # runs from one state: resumes of the uninterrupted run's epoch-1
    # checkpoint (:data:`STREAM_REJOINS`; their mutual distance: the
    # atomics' spread over one epoch) against its own epoch 2, and a
    # planted bad resume of it (the AdamW moments zeroed) outside; another
    # (the epoch-0 weights with the moments, step and cursor of epoch 1) is
    # reported, a wrong-epoch load failing the restored-state hold above.
    # Distances over the leaves outside the loss's null space
    # (:func:`_null_leaves`). Each run sees the uninterrupted run's epoch-2
    # batches.
    _, sd_full_0 = state_meta_stream(root / "full", log_name, epoch=0)
    _, sd_killed_0 = state_meta_stream(killed_dir, log_name, epoch=0)

    def zeros(tree):
        return ({k: zeros(v) for k, v in tree.items()} if isinstance(tree, dict)
                else np.zeros_like(np.asarray(tree)))

    def zero_moments(sd):
        def walk(t):
            for k, v in t.items():
                if k in ("mu", "nu"):
                    t[k] = zeros(v)
                elif isinstance(v, dict):
                    walk(v)
        walk(sd["opt_state"])

    def stale_weights(sd):
        sd["params"], sd["batch_stats"] = sd_full_0["params"], sd_full_0["batch_stats"]

    plants = {**{name: None for name in STREAM_REJOINS}, "zeroed": zero_moments,
              "stale": stale_weights}
    sds = {"full": state_meta_stream(root / "full", log_name, epoch=2)[1],
           "resumed": state_meta_stream(killed_dir, log_name, epoch=2)[1]}
    losses = {"full": full["history"][2]["train_loss"],
              "resumed": resumed["history"][0]["train_loss"]}
    for name, change in plants.items():
        _plant_resume(root / "full", root / name, log_name, 1, change)
        run = _stream_run(root / name, resume_config, fused_env, device)
        add(_stream_launch_check(name, run, cfg, "fused", device)["launches"])
        if run["train"] != tail:
            raise AssertionError(f"the {name} run's batch digests differ from the "
                                 "uninterrupted run's epoch 2")
        sds[name] = state_meta_stream(root / name, log_name, epoch=2)[1]
        losses[name] = run["history"][0]["train_loss"]
    grads, null = _null_leaves(sds["full"])
    names = list(sds)
    pairs = {f"{x}~{y}": _param_distance(sds[x], sds[y], null)
             for i, x in enumerate(names) for y in names[i + 1:]}
    spread = float(np.mean([pairs[f"{x}~{y}"][0] for i, x in enumerate(STREAM_REJOINS)
                            for y in STREAM_REJOINS[i + 1:]]))
    distance = float(np.mean([pairs[f"full~{x}"][0] for x in STREAM_REJOINS]))
    tolerance = STREAM_PARAM_FACTOR * spread
    _, per_all = _param_distance(sds["full"], sds["rejoin_a"])
    sq = {k: d ** 2 * float(np.sum(np.asarray(x, np.float64) ** 2))
          for (k, d), x in zip(per_all.items(), _tree_leaves(sds["full"]["params"]).values())}
    null_share = sum(sq[k] for k in null) / max(sum(sq.values()), 1e-300)
    resume = {"kill_step": kill_step, "killed_steps": len(killed), "kill_run_s": t_kill,
              "digests_equal": True, "cursor_equal": True, "steps_per_epoch": per_epoch,
              "restored_bitwise_leaves": restored_leaves,
              "null_leaves": null, "null_gradient_ratio": STREAM_NULL_GRADIENT,
              "null_share_of_distance": null_share,
              "killed_rel_spread": {"epoch0": _param_distance(sd_full_0, sd_killed_0, null)[0],
                                    "epoch1": _param_distance(sd_full_1, sd_killed, null)[0],
                                    "epoch2": pairs["full~resumed"][0]},
              "rel_distance": {k: d for k, (d, _) in pairs.items()},
              "param_distance": distance, "param_spread": spread,
              "param_factor": STREAM_PARAM_FACTOR,
              "param_tolerance": tolerance, "train_loss_epoch2": losses}
    emit({"stream_resume": resume})
    emit({"stream_resume_leaves": {
        k: {"grad": grads[k], "null": k in null,
            **{p: pairs[p][1][k] for p in ("full~rejoin_a", "rejoin_a~rejoin_b",
                                           "full~zeroed", "full~stale", "full~resumed")}}
        for k in grads}})
    if distance > tolerance:
        raise AssertionError(f"resumes of the uninterrupted run's epoch-1 checkpoint lie "
                             f"{distance} from its epoch 2 on average, past {tolerance} "
                             f"({STREAM_PARAM_FACTOR} x their mean distance {spread})")
    if pairs["full~zeroed"][0] <= tolerance:
        raise AssertionError(f"the planted resume with zeroed moments lies "
                             f"{pairs['full~zeroed'][0]} from the uninterrupted run, within "
                             f"the hold's {tolerance}: the hold cannot tell a bad resume")

    # the collation inline (no thread): its stall is the whole data plane's
    # host time; its batches are the threaded run's
    inline_env = {"HYDRAGNN_AGG": "fused", "HYDRAGNN_STREAM_QUEUE": "0"}
    inline = _stream_run(root / "inline", stream_config(data, rehearsal, 1), inline_env, device)
    inline_launch = _stream_launch_check("inline", inline, cfg, "fused", device)
    add(inline["launches"])
    _stream_line("inline", inline, root / "inline", window, bound_bytes, inline_launch)
    if inline["train"] != [item for item in full["train"] if item[0] == 0]:
        raise AssertionError("the inline run's epoch-0 batches differ from the threaded run's")

    # segment mode: K2 and K1, one epoch
    seg_env = {"HYDRAGNN_AGG": "segment", "HYDRAGNN_STREAM_QUEUE": str(STREAM_QUEUE)}
    seg = _stream_run(root / "segment", stream_config(data, rehearsal, 1), seg_env, device)
    seg_launch = _stream_launch_check("segment", seg, cfg, "segment", device)
    add(seg["launches"])
    _stream_line("segment", seg, root / "segment", window, bound_bytes, seg_launch)
    if seg["train"] != [item for item in full["train"] if item[0] == 0]:
        raise AssertionError("the segment run's epoch-0 batches differ from the fused run's")

    # the collation pool against one worker, over the train stores with the run's plan
    sources = [ShardStoreSource(p["trainset"], name=f) for f, p in data.items()]
    val = ConcatDataset([ShardDataset(p["valset"]) for p in data.values()])
    test = ConcatDataset([ShardDataset(p["testset"]) for p in data.values()])
    batch_size = int(config["NeuralNetwork"]["Training"]["batch_size"])
    planner = BucketPlanner(sources, batch_size, num_buckets=int(scfg["num_buckets"]),
                            extra_datasets=[val, test])
    layout = planner.plan(emit=False)
    train_all = ConcatDataset([ShardDataset(p["trainset"]) for p in data.values()])
    pool = {}
    for workers in (1, STREAM_WORKERS):
        with run_directory(root / "pool", {"HYDRAGNN_NUM_WORKERS": str(workers)}):
            loader = GraphLoader(train_all, batch_size, layout, shuffle=True)
            t = time.perf_counter()
            digests = [batch_digest(b) for b in loader]
            pool[workers] = (digests, time.perf_counter() - t)
    if pool[1][0] != pool[STREAM_WORKERS][0]:
        raise AssertionError(f"{STREAM_WORKERS} collation workers gave other batches than one")

    # DistDataset: two stores on free ports, one GraphLoader epoch through the card
    local = [val[i] for i in range(len(val))]
    half = len(local) // 2
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    nodes = max(d.num_nodes for d in local)
    edges = max(d.num_edges for d in local)
    stores = [DistDataset(part, rank=k, world=2, addresses=addrs,
                          samples_per_rank=[half, len(local) - half],
                          max_counts={"nodes": nodes, "edges": edges})
              for k, part in enumerate((local[:half], local[half:]))]
    try:
        for s in stores:
            s.epoch_begin()
        t = time.perf_counter()
        n_dist = _same_batches(GraphLoader(stores[0], batch_size, layout, shuffle=True),
                               GraphLoader(local, batch_size, layout, shuffle=True), device,
                               "DistDataset")
        t_dist = time.perf_counter() - t
    finally:
        for s in stores:
            s.epoch_end()
            s.close()

    # FeedbackSink: a server's answered graphs, flushed as packs and read back
    feedback_dir = root / "feedback"
    served = [test[i] for i in range(min(STREAM_FEEDBACK["graphs"], len(test)))]
    with run_directory(root / "full", {"HYDRAGNN_FEEDBACK_DIR": str(feedback_dir),
                                       "HYDRAGNN_FEEDBACK_MAX_GRAPHS":
                                           str(STREAM_FEEDBACK["max_graphs"])}):
        registry = ModelRegistry()
        entry = registry.load_checkpoint(full["log_name"], device=device)
        plan = plan_from_samples(served, max_batch_graphs=batch_size)
        sink = FeedbackSink.from_env()
        with InferenceServer(registry, plan, device=device,
                             queue_capacity=len(served) + 1) as server:
            futures = [server.submit(g, model=entry.name) for g in served]
            answers = [f.result(120) for f in futures]
        for g, heads in zip(served, answers):
            if not all(np.all(np.isfinite(np.asarray(h))) for h in heads):
                raise AssertionError("a served answer is not finite")
            sink.offer(g, drifted=True)
        sink.offer(served[0], drifted=True)  # a duplicate: deduplicated
        sink.close()
    stats = sink.stats()
    back = ShardDataset(str(feedback_dir))
    if len(back) != len(served) or stats["deduped"] != 1:
        raise AssertionError(f"feedback packs hold {len(back)} graphs of {len(served)} "
                             f"(stats {stats})")
    for k, g in enumerate(served):
        b = back[k]
        if not (np.array_equal(b.x, g.x) and np.array_equal(b.pos, g.pos)
                and np.array_equal(b.edge_index, g.edge_index)
                and np.array_equal(b.targets[0], np.asarray(g.targets[0]).ravel())):
            raise AssertionError(f"feedback graph {k} reads back other than it was served")
    back.close()
    if "native" not in full["tracers"]:
        raise AssertionError(f"the tracer registered {full['tracers']}, not the native timer")

    emit({"stream_phase": {
        "card": card, "data_s": t_data, "samples_per_family": (
            r["samples"] if rehearsal else STREAM_SAMPLES),
        "plan": _plan_event(root / "full", full),
        "collation_s": {"1": pool[1][1], str(STREAM_WORKERS): pool[STREAM_WORKERS][1]},
        "collation_batches": len(pool[1][0]),
        "distdataset": {"batches": n_dist, "seconds": t_dist, "samples": len(local)},
        "feedback": {**stats, "packs_read": len(list(feedback_dir.glob("shard.*.gpk")))},
        "tracers": full["tracers"], "wall_s": time.perf_counter() - t0,
    }})
    return launches


def _plan_event(workdir, rec):
    """The run's ``bucket_plan`` event: bounds, ``est_waste`` and buckets."""
    plan = next(r for r in _run_events(workdir, rec) if r["event"] == "bucket_plan")
    return {k: plan[k] for k in ("bounds", "est_waste", "buckets", "per_source",
                                 "samples_scanned")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny size on the CPU through the plain versions; no success line")
    ap.add_argument("--only-fleet", action="store_true",
                    help="phases 1, 2 and the serving fleet (phase_fleet) only; no success line")
    ap.add_argument("--only-formats", action="store_true",
                    help="phases 1, 2 and the formats phase (phase_formats) only; no success line")
    ap.add_argument("--only-telemetry", action="store_true",
                    help="phases 1, 2 and the telemetry phase (phase_telemetry) only; no success "
                         "line")
    ap.add_argument("--only-stream", action="store_true",
                    help="phases 1, 2 and the streaming phase (phase_stream) only; no success "
                         "line")
    ap.add_argument("--stream-run", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None,
                    help="the fleet phase's files (default build/chip_smoke/fleet)")
    ap.add_argument("--step1-bucket", action="store_true",
                    help="hold the last four stacks' step 1 on the plan's smallest bucket, not "
                         f"on the training batch's first {NEW_STEP1_GRAPHS} graphs (past the "
                         "300 s wall)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.stream_run:  # the streaming phase's killed run, in a process of its own
        return _stream_worker(args.stream_run)

    if args.cpu_rehearsal:
        device, size, card = torch.device("cpu"), TINY, "cpu rehearsal (no device time)"
    else:
        card = phase_card()
        phase_build()
        device, size = torch.device("cuda"), FULL

    if args.only_formats:
        add_formats = phase_formats(device, card, rehearsal=args.cpu_rehearsal)
        print(f"only the formats: launches {add_formats}; "
              f"wall {time.perf_counter() - t_start:.1f} s; no success line", flush=True)
        return 0
    if args.only_stream:
        add_stream = phase_stream(device, card, rehearsal=args.cpu_rehearsal)
        print(f"only the stream: launches {add_stream}; "
              f"wall {time.perf_counter() - t_start:.1f} s; no success line", flush=True)
        return 0
    if args.only_telemetry:
        add_telemetry = phase_telemetry(device, card, rehearsal=args.cpu_rehearsal)
        print(f"only the telemetry: launches {add_telemetry}; "
              f"wall {time.perf_counter() - t_start:.1f} s; no success line", flush=True)
        return 0
    graphs = make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0)
    if args.only_fleet:
        add_fleet = phase_fleet(graphs[:SERVE_REQUESTS], device, card, size, args.workdir)
        print(f"only the fleet: the replicas' and canaries' launches {add_fleet}; "
              f"wall {time.perf_counter() - t_start:.1f} s; no success line", flush=True)
        return 0
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

    served = []  # each stack's first branch also warms a second version (phase 7)
    for family in FAMILIES:
        cfg = arch(size, family)
        for mode in ("fused", "segment"):
            served.append(phase_serve(mode, cfg, plan, graphs[:SERVE_REQUESTS], device, card,
                                      pool=graphs, warm=mode == "fused"))
    # the dense plan: PNA, and GIN and SAGE, which the JAX package's static
    # policy serves on the lists at this width
    for family in ("PNA", "GIN", "SAGE"):
        served.append(phase_serve("dense", arch(size, family), dense_plan,
                                  graphs[:SERVE_REQUESTS], device, card, pool=graphs))
    lap("serve (five stacks)")
    # the last four on the segment plan, and GAT, MFC and DimeNet also on
    # the dense one (the JAX package's static policy at these widths)
    for family in NEW_FAMILIES:
        fam_graphs, plans = new_plans[family]
        for mode, fam_plan in plans.items():
            served.append(phase_serve(mode, arch(size, family), fam_plan,
                                      fam_graphs[:NEW_SERVE_REQUESTS], device, card,
                                      pool=fam_graphs, warm=mode == "segment"))
    for result in served:
        add(result["launches"])
    lap("serve (GAT, MFC, CGCNN, DimeNet)")
    add(phase_serve_tenancy(plan, graphs[:SERVE_REQUESTS], device, card, size))
    lap("serve (tenants, cache, costs, scorer, tracing)")
    add(phase_fleet(graphs[:SERVE_REQUESTS], device, card, size, args.workdir))
    lap("serve fleet (replicas, router, hot-swap, canary, autoscaler, drift)")

    set_targets(graphs, seed=1)
    set_targets(cg_graphs, seed=1)
    for family in FAMILIES:
        # SchNet with its equivariant update here (the bench rows have none);
        # at FIVE_TRAIN_LAYERS (the wall's depth cut)
        cfg = dict(arch(size, family), equivariance=family in ("SchNet", "EGNN"),
                   num_conv_layers=min(size["layers"], FIVE_TRAIN_LAYERS))
        windows = TRAIN_WINDOWS if family == "PNA" else STACK_TRAIN_WINDOWS
        shared = {}  # the stack's float64 step, for its four runs
        for mode, bf16 in (("fused", False), ("segment", False), ("dense", False),
                           ("dense", True)):
            add(phase_train(mode, cfg, plan, graphs, device, card, bf16=bf16, windows=windows,
                            shared=shared))
    lap("train (five stacks)")
    step1 = (dict(step1_bucket=0) if args.step1_bucket else
             dict(step1_graphs=NEW_STEP1_GRAPHS if size is FULL else 2))
    for family in NEW_FAMILIES:
        fam_graphs, plans = new_plans[family]
        cfg = arch(size, family)
        shared = {}
        for mode, bf16 in (("segment", False), ("dense", False), ("dense", True)):
            add(phase_train(mode, cfg, plans["segment"], fam_graphs, device, card, bf16=bf16,
                            windows=STACK_TRAIN_WINDOWS, shared=shared, **step1))
    phase_dropout(plan, graphs, arch(size, "GAT"), device, card)
    lap("train (GAT, MFC, CGCNN, DimeNet)")
    benched = [phase_bench("MXU_HEADLINE", MXU_HEADLINE, size, device, card)]
    for row in MXU_ROWS:
        name = f"MXU_{row['model_type']}_{'dense_bf16' if row.get('dense') else 'segment_f32'}"
        benched.append(phase_bench(name, row, size, device, card))
    for result in benched:
        add(result["launches"])
    lap("bench_model")
    add(phase_run_training(device, card, rehearsal=args.cpu_rehearsal))
    lap("run_training")
    add(phase_whole_runs(device, card, rehearsal=args.cpu_rehearsal))
    lap("run_training (whole runs, guard, sentinel)")
    add(phase_formats(device, card, rehearsal=args.cpu_rehearsal))
    lap("run_training (formats, periodic cells, optimizers, conv checkpointing)")
    add(phase_telemetry(device, card, rehearsal=args.cpu_rehearsal))
    lap("run_training (telemetry: events, /metrics, /profile, goodput, MFU, report)")
    add(phase_stream(device, card, rehearsal=args.cpu_rehearsal))
    lap("run_training (streaming data plane: shard stores, mix, plan, kill and resume)")
    phase_capture(plan, graphs, device, card, served, benched)
    lap("capture")

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
    # a capture broken from outside is recorded once more (train/capture.py)
    print(f"captures invalidated and recorded again: {invalidated_captures()}", flush=True)
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
