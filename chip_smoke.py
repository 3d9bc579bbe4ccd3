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
   segment_moments, K3 fused_gather_moments) on card tensors at the main
   path's shapes, holds the result against the plain PyTorch version on the
   same inputs (tolerance ``1e-5 * (max |partial sum| + 1)``: atomics add in
   a run-dependent order), and times kernel, plain version and, for K1,
   one ``index_add_`` call, with CUDA events; then samples the SM clock
   and power draw.
4. Serve: the MXU_HEADLINE model (PNA, hidden 256, 3 conv layers, a graph
   head and a node head of 64-wide layers; random weights from a seed,
   non-trivial BatchNorm statistics) served by ``InferenceServer`` to 320
   molecule-sized graphs (80-90 atoms, 12 edges per atom) from four
   threads, once per aggregation mode. Launch counters are zeroed just
   before each mode and read just after; every kernel of that mode's path
   must have launched. Every response is held against a CPU copy of the
   model (the plain versions) run on the graphs of its batch, packed into
   the same bucket.
5. Prints one JSON line per kernel case, the card's name and power limit,
   the ``{"kernels": [...]}`` summary, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

``--cpu-rehearsal`` runs phases 3-4 at a tiny size on the CPU through the
plain versions, to check the script's control flow without a card. It
times nothing on a device and never prints the success line.
"""

import argparse
import copy
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from hydragnn_tpu_torch.data import GraphData
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.ops import (
    KERNELS,
    _build,
    launch_counts,
    reset_launch_counts,
)
from hydragnn_tpu_torch.ops.segment_kernels import atomic_tolerance
from hydragnn_tpu_torch.serve import (
    InferenceServer,
    ModelRegistry,
    plan_from_samples,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# benchmarks/model_bench.py:_arch at bench.py's MXU_HEADLINE (PNA, hidden
# 256, 3 layers, 90-atom graphs, degree 12); edge_dim None as there
FULL = dict(hidden=256, layers=3, nodes=90, degree=12, graphs=320, batch=64)
TINY = dict(hidden=16, layers=2, nodes=12, degree=4, graphs=24, batch=4)

SOURCE = {
    "segment_sum": "hydragnn_tpu_torch/csrc/segment.cu",
    "segment_moments": "hydragnn_tpu_torch/csrc/segment.cu",
    "fused_gather_moments": "hydragnn_tpu_torch/csrc/fused_mp.cu",
}
REPLACES = {
    "segment_sum": "hydragnn_tpu/ops/pallas_segment.py:125",
    "segment_moments": "hydragnn_tpu/ops/pallas_segment.py:200",
    "fused_gather_moments": "hydragnn_tpu/ops/fused_mp.py:322",
}
# the kernels each aggregation mode's forward runs
MODE_KERNELS = {
    "fused": ("fused_gather_moments", "segment_sum"),
    "segment": ("segment_moments", "segment_sum"),
}
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4  # card (atomics, cuBLAS) against CPU


def arch(size):
    shared = max(32, size["hidden"] // 4)
    return {
        "model_type": "PNA",
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
    }


def make_graphs(num_graphs, nodes, degree, seed=0):
    """benchmarks/model_bench.py:make_graphs: ~``nodes`` atoms, ``degree``
    incident edges per node (ring-offset structure), random positions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(max(2, nodes - 10), nodes + 1))
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
        out.append(g)
    return out


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
    for name in ("segment", "fused_mp"):
        _build.load(name)
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s into {out_dir.relative_to(_build.REPO_ROOT)}", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}", flush=True)


# ---- phase 3 ----------------------------------------------------------------


def time_ms(fn, device, iters=20, warmup=3):
    """Mean ms per call: CUDA events around ``iters`` calls after warm-up.
    ``None`` on the CPU rehearsal, which measures no device."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def largest_batch(plan, graphs):
    """The main path's largest packed batch: the last bucket filled
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

    # K1: global_mean_pool's sum, [n_pad, hidden] by sorted graph ids
    x = rand(n_pad, hidden, node_mask)
    ids = batch.node_graph
    got, ref = seg_sum(x, ids, g_pad), seg_sum_plain(x, ids, g_pad)
    tol = atomic_tolerance(seg_sum_plain(x.abs(), ids, g_pad))
    nbytes = (n_pad * hidden + n_pad + g_pad * hidden) * 4
    cases.append(dict(
        kernel="segment_sum", case=f"pool [{n_pad},{hidden}] -> [{g_pad},{hidden}]",
        main=True, err=float((got - ref).abs().max()), tol=tol,
        ms=time_ms(lambda: seg_sum(x, ids, g_pad), device),
        plain_ms=time_ms(lambda: seg_sum_plain(x, ids, g_pad), device),
        library_ms=time_ms(
            lambda: torch.zeros((g_pad, hidden), device=device).index_add_(0, ids, x), device
        ),
        bound=bound(nbytes, n_pad * hidden),
    ))

    # K2: the segment mode's moments of z at the receivers, D = 1 and hidden
    rcv, snd = batch.receivers, batch.senders
    for d in (1, hidden):
        z = rand(e_pad, d, edge_mask[:, None])
        got, ref = seg_mom(z, rcv, n_pad), seg_mom_plain(z, rcv, n_pad)
        tol = atomic_tolerance(seg_sum_plain(torch.cat([z.abs(), z * z], 1), rcv, n_pad))
        nbytes = (e_pad * d + e_pad + 2 * n_pad * d + n_pad) * 4
        cases.append(dict(
            kernel="segment_moments", case=f"moments [{e_pad},{d}] -> [{n_pad},{d}]",
            main=d == hidden, err=max(float((g - r).abs().max()) for g, r in zip(got, ref)),
            tol=tol,
            ms=time_ms(lambda: seg_mom(z, rcv, n_pad), device),
            plain_ms=time_ms(lambda: seg_mom_plain(z, rcv, n_pad), device),
            library_ms=None,
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
                ms=time_ms(lambda: fgm(yj, snd, rcv, n_pad, edge_mask, ze=ze), device),
                plain_ms=time_ms(lambda: fgm_plain(yj, snd, rcv, n_pad, edge_mask, ze=ze), device),
                library_ms=None,
                bound=bound(nbytes, e_pad * d * (4 + with_ze) + e_pad),
            ))

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
    print(f"kernels: K1 segment_sum, K2 segment_moments, K3 fused_gather_moments "
          f"{status} ({len(cases)} cases)", flush=True)
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
    model = create_model_config(cfg, device=device, aggregation=mode, seed=0)
    set_bn_stats(model, seed=0)
    registry = ModelRegistry()
    registry.register("pna", model)
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
        expected = {"segment_sum": forwards, "segment_moments": 0, "fused_gather_moments": 0}
        expected[MODE_KERNELS[mode][0]] = forwards * cfg["num_conv_layers"]
        if counts != expected:
            raise AssertionError(f"{mode}: launches {counts}, expected {expected}")

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
                        raise AssertionError(f"{mode}: bad response {i} head {ihead}")
                    np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                    worst = max(worst, float(np.abs(got - want).max()))

    lat = np.asarray([f.done_at - s for f, s in zip(futures, submitted)]) * 1e3
    wall = max(f.done_at for f in futures) - t0
    result = {
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
        breakdown(mode, model, plan, graphs, device, card)
    return result


def breakdown(mode, model, plan, graphs, device, card, iters=5):
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


# ---- main -------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny size on the CPU through the plain versions; no success line")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        device, size, card = torch.device("cpu"), TINY, "cpu rehearsal (no device time)"
    else:
        card = phase_card()
        phase_build()
        device, size = torch.device("cuda"), FULL

    cfg = arch(size)
    graphs = make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0)
    plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3)
    for lay in plan.layouts:
        print(f"bucket: n_pad {lay.n_pad} e_pad {lay.e_pad} g_pad {lay.g_pad}", flush=True)

    cases = phase_kernels(plan, graphs, size["hidden"], device)
    launches = {name: 0 for name in KERNELS}
    for mode in ("fused", "segment"):
        served = phase_serve(mode, cfg, plan, graphs, device, card)
        for name in MODE_KERNELS[mode]:
            launches[name] += served["launches"][name]

    summary = []
    for name in KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main_case = next(c for c in mine if c["main"])
        summary.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(c["err"] for c in mine),
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        })
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
