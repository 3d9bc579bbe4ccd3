"""What serving would pay for going through the kernels'
``torch.autograd.Function`` (``ops.*_vjp``) under ``torch.inference_mode()``,
where nothing is recorded, beside the wrappers themselves, which is what
the ``*_vjp`` functions call there.

    python3 tools/vjp_dispatch_cost.py [--out FILE]
    python3 tools/vjp_dispatch_cost.py --cpu-rehearsal   # tiny, no times

Each family of ``chip_smoke.py``'s serve phase (its full width, random
weights from seed 0), in each aggregation mode, serves the smallest
bucket's batch of one graph and the largest bucket's full batch. One
forward under ``inference_mode`` is timed as the port runs it and with
``segment_sum_vjp``, ``segment_moments_vjp`` and
``fused_gather_moments_vjp`` bound to functions that always go through
their Function, in turns (5 rounds of one ``utils.timing.time_ms`` window
each: 20 forwards back to back, so the host can set the pace; the median
window). The two must give the same outputs. Also times one call of each
wrapper and of its Function on a small input, 2000 calls back to back on
the host's clock. Prints one JSON line per case and writes them to
``--out`` (default ``chiprun_out/vjp_dispatch_cost.json``).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hydragnn_tpu_torch import ops  # noqa: E402
from hydragnn_tpu_torch.models import create_model_config, pna  # noqa: E402
from hydragnn_tpu_torch.ops import fused_mp, segment_kernels  # noqa: E402
from hydragnn_tpu_torch.serve import plan_from_samples  # noqa: E402
from hydragnn_tpu_torch.utils.timing import time_ms  # noqa: E402

def k1_function(data, segment_ids, num_segments):
    return segment_kernels._SegmentSum.apply(data, segment_ids, num_segments)


def k2_function(data, segment_ids, num_segments):
    return segment_kernels.moments_views(
        segment_kernels._SegmentMoments.apply(data, segment_ids, num_segments), data.shape[1])


def k3_function(yj, senders, receivers, num_segments, edge_mask, ze=None):
    out, z = fused_mp._FusedGatherMoments.apply(yj, ze, senders, receivers, num_segments,
                                                edge_mask)
    return segment_kernels.moments_views(out, yj.shape[1]) + (z,)


# the names the forward looks up at call time -> the Function to bind there
FUNCTIONS = (
    (segment_kernels, "segment_sum_vjp", k1_function),
    (pna, "segment_moments_vjp", k2_function),
    (pna, "fused_gather_moments_vjp", k3_function),
)


@contextlib.contextmanager
def through_functions():
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in FUNCTIONS]
    for mod, name, fn in FUNCTIONS:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def host_us(fn, calls=2000):
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "vjp_dispatch_cost.json"))
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        device, size, card = torch.device("cpu"), cs.TINY, "cpu rehearsal"
    else:
        card = cs.phase_card()
        cs.phase_build()
        device, size = torch.device("cuda"), cs.FULL
    graphs = cs.make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0)
    plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3)
    small = next(g for g in graphs if plan.admit(g)[0] == 0)
    batches = {
        "one graph, smallest bucket": plan.pack([small], 0)[0].to(device),
        "largest bucket, full": cs.largest_batch(plan, graphs).to(device),
    }
    lines = []
    with torch.inference_mode():
        for family in cs.FAMILIES:
            cfg = cs.arch(size, family)
            for mode in ("fused", "segment"):
                model = create_model_config(cfg, device=device, aggregation=mode, seed=0).eval()
                for label, batch in batches.items():
                    def functions():
                        with through_functions():
                            return model(batch)

                    def wrappers():
                        return model(batch)

                    for a, b in zip(functions(), wrappers()):
                        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                    rounds = [[time_ms(fn, device) for fn in (functions, wrappers)]
                              for _ in range(5)]
                    fw, ww = [r[0] for r in rounds], [r[1] for r in rounds]
                    line = {"family": family, "mode": mode, "batch": label,
                            "function_ms_windows": fw, "wrapper_ms_windows": ww}
                    if device.type == "cuda":
                        fn_ms, wr_ms = float(np.median(fw)), float(np.median(ww))
                        line.update(function_ms=fn_ms, wrapper_ms=wr_ms,
                                    function_minus_wrapper_us=(fn_ms - wr_ms) * 1e3,
                                    relative=(fn_ms - wr_ms) / wr_ms,
                                    windows_overlap=min(fw) <= max(ww) and min(ww) <= max(fw))
                    cs.emit({"vjp_dispatch": line})
                    lines.append(line)
        x = torch.randn(64, 8, device=device)
        ids = torch.arange(64, dtype=torch.int32, device=device) % 8
        mask = torch.ones(64, dtype=torch.bool, device=device)
        for name, fn in (
            ("segment_sum", lambda: ops.segment_sum(x, ids, 8)),
            ("segment_sum Function", lambda: k1_function(x, ids, 8)),
            ("segment_moments", lambda: ops.segment_moments(x, ids, 8)),
            ("segment_moments Function", lambda: k2_function(x, ids, 8)),
            ("fused_gather_moments", lambda: ops.fused_gather_moments(x, ids, ids, 8, mask)),
            ("fused_gather_moments Function", lambda: k3_function(x, ids, ids, 8, mask)),
        ):
            us = [host_us(fn) for _ in range(3)]
            if device.type == "cuda":
                torch.cuda.synchronize()
            line = {"call": name, "host_us_per_call": float(np.median(us)), "repeats": us}
            cs.emit({"vjp_dispatch": line})
            lines.append(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "lines": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
