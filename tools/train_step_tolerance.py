"""Step 1 of ``chip_smoke.py``'s PNA training on the card, held against the
exact step (float64 on the CPU) over several seeds: the readings behind
``chip_smoke.F32_FACTOR`` and, with ``--bf16``, ``chip_smoke.BF16_FACTOR``.

    python3 tools/train_step_tolerance.py [--seeds 10] [--modes fused,segment] [--out FILE]
    python3 tools/train_step_tolerance.py --bf16 --modes dense   # the bf16 factor
    python3 tools/train_step_tolerance.py --seeds 1 --modes segment --repeats 10
    python3 tools/train_step_tolerance.py --cpu-rehearsal        # tiny, no card

Per seed ``s`` (graphs from seed ``s``, targets from seed ``s + 1``,
weights from seed ``s``; seed 0 is the smoke's own batch) and per
aggregation mode (``dense``: the batch with its neighbour lists), step 1
of AdamW (in bf16 mixed precision with ``--bf16``) is taken on the card
(``--repeats`` times, from the same weights) and on the CPU copies of
:func:`chip_smoke.cpu_references` (the witness, through the plain
versions at the card's precision, in bf16 also on the graphs in the
reverse order, and float64), and held as the smoke holds it
(:func:`chip_smoke.hold_step_against_cpu`). Per run: the witnesses'
level per kind, the least factor the card needs, the violations at the
factor in use, how many tensors of the card and of the witness lie
outside the serve phase's bound alone, and the check's reach over the
gradients (its bound over the tensor's scale: the smallest fault,
relative to it, that it would see; the largest and the median). Prints
one JSON line per seed, mode and repeat, then a summary line; ``--out``
gets every row (default ``chiprun_out/train_step_tolerance[_bf16].json``).
"""

import argparse
import copy
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hydragnn_tpu_torch.models import create_model_config  # noqa: E402
from hydragnn_tpu_torch.serve import plan_from_samples  # noqa: E402
from hydragnn_tpu_torch.train import Trainer  # noqa: E402


def study(mode, cfg, host, reversed_host, seed, device, bf16, repeats):
    """Step 1 on the card ``repeats`` times from the same weights (the card's
    float atomics sum in another order each time) against one pair of CPU
    steps. Returns one line and the rows per repeat."""
    model = create_model_config(cfg, device=device, aggregation=cs.aggregation_of(mode), seed=seed)
    cpu, exact = cs.cpu_references(model, host, bf16, reversed_host)
    out = []
    for repeat in range(repeats):
        card = copy.deepcopy(model)
        trainer = Trainer(card, cs.train_config(bf16))
        state = trainer.init_state(host)
        _, met = trainer.train_step(state, trainer.put_batch(host))
        rows, bad, level = cs.hold_step_against_cpu(
            cs.snapshot(card), float(met["loss"]), cpu, exact, bf16)
        needs = [r for r in rows if r["factor_needed"] is not None]
        need = max(needs, key=lambda r: r["factor_needed"])
        reach = [(r["reach"], r["name"]) for r in rows if r["kind"] == "grad"]
        line = {
            "seed": seed, "mode": mode, "repeat": repeat, "precision": "bf16" if bf16 else "f32",
            "batch": f"n_pad {host.num_nodes} e_pad {host.num_edges} g_pad {host.num_graphs}",
            "cpu_level": level,
            "factor_needed": need["factor_needed"],
            "factor_needed_by": f"{need['kind']} {need['name']}",
            "violations": len(bad),
            "outside_serve_bound": cs.outside_serve_bound(rows),
            "reach_max_grad": max(reach),
            "reach_median_grad": statistics.median(r for r, _ in reach),
            "nearest": sorted(rows, key=lambda r: -r["worst_over_tol"])[:4],
        }
        out.append((line, rows))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--modes", default="fused,segment", help="of fused, segment, dense")
    ap.add_argument("--bf16", action="store_true", help="bf16 mixed precision")
    ap.add_argument("--repeats", type=int, default=1, help="card steps per seed and mode")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny size, the plain versions as the card; checks control flow")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        device, size, card = torch.device("cpu"), cs.TINY, "cpu rehearsal"
    else:
        card = cs.phase_card()
        cs.phase_build()
        device, size = torch.device("cuda"), cs.FULL
    cfg = cs.arch(size, "PNA")
    lines, every = [], []
    for seed in range(args.seeds):
        graphs = cs.make_graphs(size["graphs"], size["nodes"], size["degree"], seed=seed)
        plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3)
        cs.set_targets(graphs, seed=seed + 1)
        for mode in args.modes.split(","):
            host = cs.train_batch(plan, graphs, cfg, dense=mode == "dense")
            reversed_host = cs.train_batch(plan, graphs, cfg, dense=mode == "dense",
                                           reverse=True) if args.bf16 else None
            for line, rows in study(mode, cfg, host, reversed_host, seed, device, args.bf16,
                                    args.repeats):
                cs.emit({"train_step_tolerance": line})
                lines.append(line)
                every.append({"seed": seed, "mode": mode, "repeat": line["repeat"], "rows": rows})
    summary = {
        "runs": len(lines), "precision": "bf16" if args.bf16 else "f32",
        "factor": cs.BF16_FACTOR if args.bf16 else cs.F32_FACTOR,
        "factor_needed_sorted": sorted(line["factor_needed"] for line in lines),
        "runs_with_violations": sum(line["violations"] > 0 for line in lines),
        "cpu_grad_level_range": [min(line["cpu_level"]["grad"] for line in lines),
                                 max(line["cpu_level"]["grad"] for line in lines)],
        "reach_max_grad": max(line["reach_max_grad"] for line in lines),
        "reach_median_grad_range": [min(line["reach_median_grad"] for line in lines),
                                    max(line["reach_median_grad"] for line in lines)],
        "card": card,
    }
    out = Path(args.out or ROOT / "chiprun_out" / (
        "train_step_tolerance_bf16.json" if args.bf16 else "train_step_tolerance.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "lines": lines, "rows": every}))
    cs.emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
