"""Step 1 of ``chip_smoke.py``'s PNA training on the card, held against the
exact step (float64 on the CPU) over several seeds: the readings behind
``chip_smoke.F32_FACTOR``.

    python3 tools/train_step_tolerance.py [--seeds 10] [--out FILE]
    python3 tools/train_step_tolerance.py --cpu-rehearsal   # tiny, no card

Per seed ``s`` (graphs from seed ``s``, targets from seed ``s + 1``,
weights from seed ``s``; seed 0 is the smoke's own batch) and per
aggregation mode, step 1 of AdamW is taken on the card and on the two CPU
copies of :func:`chip_smoke.cpu_references` (float32 through the plain
versions, and float64), and held as the smoke holds it
(:func:`chip_smoke.hold_step_against_cpu`). Per run: the f32 CPU's level
per kind, the least ``F32_FACTOR`` the card needs, the violations at the
factor in use, how many tensors of the card and of the f32 CPU lie outside
the serve phase's bound alone, and the check's reach over the gradients
(its bound over the tensor's scale: the smallest fault, relative to it,
that it would see). Prints one JSON line per seed and mode, then a summary
line; ``--out`` gets every row (default
``chiprun_out/train_step_tolerance.json``).
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hydragnn_tpu_torch.models import create_model_config  # noqa: E402
from hydragnn_tpu_torch.serve import plan_from_samples  # noqa: E402
from hydragnn_tpu_torch.train import Trainer  # noqa: E402


def study(mode, cfg, host, seed, device):
    model = create_model_config(cfg, device=device, aggregation=mode, seed=seed)
    cpu, exact = cs.cpu_references(model, host)
    trainer = Trainer(model, cs.TRAIN_CONFIG)
    state = trainer.init_state(host)
    _, met = trainer.train_step(state, trainer.put_batch(host))
    rows, bad, level = cs.hold_step_against_cpu(cs.snapshot(model), float(met["loss"]), cpu, exact)
    needs = [r for r in rows if r["factor_needed"] is not None]
    need = max(needs, key=lambda r: r["factor_needed"])
    line = {
        "seed": seed, "mode": mode,
        "batch": f"n_pad {host.num_nodes} e_pad {host.num_edges} g_pad {host.num_graphs}",
        "f32_cpu_level": level,
        "factor_needed": need["factor_needed"],
        "factor_needed_by": f"{need['kind']} {need['name']}",
        "violations": len(bad),
        "outside_serve_bound": cs.outside_serve_bound(rows),
        "reach_max_grad": max((r["reach"], r["name"]) for r in rows if r["kind"] == "grad"),
        "nearest": sorted(rows, key=lambda r: -r["worst_over_tol"])[:4],
    }
    return line, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "train_step_tolerance.json"))
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
        host = cs.train_batch(plan, graphs, cfg)
        for mode in ("fused", "segment"):
            line, rows = study(mode, cfg, host, seed, device)
            cs.emit({"train_step_tolerance": line})
            lines.append(line)
            every.append({"seed": seed, "mode": mode, "rows": rows})
    summary = {
        "runs": len(lines), "f32_factor": cs.F32_FACTOR,
        "factor_needed_sorted": sorted(line["factor_needed"] for line in lines),
        "runs_with_violations": sum(line["violations"] > 0 for line in lines),
        "f32_cpu_grad_level_range": [min(line["f32_cpu_level"]["grad"] for line in lines),
                                     max(line["f32_cpu_level"]["grad"] for line in lines)],
        "reach_max_grad": max(line["reach_max_grad"] for line in lines),
        "card": card,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "lines": lines, "rows": every}))
    cs.emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
