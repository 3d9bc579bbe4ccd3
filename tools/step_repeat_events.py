"""Where the spread of ``chip_smoke.py``'s PNA step 1 on the card comes from.

    python3 tools/step_repeat_events.py [--seed 0] [--modes segment] [--repeats 20]
    python3 tools/step_repeat_events.py --cpu-rehearsal   # tiny, no card

The card's float atomics (K1-K3) sum in another order on every call, so
step 1 repeated from the same weights gives other roundings each time; most
of that stays at rounding size, but a discrete choice in the forward that
the rounding flips moves the gradients by more. Per repeat this takes step
1 on the card (as ``tools/train_step_tolerance.py`` does, against one pair
of CPU steps) and, per PNA conv layer, counts the (receiver, column)
entries whose discrete choices differ from the first repeat's:

- ``clamp``: the variance ``sq/deg - mean^2`` below 0, which PNA's std
  clamps to 0, so that no gradient flows through it there;
- ``max``, ``min``: the edges whose ``z`` equals the receiver's max (min),
  which take its gradient;

and, over the whole forward, the entries of each ReLU's input above 0
(``relu``, in call order), where the gradient passes.

It also gives, for the tensor that needs the largest factor, how far the
repeat's gradient lies from the first repeat's, and the share of that
difference in its first singular direction (near 1: one row or column
moved, as one flipped choice would move it). One JSON line per repeat, then
a summary with the entries whose state follows the repeats that need a
factor above 2 (:func:`tail_marks`); ``--out`` gets them (default
``chiprun_out/step_repeat_events.json``).
"""

import argparse
import copy
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hydragnn_tpu_torch.models import create_model_config  # noqa: E402
from hydragnn_tpu_torch.models import pna  # noqa: E402
from hydragnn_tpu_torch.serve import plan_from_samples  # noqa: E402
from hydragnn_tpu_torch.train import Trainer  # noqa: E402


class ReluSides(TorchFunctionMode):
    """Records, per ReLU call, where its input lies above 0."""

    def __init__(self):
        super().__init__()
        self.sides = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.relu, torch.relu):
            self.sides.append((args[0] > 0).detach())
        return func(*args, **(kwargs or {}))


class Choices:
    """Records each PNA conv's discrete choices while installed."""

    def __init__(self):
        self.layers = []

    def moments(self, s, cnt, sq):
        deg = torch.clamp(cnt, min=1.0)
        mean = s / deg
        self.layers.append({"clamp": (sq / deg - mean * mean < 0).detach()})

    def install(self):
        seg_moments, fused_moments, minmax = (
            pna.segment_moments_vjp, pna.fused_gather_moments_vjp, pna.segment_minmax_fused)

        def seg(z, ids, n):
            s, cnt, sq = seg_moments(z, ids, n)
            self.moments(s, cnt, sq)
            return s, cnt, sq

        def fused(*args, **kw):
            s, cnt, sq, z = fused_moments(*args, **kw)
            self.moments(s, cnt, sq)
            return s, cnt, sq, z

        def mm(z, ids, n, has=None):
            mn, mx = minmax(z, ids, n, has=has)
            valid = ((ids >= 0) & (ids < n))[:, None]
            safe = torch.where(valid[:, 0], ids, 0).to(torch.int64)
            self.layers[-1]["max"] = ((z == mx[safe]) & valid).detach()
            self.layers[-1]["min"] = ((z == mn[safe]) & valid).detach()
            return mn, mx

        def uninstall():
            pna.segment_moments_vjp, pna.fused_gather_moments_vjp, pna.segment_minmax_fused = (
                seg_moments, fused_moments, minmax)

        pna.segment_moments_vjp, pna.fused_gather_moments_vjp, pna.segment_minmax_fused = (
            seg, fused, mm)
        return uninstall


def first_direction_share(d):
    """The share of ``|d|^2`` in ``d``'s first singular direction."""
    d = d.double().reshape(d.shape[0], -1)
    total = float((d * d).sum())
    if total == 0:
        return None
    return float(torch.linalg.svdvals(d)[0] ** 2) / total


MAX_LISTED = 64


def tail_marks(lines, host):
    """The entries whose state follows the tail (a repeat that needs a
    factor above 2): flipped against repeat 0 in exactly the repeats whose
    tail state differs from repeat 0's. A conv's max/min entry also names
    its edge's receiver and sender."""
    tail = [ln["factor_needed"] > 2 for ln in lines]
    if not any(tail) or all(tail):
        return []
    want = {r for r, t in enumerate(tail) if t != tail[0]}
    seen = {}
    for r, ln in enumerate(lines):
        for k, entries in ln["flipped_entries"].items():
            for row, col in entries:
                seen.setdefault((k, row, col), set()).add(r)
    marks = []
    for (k, row, col), repeats in sorted(seen.items()):
        if repeats == want:
            mark = {"mask": k, "row": row, "column": col}
            if k.endswith((".max", ".min")):
                mark.update(receiver=int(host.receivers[row]), sender=int(host.senders[row]))
            marks.append(mark)
    return marks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes", default="segment", help="of fused, segment")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "step_repeat_events.json"))
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
    graphs = cs.make_graphs(size["graphs"], size["nodes"], size["degree"], seed=args.seed)
    plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3)
    cs.set_targets(graphs, seed=args.seed + 1)
    host = cs.train_batch(plan, graphs, cfg)
    lines = []
    for mode in args.modes.split(","):
        model = create_model_config(cfg, device=device, aggregation=mode, seed=args.seed)
        cpu, exact = cs.cpu_references(model, host)
        first, first_grads = None, None
        for repeat in range(args.repeats):
            card_model = copy.deepcopy(model)
            trainer = Trainer(card_model, cs.train_config())
            state = trainer.init_state(host)
            batch = trainer.put_batch(host)
            choices, relu = Choices(), ReluSides()
            uninstall = choices.install()
            try:
                with relu:
                    _, met = trainer.train_step(state, batch)
            finally:
                uninstall()
            snap = cs.snapshot(card_model)
            rows, bad, _ = cs.hold_step_against_cpu(snap, float(met["loss"]), cpu, exact)
            need = max((r for r in rows if r["factor_needed"] is not None),
                       key=lambda r: r["factor_needed"])
            masks = {f"conv{i}.{k}": m for i, layer in enumerate(choices.layers)
                     for k, m in layer.items()}
            masks.update({f"relu{j}": m for j, m in enumerate(relu.sides)})
            if first is None:
                first, first_grads = masks, snap["grad"]
            flipped = {k: (m != first[k]).reshape(m.shape[0], -1) for k, m in masks.items()}
            d = snap["grad"][need["name"]] - first_grads[need["name"]] if need["kind"] == "grad" \
                else None
            line = {
                "seed": args.seed, "mode": mode, "repeat": repeat,
                "factor_needed": need["factor_needed"],
                "factor_needed_by": f"{need['kind']} {need['name']}",
                "violations": len(bad),
                "flips_vs_repeat_0": {k: int(f.sum()) for k, f in flipped.items() if f.any()},
                # [row, column] of each flipped entry (row: the edge of a
                # conv's max/min, else the node), at most MAX_LISTED per mask
                "flipped_entries": {k: f.nonzero()[:MAX_LISTED].tolist()
                                    for k, f in flipped.items() if f.any()},
                "clamped": [int(layer["clamp"].sum()) for layer in choices.layers],
                "grad_moved_vs_repeat_0": None if d is None else float(d.abs().max()),
                "moved_first_direction_share": None if d is None else first_direction_share(d),
            }
            cs.emit({"step_repeat_events": line})
            lines.append(line)
    summary = {
        "runs": len(lines),
        "tail_runs_need_over_2": sum(ln["factor_needed"] > 2 for ln in lines),
        "factor_needed_sorted": sorted(ln["factor_needed"] for ln in lines),
        "tail_marks": {mode: tail_marks([ln for ln in lines if ln["mode"] == mode], host)
                       for mode in args.modes.split(",")},
        "card": card,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "lines": lines}))
    cs.emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
