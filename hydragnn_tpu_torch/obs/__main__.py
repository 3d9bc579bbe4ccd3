"""``python -m hydragnn_tpu_torch.obs``: the observability CLI (port of
``obs/__main__.py``).

Subcommands::

    report <logs/run | events.jsonl>
        [--format text|markdown|json]
        [--check-budget budget.json] [--tolerance F]
        [--write-budget budget.json]

    fleet <run-or-coordination dir>
        [--format text|markdown|json]
        [--straggler-factor F] [--min-steps N]

    trace <run-or-coordination dir | events.jsonl>
        [--format text|json] [--slow N]

    drift <run-or-coordination dir | events.jsonl>
        [--format text|json]

``report`` renders a run from its event stream and holds it to a budget;
``fleet`` merges every per-host event stream and heartbeat lease under a
directory into one cross-host view (step-time distributions, stragglers,
resize recovery priced as lost goodput); ``trace`` breaks the request
spans of a serving run down by segment; ``drift`` is the model-quality
report.

Exit status: 0 clean, 1 when ``--check-budget`` finds a figure over
budget (or under its MFU floor), 2 on usage errors (a missing stream, a
malformed budget, no fleet data, a budget over a stream without compile
events).
"""

import argparse
import os
import sys

from hydragnn_tpu_torch.obs import drift as drift_mod
from hydragnn_tpu_torch.obs import ledger as ledger_mod
from hydragnn_tpu_torch.obs import report as report_mod
from hydragnn_tpu_torch.obs import trace as trace_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.obs",
        description="post-mortem run reports + perf-budget ratchet",
    )
    sub = p.add_subparsers(dest="command")
    rep = sub.add_parser(
        "report",
        help="render a run report from its events.jsonl",
    )
    rep.add_argument(
        "run", help="run directory (containing events.jsonl) or the "
        "stream itself",
    )
    rep.add_argument(
        "--format",
        choices=sorted(report_mod.RENDERERS),
        default="text",
        help="output format (default: text)",
    )
    rep.add_argument(
        "--check-budget",
        metavar="FILE",
        help="compare per-bucket FLOPs/peak bytes against this "
        "baseline; exit 1 on any figure beyond tolerance",
    )
    rep.add_argument(
        "--tolerance",
        type=float,
        default=None,
        help="override the budget file's tolerance (fraction, e.g. 0.1)",
    )
    rep.add_argument(
        "--write-budget",
        metavar="FILE",
        help="write this run's compiled-cost figures (and MFU floors, "
        "when measured) as the new baseline",
    )
    fl = sub.add_parser(
        "fleet",
        help="merge an elastic run's per-host streams + heartbeat "
        "digests into one cross-host rollup",
    )
    fl.add_argument(
        "dir",
        help="run or coordination directory (searched recursively for "
        "events*.jsonl streams and workers/host-*.json leases)",
    )
    fl.add_argument(
        "--format",
        choices=sorted(ledger_mod.FLEET_RENDERERS),
        default="text",
        help="output format (default: text)",
    )
    fl.add_argument(
        "--straggler-factor",
        type=float,
        default=2.0,
        help="flag a host when its step p50 exceeds this multiple of "
        "the leave-one-out fleet median (default: 2.0)",
    )
    fl.add_argument(
        "--min-steps",
        type=int,
        default=3,
        help="hosts with fewer recorded steps neither flag nor count "
        "toward the median (default: 3)",
    )
    tr = sub.add_parser(
        "trace",
        help="reconstruct request span trees from the merged event "
        "streams and break down where the latency went",
    )
    tr.add_argument(
        "dir",
        help="run or coordination directory (searched recursively for "
        "events*.jsonl) or one stream file",
    )
    tr.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (default: text)",
    )
    tr.add_argument(
        "--slow",
        type=int,
        default=10,
        help="slowest traces to list with their dominant segment "
        "(default: 10)",
    )
    dr = sub.add_parser(
        "drift",
        help="model-quality report: drift scores vs the pinned "
        "reference, alert ledger, uncertainty quantiles, feedback sink",
    )
    dr.add_argument(
        "dir",
        help="run or coordination directory (searched recursively for "
        "events*.jsonl) or one stream file",
    )
    dr.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (default: text)",
    )
    return p


def _run_report(args) -> int:
    events_path = report_mod.resolve_events_path(args.run)
    if not os.path.exists(events_path):
        print(f"obs report: no event stream at {events_path}",
              file=sys.stderr)
        return 2
    report = report_mod.build_report(report_mod.load_events(events_path))
    print(report_mod.RENDERERS[args.format](report), end="")

    if args.write_budget:
        budget = report_mod.budget_from_report(
            report,
            tolerance=(
                args.tolerance
                if args.tolerance is not None
                else report_mod.DEFAULT_TOLERANCE
            ),
        )
        if not budget["programs"]:
            print(
                "obs report: no compile events in the stream — nothing "
                "to budget (was introspection enabled?)",
                file=sys.stderr,
            )
            return 2
        import json

        with open(args.write_budget, "w") as f:
            json.dump(budget, f, indent=2, sort_keys=True)
            f.write("\n")
        print(
            f"obs report: wrote {len(budget['programs'])} program "
            f"budget(s) to {args.write_budget}",
            file=sys.stderr,
        )

    if args.check_budget:
        try:
            budget = report_mod.load_budget(args.check_budget)
        except FileNotFoundError:
            print(
                f"obs report: budget {args.check_budget} not found",
                file=sys.stderr,
            )
            return 2
        except ValueError as e:
            print(f"obs report: {e}", file=sys.stderr)
            return 2
        if budget["programs"] and not report["programs"]:
            # every baseline entry would degrade to a non-fatal 'stale'
            # note and the gate would pass having checked NOTHING —
            # a run with no compile events cannot satisfy a non-empty
            # budget (introspection off? telemetry never active?)
            print(
                "obs report: stream has no compile events but the "
                f"budget expects {len(budget['programs'])} program(s) — "
                "was introspection enabled for this run?",
                file=sys.stderr,
            )
            return 2
        violations, unbudgeted, stale = report_mod.check_budget(
            report, budget, tolerance=args.tolerance
        )
        for name in unbudgeted:
            print(
                f"obs report: note: {name} has no budget entry "
                "(new bucket? --write-budget to adopt it)",
                file=sys.stderr,
            )
        for name in stale:
            print(
                f"obs report: note: budget entry {name} matched no "
                "compiled program in this run",
                file=sys.stderr,
            )
        # an MFU floor the run could not measure (no peak-FLOPs entry,
        # telemetry off) is a NOTE, never a silent pass or a failure
        for name, entry in sorted(budget["programs"].items()):
            if "mfu_floor" not in entry:
                continue
            current = report["programs"].get(name)
            if current is not None and current.get("mfu") is None:
                print(
                    f"obs report: note: budget entry {name} has an MFU "
                    "floor but this run measured no MFU (peak FLOPs "
                    "unresolvable? goodput ledger inactive?)",
                    file=sys.stderr,
                )
        for v in violations:
            if v["metric"] == "mfu_floor":
                print(
                    f"obs report: UNDER MFU FLOOR: {v['bucket']} mfu "
                    f"{v['current']:.6g} < limit {v['limit']:.6g} "
                    f"(floor {v['baseline']:.6g}, x{v['ratio']:.3f})",
                    file=sys.stderr,
                )
            else:
                print(
                    f"obs report: OVER BUDGET: {v['bucket']} {v['metric']} "
                    f"{v['current']:.6g} > limit {v['limit']:.6g} "
                    f"(baseline {v['baseline']:.6g}, x{v['ratio']:.3f})",
                    file=sys.stderr,
                )
        if violations:
            return 1
        print(
            f"obs report: budget ok ({len(budget['programs'])} "
            f"program(s) checked)",
            file=sys.stderr,
        )
    return 0


def _run_fleet(args) -> int:
    if not os.path.isdir(args.dir):
        print(f"obs fleet: {args.dir} is not a directory", file=sys.stderr)
        return 2
    report = ledger_mod.build_fleet_report(
        args.dir,
        straggler_factor=args.straggler_factor,
        min_steps=args.min_steps,
    )
    if not report["streams"] and not report["hosts"]:
        print(
            f"obs fleet: no event streams or worker leases found under "
            f"{args.dir}",
            file=sys.stderr,
        )
        return 2
    print(ledger_mod.FLEET_RENDERERS[args.format](report), end="")
    return 0


def _run_trace(args) -> int:
    spans = trace_mod.load_span_events(args.dir)
    if not spans:
        print(
            f"obs trace: no span events under {args.dir} "
            "(was HYDRAGNN_TRACE_SAMPLE set for the run?)",
            file=sys.stderr,
        )
        return 2
    traces = trace_mod.build_traces(spans)
    rollup = trace_mod.anatomy(traces)
    if args.format == "json":
        import json

        rollup["slowest"] = rollup["slowest"][:max(args.slow, 0)]
        print(json.dumps(rollup, indent=2, sort_keys=True))
        return 0
    print(f"request latency anatomy — {rollup['traces']} trace(s), "
          f"{len(spans)} span(s)")
    print()
    print(f"  {'segment':<14} {'count':>6} {'p50 s':>10} {'p99 s':>10} "
          f"{'total s':>10}")
    for name, seg in rollup["segments"].items():
        print(f"  {name:<14} {seg['count']:>6} {seg['p50_s']:>10.6f} "
              f"{seg['p99_s']:>10.6f} {seg['total_s']:>10.6f}")
    if rollup["groups"]:
        print()
        print("per tenant/lane (total seconds per segment):")
        for group, segs in rollup["groups"].items():
            parts = ", ".join(
                f"{k}={v:.4f}" for k, v in segs.items() if k != "other"
            )
            print(f"  {group:<20} {parts}")
    slow = rollup["slowest"][:max(args.slow, 0)]
    if slow:
        print()
        print(f"slowest {len(slow)} trace(s):")
        for row in slow:
            flags = []
            if row["slo_missed"]:
                flags.append("SLO-MISSED")
            if row["status"] not in (None, "ok"):
                flags.append(str(row["status"]))
            suffix = f"  [{' '.join(flags)}]" if flags else ""
            print(
                f"  {row['trace']}  {row['dur_s']:.6f}s  "
                f"tenant={row['tenant'] or '-'} lane={row['lane'] or '-'} "
                f"spans={row['spans']} "
                f"dominant={row['dominant'] or '-'}{suffix}"
            )
    return 0


def _run_drift(args) -> int:
    records = drift_mod.load_quality_events(args.dir)
    if not records:
        print(
            f"obs drift: no drift/quality events under {args.dir} "
            "(was HYDRAGNN_DRIFT_WINDOW set for the run?)",
            file=sys.stderr,
        )
        return 2
    report = drift_mod.build_drift_report(records)
    if args.format == "json":
        import json

        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    print(drift_mod.render_drift_text(report), end="")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "report":
        return _run_report(args)
    if args.command == "fleet":
        return _run_fleet(args)
    if args.command == "trace":
        return _run_trace(args)
    if args.command == "drift":
        return _run_drift(args)
    build_parser().print_help(sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
