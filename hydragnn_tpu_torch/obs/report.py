"""Post-mortem run reports from ``events.jsonl`` and the perf-budget
ratchet (port of ``obs/report.py``).

``python -m hydragnn_tpu_torch.obs report <logs/run>`` renders what a
finished (or crashed) run did: the epoch table, the throughput trend, the
padding waste, the goodput split, the guard/checkpoint/compile/stall
timeline and each captured program's cost, from the event stream alone.

The budget ratchet (``--check-budget budget.json``) compares the run's
per-bucket FLOPs and peak bytes against a committed baseline with a
tolerance, and floors its MFU: the gate fails when a hot program got
measurably more expensive, and the baseline moves only by an explicit
``--write-budget``. The port's records carry no ``bytes_accessed``
(PyTorch has no such figure), so that metric is absent from its budgets,
never 0.

The FLOPs of a port's stream are ``FlopCounterMode``'s count (aten
operations only; the hand-written kernels are not counted,
``obs/introspect.py``): a stream whose manifest says so
(``flops_counter``) gets that line in the report's header. Without it
(the JAX package's streams) the report is the JAX package's, byte for
byte, in all three formats.

Loading is tolerant, unlike ``validate_events`` (the strict schema gate):
a torn stream from a crashed run is when a post-mortem matters, so an
unparseable line is skipped.
"""

import json
import os
from typing import Dict, List, Optional, Tuple

BUDGET_VERSION = 1
DEFAULT_TOLERANCE = 0.10
# the per-program figures the ratchet tracks (report key -> budget key)
BUDGET_METRICS = ("flops", "bytes_accessed", "peak_bytes")


def resolve_events_path(path: str) -> str:
    """Accept a run directory or the ``events.jsonl`` itself."""
    if os.path.isdir(path):
        return os.path.join(path, "events.jsonl")
    return path


def load_events(path: str) -> List[Dict]:
    """Tolerantly parse an event stream (run dir or file path)."""
    path = resolve_events_path(path)
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail / partial write: skip, don't die
            if isinstance(rec, dict) and "event" in rec:
                records.append(rec)
    return records


def _num(value) -> Optional[float]:
    """Numeric field or None (nulled NaNs stay None)."""
    return float(value) if isinstance(value, (int, float)) else None


def build_report(records: List[Dict]) -> Dict:
    """Fold the event stream into the report structure all three
    renderers (and the budget check) consume."""
    manifest = next(
        (r for r in records if r["event"] == "run_manifest"), {}
    )
    run_end = next(
        (r for r in reversed(records) if r["event"] == "run_end"), None
    )
    ts = [r["ts"] for r in records if isinstance(r.get("ts"), (int, float))]

    epochs = []
    for r in records:
        if r["event"] != "epoch":
            continue
        epochs.append(
            {
                "epoch": r.get("epoch"),
                "train_loss": _num(r.get("train_loss")),
                "val_loss": _num(r.get("val_loss")),
                "test_loss": _num(r.get("test_loss")),
                "wall_time_s": _num(r.get("wall_time_s")),
                "graphs_per_sec": _num(r.get("graphs_per_sec")),
                "nodes_per_sec": _num(r.get("nodes_per_sec")),
                "padding_waste": _num(r.get("padding_waste")),
                "mode": r.get("mode"),
            }
        )

    gps = [e["graphs_per_sec"] for e in epochs if e["graphs_per_sec"]]
    waste = [
        e["padding_waste"] for e in epochs if e["padding_waste"] is not None
    ]
    throughput = {}
    if gps:
        throughput = {
            "first_graphs_per_sec": gps[0],
            "last_graphs_per_sec": gps[-1],
            "best_graphs_per_sec": max(gps),
            "mean_graphs_per_sec": sum(gps) / len(gps),
        }
    if waste:
        throughput["mean_padding_waste"] = sum(waste) / len(waste)

    # per-bucket compiled cost: LAST capture wins (a resumed run's
    # recompile re-reports the same bucket). Collective result bytes
    # (per-axis accounting riding the compile events) roll up
    # per axis over the DEDUPED programs — summing raw records would
    # double-count every bucket a resumed run recompiled.
    programs: Dict[str, Dict] = {}
    for r in records:
        if r["event"] != "compile":
            continue
        cost = r.get("cost") or {}
        mem = r.get("memory") or {}
        programs[r["bucket"]] = {
            "name": r.get("name"),
            "bucket": r["bucket"],
            "flops": _num(cost.get("flops")),
            "bytes_accessed": _num(cost.get("bytes_accessed")),
            "peak_bytes": _num(mem.get("peak_bytes")),
            "argument_bytes": _num(mem.get("argument_bytes")),
            "output_bytes": _num(mem.get("output_bytes")),
            "temp_bytes": _num(mem.get("temp_bytes")),
            "collectives": {
                str(axis): _num(v)
                for axis, v in (r.get("collectives") or {}).items()
            },
        }
    collectives: Dict[str, float] = {}
    for p in programs.values():
        for axis, v in (p.get("collectives") or {}).items():
            if v is not None:
                collectives[axis] = collectives.get(axis, 0.0) + float(v)

    # goodput ledger events (obs/ledger.py): per-epoch category fractions
    # + the per-bucket MFU figures (LAST value per bucket wins — it saw
    # the most warmed-up steps); the MFU lands on the program entry so
    # the budget ratchet can floor it
    goodput = []
    for r in records:
        if r["event"] != "goodput":
            continue
        goodput.append(
            {
                "epoch": r.get("epoch"),
                "wall_s": _num(r.get("wall_s")),
                "fractions": r.get("fractions") or {},
                "goodput_fraction": _num(r.get("goodput_fraction")),
                "mfu": r.get("mfu") or {},
            }
        )
        for bucket, m in (r.get("mfu") or {}).items():
            if bucket in programs and isinstance(m, dict):
                if _num(m.get("mfu")) is not None:
                    programs[bucket]["mfu"] = float(m["mfu"])

    # the run's device mesh (parallel/mesh.py announce_mesh): the header
    # should say what hardware layout produced these figures
    mesh = next(
        (r for r in reversed(records) if r["event"] == "mesh_shape"), None
    )

    # canary ladder (serve/canary.py): every candidate's journey from
    # publication to verdict, in stream order — a rejected candidate's
    # reason string is the post-mortem
    canary = []
    for r in records:
        if r["event"] not in (
            "candidate_published", "canary_started",
            "canary_promoted", "canary_rejected",
        ):
            continue
        canary.append(
            {
                "event": r["event"],
                "candidate": r.get("candidate"),
                "checkpoint": r.get("checkpoint"),
                "samples": _num(r.get("samples")),
                "reason": r.get("reason"),
            }
        )

    # request tracing (obs/trace.py): when the stream carries flushed
    # span events, fold them into the latency-anatomy rollup the obs
    # trace CLI prints — a serving run's report answers "where did the
    # slow requests spend their time" inline
    trace_anatomy = None
    spans = [r for r in records if r["event"] == "span" and r.get("trace")]
    if spans:
        from hydragnn_tpu_torch.obs import trace as trace_mod

        trace_anatomy = trace_mod.anatomy(trace_mod.build_traces(spans))

    # tenant bill (serve/costs.py): tenant_cost events carry CUMULATIVE
    # per-tenant attribution, so the LAST record per tenant wins
    tenant_bill: Dict[str, Dict] = {}
    for r in records:
        if r["event"] != "tenant_cost":
            continue
        tenant_bill[str(r.get("tenant") or "-")] = {
            "device_s": _num(r.get("device_s")),
            "flops": _num(r.get("flops")),
            "requests": _num(r.get("requests")),
            "replica_s": _num(r.get("replica_s")),
        }

    # model-quality observatory (obs/drift.py): folded only when the
    # stream actually carries quality events, so reports over old
    # streams omit the section instead of rendering an empty one
    quality = None
    from hydragnn_tpu_torch.obs.drift import QUALITY_EVENTS, build_drift_report

    if any(r["event"] in QUALITY_EVENTS for r in records):
        quality = build_drift_report(
            [r for r in records if r["event"] in QUALITY_EVENTS]
        )

    counts = {
        key: sum(1 for r in records if r["event"] == key)
        for key in (
            "compile", "stall", "checkpoint_saved", "checkpoint_restored",
            "guard_skip", "guard_restore", "resume", "staged", "fit_chunk",
            "candidate_published", "canary_promoted", "canary_rejected",
            "span", "quota_adjusted",
            "drift_window", "drift_alert", "feedback_sink",
        )
    }
    counts["profile_done"] = sum(
        1
        for r in records
        if r["event"] == "profile" and r.get("status") == "done"
    )

    timeline = []
    t0 = ts[0] if ts else 0.0
    for r in records:
        ev = r["event"]
        if ev == "compile":
            c, m = r.get("cost") or {}, r.get("memory") or {}
            desc = (
                f"{r.get('name')} [{r.get('bucket')}] "
                f"flops={_fmt_num(c.get('flops'))} "
                f"peak={_fmt_bytes(m.get('peak_bytes'))}"
            )
        elif ev == "stall":
            desc = (
                f"step {r.get('step')}: {r.get('seconds')}s vs median "
                f"{r.get('median')}s (x{r.get('factor')})"
            )
        elif ev == "checkpoint_saved":
            desc = f"{r.get('name')} ({r.get('kind')})"
        elif ev == "checkpoint_restored":
            desc = f"{r.get('name')} from {r.get('source')}"
        elif ev == "guard_skip":
            desc = f"scope={r.get('scope')} skipped={r.get('skipped')}"
        elif ev == "guard_restore":
            desc = f"restores={r.get('restores')} lr={r.get('lr')}"
        elif ev == "resume":
            desc = f"start_epoch={r.get('start_epoch')}"
        elif ev in ("early_stop", "wallclock_stop"):
            desc = f"epoch={r.get('epoch')}"
        elif ev == "profile":
            desc = f"{r.get('status')} ({r.get('trace_dir', '')})"
        elif ev in ("candidate_published", "canary_started"):
            desc = f"candidate={r.get('candidate')} {r.get('checkpoint')}"
        elif ev == "canary_promoted":
            desc = (
                f"candidate={r.get('candidate')} {r.get('checkpoint')} "
                f"samples={r.get('samples')}"
            )
        elif ev == "canary_rejected":
            desc = (
                f"candidate={r.get('candidate')} {r.get('checkpoint')}: "
                f"{r.get('reason')}"
            )
        elif ev == "drift_alert":
            desc = (
                f"{r.get('status')} tenant={r.get('tenant')} "
                f"feature={r.get('feature')} head={r.get('head')} "
                f"{r.get('kind')}={r.get('score')}"
            )
        else:
            continue
        timeline.append(
            {
                "t": round(float(r.get("ts", t0)) - t0, 3),
                "event": ev,
                "detail": desc,
            }
        )

    return {
        "run": {
            "run": manifest.get("run"),
            "config_hash": manifest.get("config_hash"),
            "git_rev": manifest.get("git_rev"),
            "world_size": manifest.get("world_size"),
            "device_kind": manifest.get("device_kind"),
            "device_count": manifest.get("device_count"),
            "num_epoch": manifest.get("num_epoch"),
            "status": run_end["status"] if run_end else "incomplete",
            "duration_s": round(ts[-1] - ts[0], 3) if len(ts) > 1 else None,
            "events": len(records),
            "mesh_shape": mesh.get("shape") if mesh else None,
            "mesh_axes": mesh.get("axes") if mesh else None,
            # a port's stream: what its FLOPs count (absent elsewhere)
            **({"flops_counter": manifest["flops_counter"]}
               if manifest.get("flops_counter") else {}),
        },
        "epochs": epochs,
        "canary": canary,
        "throughput": throughput,
        "programs": programs,
        "collectives": collectives,
        "goodput": goodput,
        "trace_anatomy": trace_anatomy,
        "tenant_bill": tenant_bill,
        "quality": quality,
        "counts": counts,
        "timeline": timeline,
    }


# ---- rendering -----------------------------------------------------------


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{suffix}"
    return f"{v:.6g}"


def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    for scale, suffix in ((2**30, "GiB"), (2**20, "MiB"), (2**10, "KiB")):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{suffix}"
    return f"{v:.0f}B"


def _fmt(v, digits=6) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


_EPOCH_COLS = (
    ("epoch", "epoch"),
    ("train", "train_loss"),
    ("val", "val_loss"),
    ("test", "test_loss"),
    ("wall_s", "wall_time_s"),
    ("graphs/s", "graphs_per_sec"),
    ("waste", "padding_waste"),
    ("mode", "mode"),
)

_PROGRAM_COLS = (
    ("program", "name"),
    ("bucket", "bucket"),
    ("flops", "flops"),
    ("bytes_accessed", "bytes_accessed"),
    ("peak_hbm", "peak_bytes"),
    ("args", "argument_bytes"),
    ("out", "output_bytes"),
    ("temp", "temp_bytes"),
    ("mfu", "mfu"),
)


def _programs_title(report) -> str:
    """The programs table's title: the JAX package's for its streams, what
    the port's records hold for a port's."""
    if report["run"].get("flops_counter"):
        return "captured programs (FlopCounterMode FLOPs, allocator bytes)"
    return "compiled programs (XLA cost/memory)"


def _fmt_pct(v) -> str:
    return "-" if v is None else f"{100.0 * float(v):.2f}%"


def _program_rows(report) -> List[List[str]]:
    rows = []
    for key in sorted(report["programs"]):
        p = report["programs"][key]
        rows.append(
            [
                str(p.get("name") or "-"),
                key.split("/", 1)[1] if "/" in key else key,
                _fmt_num(p.get("flops")),
                _fmt_num(p.get("bytes_accessed")),
                _fmt_bytes(p.get("peak_bytes")),
                _fmt_bytes(p.get("argument_bytes")),
                _fmt_bytes(p.get("output_bytes")),
                _fmt_bytes(p.get("temp_bytes")),
                _fmt_pct(p.get("mfu")),
            ]
        )
    return rows


def _epoch_rows(report) -> List[List[str]]:
    return [
        [_fmt(e[field], 4) for _, field in _EPOCH_COLS]
        for e in report["epochs"]
    ]


def _text_table(headers, rows) -> List[str]:
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    for r in rows:
        out.append(
            "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
        )
    return out


def _md_table(headers, rows) -> List[str]:
    out = ["| " + " | ".join(headers) + " |"]
    out.append("|" + "|".join(" --- " for _ in headers) + "|")
    for r in rows:
        out.append("| " + " | ".join(r) + " |")
    return out


def _summary_lines(report) -> List[str]:
    run = report["run"]
    c = report["counts"]
    mesh = ""
    if run.get("mesh_shape"):
        axes = run.get("mesh_axes") or []
        mesh = (
            "  mesh: "
            + "x".join(str(v) for v in run["mesh_shape"])
            + (f" ({', '.join(str(a) for a in axes)})" if axes else "")
        )
    lines = [
        f"run: {run['run']}  status: {run['status']}  "
        f"git: {run['git_rev']}  config: {run['config_hash']}",
        f"world: {run['world_size']} process(es) x "
        f"{run['device_count']} {run['device_kind']} device(s){mesh}  "
        f"epochs: {len(report['epochs'])}/{run['num_epoch']}  "
        f"duration: {_fmt(run['duration_s'], 5)}s",
        "counts: "
        + "  ".join(f"{k}={v}" for k, v in sorted(c.items()) if v),
    ]
    if run.get("flops_counter"):
        lines.append(f"flops: {run['flops_counter']}")
    t = report["throughput"]
    if t:
        lines.append(
            "throughput: "
            f"first {_fmt(t.get('first_graphs_per_sec'), 4)} -> "
            f"last {_fmt(t.get('last_graphs_per_sec'), 4)} graphs/s "
            f"(best {_fmt(t.get('best_graphs_per_sec'), 4)}, "
            f"mean {_fmt(t.get('mean_graphs_per_sec'), 4)})"
            + (
                f", mean padding waste "
                f"{_fmt(t.get('mean_padding_waste'), 3)}"
                if t.get("mean_padding_waste") is not None
                else ""
            )
        )
    return lines


_CANARY_HEADERS = ("event", "candidate", "checkpoint", "samples", "reason")


def _canary_rows(report) -> List[List[str]]:
    return [
        [
            str(c.get("event") or "-"),
            _fmt(c.get("candidate")),
            str(c.get("checkpoint") or "-"),
            _fmt(c.get("samples"), 4),
            str(c.get("reason") or "-"),
        ]
        for c in report.get("canary", [])
    ]


def _goodput_cols(report):
    """(headers, rows) of the per-epoch goodput table — epoch, wall, and
    one fraction column per category that ever appeared."""
    from hydragnn_tpu_torch.obs.ledger import CATEGORIES

    seen = set()
    for g in report.get("goodput", []):
        seen.update(g.get("fractions") or {})
    cats = [c for c in CATEGORIES if c in seen] + sorted(
        seen - set(CATEGORIES)
    )
    headers = ["epoch", "wall_s"] + list(cats)
    rows = []
    for g in report.get("goodput", []):
        fr = g.get("fractions") or {}
        rows.append(
            [_fmt(g.get("epoch"), 4), _fmt(g.get("wall_s"), 4)]
            + [_fmt_pct(_num(fr.get(c))) for c in cats]
        )
    return headers, rows


_ANATOMY_HEADERS = ("segment", "count", "p50_s", "p99_s", "total_s")
_BILL_HEADERS = ("tenant", "device_s", "flops", "requests", "replica_s")


def _anatomy_rows(report) -> List[List[str]]:
    anatomy = report.get("trace_anatomy") or {}
    return [
        [
            name,
            str(seg.get("count", 0)),
            _fmt(seg.get("p50_s"), 5),
            _fmt(seg.get("p99_s"), 5),
            _fmt(seg.get("total_s"), 5),
        ]
        for name, seg in (anatomy.get("segments") or {}).items()
    ]


_QUALITY_HEADERS = ("tenant", "feature", "head", "psi", "ks", "ref_ver")


def _quality_rows(report) -> List[List[str]]:
    q = report.get("quality") or {}
    rows = []
    for key in sorted(q.get("scores") or {}):
        tenant, feature, head = (key.split("|") + ["-", "-"])[:3]
        sc = q["scores"][key]
        rows.append(
            [
                tenant, feature, head,
                _fmt(_num(sc.get("psi")), 4),
                _fmt(_num(sc.get("ks")), 4),
                _fmt(sc.get("version")),
            ]
        )
    return rows


def _quality_summary(report) -> List[str]:
    q = report.get("quality") or {}
    lines = [
        f"windows: {q.get('windows', 0)}  "
        f"alert events: {len(q.get('alerts') or [])}  "
        f"active: {len(q.get('alerts_active') or [])}"
    ]
    for key in q.get("alerts_active") or []:
        lines.append(f"ACTIVE ALERT: {key}")
    sink = q.get("sink")
    if sink:
        lines.append(
            f"feedback sink: accepted={sink.get('accepted')} "
            f"deduped={sink.get('deduped')} graphs={sink.get('graphs')} "
            f"packs={sink.get('packs')}"
        )
    return lines


def _bill_rows(report) -> List[List[str]]:
    return [
        [
            tenant,
            _fmt(row.get("device_s"), 5),
            _fmt_num(row.get("flops")),
            _fmt(row.get("requests"), 6),
            _fmt(row.get("replica_s"), 5),
        ]
        for tenant, row in sorted(report.get("tenant_bill", {}).items())
    ]


def render_text(report: Dict) -> str:
    lines = ["== run report =="]
    lines += _summary_lines(report)
    if report["epochs"]:
        lines += ["", "-- epochs --"]
        lines += _text_table(
            [h for h, _ in _EPOCH_COLS], _epoch_rows(report)
        )
    if report.get("goodput"):
        lines += ["", "-- goodput (wall-time fraction per category) --"]
        headers, rows = _goodput_cols(report)
        lines += _text_table(headers, rows)
    if report.get("canary"):
        lines += ["", "-- canary ladder (publish -> shadow -> verdict) --"]
        lines += _text_table(list(_CANARY_HEADERS), _canary_rows(report))
    if report["programs"]:
        lines += ["", f"-- {_programs_title(report)} --"]
        lines += _text_table(
            [h for h, _ in _PROGRAM_COLS], _program_rows(report)
        )
    if report.get("collectives"):
        lines += ["", "-- collective bytes (per mesh axis, summed over "
                  "captured programs) --"]
        for axis in sorted(report["collectives"]):
            lines.append(
                f"{axis}: {_fmt_bytes(report['collectives'][axis])}"
            )
    if report.get("trace_anatomy"):
        n = report["trace_anatomy"].get("traces", 0)
        lines += ["", f"-- request latency anatomy ({n} traced "
                  "request(s)) --"]
        lines += _text_table(list(_ANATOMY_HEADERS), _anatomy_rows(report))
    if report.get("tenant_bill"):
        lines += ["", "-- tenant bill (device-time attribution) --"]
        lines += _text_table(list(_BILL_HEADERS), _bill_rows(report))
    if report.get("quality"):
        lines += ["", "-- model quality (drift vs pinned reference) --"]
        lines += _quality_summary(report)
        rows = _quality_rows(report)
        if rows:
            lines += _text_table(list(_QUALITY_HEADERS), rows)
    if report["timeline"]:
        lines += ["", "-- timeline (s after first event) --"]
        for item in report["timeline"]:
            lines.append(
                f"{item['t']:>10.3f}  {item['event']:<20} {item['detail']}"
            )
    return "\n".join(lines) + "\n"


def render_markdown(report: Dict) -> str:
    lines = [f"# Run report: {report['run']['run']}", ""]
    lines += [line + "  " for line in _summary_lines(report)]
    if report["epochs"]:
        lines += ["", "## Epochs", ""]
        lines += _md_table([h for h, _ in _EPOCH_COLS], _epoch_rows(report))
    if report.get("goodput"):
        lines += ["", "## Goodput (wall-time fraction per category)", ""]
        headers, rows = _goodput_cols(report)
        lines += _md_table(headers, rows)
    if report.get("canary"):
        lines += ["", "## Canary ladder (publish -> shadow -> verdict)", ""]
        lines += _md_table(list(_CANARY_HEADERS), _canary_rows(report))
    if report["programs"]:
        title = _programs_title(report)
        lines += ["", f"## {title[0].upper()}{title[1:]}", ""]
        lines += _md_table(
            [h for h, _ in _PROGRAM_COLS], _program_rows(report)
        )
    if report.get("collectives"):
        lines += ["", "## Collective bytes (per mesh axis)", ""]
        lines += _md_table(
            ["axis", "bytes"],
            [
                [axis, _fmt_bytes(report["collectives"][axis])]
                for axis in sorted(report["collectives"])
            ],
        )
    if report.get("trace_anatomy"):
        n = report["trace_anatomy"].get("traces", 0)
        lines += ["", f"## Request latency anatomy ({n} traced "
                  "request(s))", ""]
        lines += _md_table(list(_ANATOMY_HEADERS), _anatomy_rows(report))
    if report.get("tenant_bill"):
        lines += ["", "## Tenant bill (device-time attribution)", ""]
        lines += _md_table(list(_BILL_HEADERS), _bill_rows(report))
    if report.get("quality"):
        lines += ["", "## Model quality (drift vs pinned reference)", ""]
        lines += [line + "  " for line in _quality_summary(report)]
        rows = _quality_rows(report)
        if rows:
            lines += [""] + _md_table(list(_QUALITY_HEADERS), rows)
    if report["timeline"]:
        lines += ["", "## Timeline", ""]
        lines += _md_table(
            ["t (s)", "event", "detail"],
            [
                [f"{i['t']:.3f}", i["event"], i["detail"]]
                for i in report["timeline"]
            ],
        )
    return "\n".join(lines) + "\n"


def render_json(report: Dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


RENDERERS = {
    "text": render_text,
    "markdown": render_markdown,
    "json": render_json,
}


# ---- perf-budget ratchet -------------------------------------------------


def budget_from_report(report: Dict,
                       tolerance: float = DEFAULT_TOLERANCE) -> Dict:
    """The committed-baseline content for this run's compiled programs.

    When the run produced an MFU figure for a bucket (goodput ledger +
    a resolvable peak — see docs/observability.md "Goodput & MFU"), it is
    recorded as that bucket's ``mfu_floor``: the check direction INVERTS
    for it (dropping below floor x (1 - tolerance) fails), so an MFU
    regression gates CI exactly like a step-cost regression."""
    programs = {}
    for key, p in sorted(report["programs"].items()):
        entry = {
            m: p[m] for m in BUDGET_METRICS if p.get(m) is not None
        }
        if p.get("mfu") is not None:
            entry["mfu_floor"] = p["mfu"]
        if entry:
            programs[key] = entry
    return {
        "version": BUDGET_VERSION,
        "tolerance": tolerance,
        "programs": programs,
    }


def load_budget(path: str) -> Dict:
    with open(path) as f:
        budget = json.load(f)
    if not isinstance(budget, dict) or "programs" not in budget:
        raise ValueError(f"{path}: not a perf-budget file (no 'programs')")
    if budget.get("version", BUDGET_VERSION) != BUDGET_VERSION:
        raise ValueError(
            f"{path}: budget version {budget.get('version')} != "
            f"{BUDGET_VERSION}"
        )
    return budget


def check_budget(
    report: Dict, budget: Dict, tolerance: Optional[float] = None
) -> Tuple[List[Dict], List[str], List[str]]:
    """(violations, unbudgeted, stale).

    A VIOLATION is a budgeted figure the run exceeded beyond tolerance —
    the gate's exit-1 condition. ``unbudgeted`` programs (in the run, not
    the baseline) and ``stale`` entries (in the baseline, not the run)
    are surfaced for the operator but do not fail: new buckets appear
    legitimately, and the ratchet only tightens by an explicit
    ``--write-budget`` commit."""
    tol = (
        float(tolerance)
        if tolerance is not None
        else float(budget.get("tolerance", DEFAULT_TOLERANCE))
    )
    violations = []
    for key, baseline in sorted(budget["programs"].items()):
        current = report["programs"].get(key)
        if current is None:
            continue
        for metric, base in baseline.items():
            if metric == "mfu_floor":
                # lower-bound metric: the run's MFU must not DROP below
                # floor x (1 - tolerance). A run with no MFU at all
                # (no peak-FLOPs entry, introspection off) is a note in
                # the CLI, never a silent pass-as-violation.
                cur = current.get("mfu")
                if cur is None or base is None:
                    continue
                limit = float(base) * (1.0 - tol)
                if float(cur) < limit:
                    violations.append(
                        {
                            "bucket": key,
                            "metric": metric,
                            "baseline": float(base),
                            "limit": limit,
                            "current": float(cur),
                            "ratio": float(cur) / float(base)
                            if base
                            else 0.0,
                        }
                    )
                continue
            cur = current.get(metric)
            if cur is None or base is None:
                continue
            limit = float(base) * (1.0 + tol)
            if float(cur) > limit:
                violations.append(
                    {
                        "bucket": key,
                        "metric": metric,
                        "baseline": float(base),
                        "limit": limit,
                        "current": float(cur),
                        "ratio": float(cur) / float(base)
                        if base
                        else float("inf"),
                    }
                )
    unbudgeted = sorted(
        set(report["programs"]) - set(budget["programs"])
    )
    stale = sorted(set(budget["programs"]) - set(report["programs"]))
    return violations, unbudgeted, stale
