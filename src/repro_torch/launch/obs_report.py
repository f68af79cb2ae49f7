"""Render a telemetry snapshot (``telemetry_*.json``) for humans.

The port's copy of the reference's ``launch/obs_report.py``: it turns one
:meth:`repro_torch.federated.telemetry.Telemetry.snapshot` (as JSON, from
either package: the two registries write the same snapshot format) into a
readable report: per-engine dispatch totals, the aggregation tree the
:class:`repro_torch.federated.tiers.TieredAbsorber` meters, counters and
gauges (the async engine's chaos counters among them), span
p50/p99/p999, and the tail of the flight-recorder event ring.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.obs_report telemetry_serving.json
    PYTHONPATH=src python -m repro_torch.launch.obs_report snap.json --events 50
    PYTHONPATH=src python -m repro_torch.launch.obs_report snap.json --prometheus
    PYTHONPATH=src python -m repro_torch.launch.obs_report snap.json --jsonl > ev.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.federated.telemetry import dispatch_summary


def _fmt_labels(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _fmt_val(v) -> str:
    if v is None:
        return "-"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.6g}"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _render_tree(snapshot: dict) -> list:
    """The aggregation-tree block: one line per tier (leaf tier first),
    drawn from the ``tier_wire_bytes_total`` / ``tier_batches_total``
    counters the :class:`repro_torch.federated.tiers.TieredAbsorber` meters at
    every boundary crossing."""
    per_tier: dict = {}
    for c in snapshot.get("counters", []):
        if c.get("name") not in ("tier_wire_bytes_total", "tier_batches_total"):
            continue
        lb = c.get("labels", {})
        key = (int(lb.get("level", 0)), str(lb.get("tier", "?")))
        row = per_tier.setdefault(key, {"wire": lb.get("wire", "fp32")})
        if c["name"] == "tier_wire_bytes_total":
            row["bytes"] = row.get("bytes", 0) + c["value"]
            if "wire" in lb:
                row["wire"] = lb["wire"]
        else:
            row["batches"] = row.get("batches", 0) + c["value"]
    if not per_tier:
        return []
    stale = {}
    for ev in snapshot.get("events", []):
        if ev.get("kind") == "tier_staleness_exceeded":
            t = str(ev.get("fields", {}).get("tier", "?"))
            stale[t] = stale.get(t, 0) + 1
    out = ["aggregation tree (leaf tier first):"]
    for i, ((level, tier), row) in enumerate(sorted(per_tier.items())):
        branch = "  " * level + ("└─ " if level else "")
        line = (
            f"  {branch}{tier:<10} wire={row['wire']:<5}"
            f" batches={_fmt_val(row.get('batches', 0)):>6}"
            f" bytes={_fmt_bytes(float(row.get('bytes', 0))):>10}"
        )
        if stale.get(tier):
            line += f"  staleness_exceeded={stale[tier]}"
        out.append(line)
    return out


def render(snapshot: dict, *, events: int = 20) -> str:
    """The human report for one snapshot dict."""
    out = []
    disp = dispatch_summary(snapshot)
    if disp:
        out.append("dispatches (host→device, per engine):")
        for eng, n in sorted(disp.items()):
            out.append(f"  {eng:<16} {n}")
    out.extend(_render_tree(snapshot))
    counters = [
        c for c in snapshot.get("counters", [])
        if c.get("name") != "engine_dispatches_total"
    ]
    if counters:
        out.append("counters:")
        for c in sorted(counters, key=lambda c: (c["name"], _fmt_labels(c["labels"]))):
            out.append(f"  {c['name']}{{{_fmt_labels(c['labels'])}}} = {_fmt_val(c['value'])}")
    gauges = snapshot.get("gauges", [])
    if gauges:
        out.append("gauges:")
        for g in sorted(gauges, key=lambda g: (g["name"], _fmt_labels(g["labels"]))):
            out.append(f"  {g['name']}{{{_fmt_labels(g['labels'])}}} = {_fmt_val(g['value'])}")
    hists = snapshot.get("histograms", [])
    if hists:
        out.append("spans / histograms (seconds):")
        out.append(f"  {'series':<48} {'n':>8} {'p50':>10} {'p99':>10} {'p999':>10}")
        for h in sorted(hists, key=lambda h: (h["name"], _fmt_labels(h["labels"]))):
            series = f"{h['name']}{{{_fmt_labels(h['labels'])}}}"
            out.append(
                f"  {series:<48} {h['count']:>8}"
                f" {_fmt_val(h['p50']):>10} {_fmt_val(h['p99']):>10}"
                f" {_fmt_val(h['p999']):>10}"
            )
    ring = snapshot.get("events", [])
    dropped = snapshot.get("events_dropped", 0)
    if ring or dropped:
        shown = ring[-events:] if events else []
        out.append(
            f"flight recorder: {len(ring)} events in ring"
            f" ({dropped} dropped), last {len(shown)}:"
        )
        for ev in shown:
            fields = ",".join(f"{k}={v}" for k, v in sorted(ev.get("fields", {}).items()))
            out.append(f"  #{ev.get('seq', '?'):<6} {ev.get('kind', '?'):<24} {fields}")
    return "\n".join(out) + "\n"


def _snapshot_prometheus(snapshot: dict) -> str:
    """Re-hydrate a snapshot into a Telemetry and expose it as Prometheus
    text (quantiles recompute from the persisted buckets)."""
    from repro_torch.federated.telemetry import Telemetry

    t = Telemetry()
    for c in snapshot.get("counters", []):
        t.counter(c["name"], **c["labels"]).set(c["value"])
    for g in snapshot.get("gauges", []):
        t.gauge(g["name"], **g["labels"]).set(g["value"])
    for h in snapshot.get("histograms", []):
        cell = t.histogram(h["name"], **h["labels"])
        cell.counts = {int(k): int(v) for k, v in h.get("buckets", {}).items()}
        cell.zero_count = int(h.get("zero_count", 0))
        cell.count = int(h.get("count", 0))
        cell.sum = float(h.get("sum", 0.0))
    return t.prometheus()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot", help="telemetry_*.json snapshot path ('-' for stdin)")
    ap.add_argument("--events", type=int, default=20,
                    help="how many trailing flight-recorder events to show")
    ap.add_argument("--prometheus", action="store_true",
                    help="emit Prometheus text exposition instead of the report")
    ap.add_argument("--jsonl", action="store_true",
                    help="emit the event ring as JSON-lines instead of the report")
    args = ap.parse_args(argv)

    if args.snapshot == "-":
        snapshot = json.load(sys.stdin)
    else:
        with open(args.snapshot) as f:
            snapshot = json.load(f)

    if args.prometheus:
        sys.stdout.write(_snapshot_prometheus(snapshot))
    elif args.jsonl:
        for ev in snapshot.get("events", []):
            sys.stdout.write(json.dumps(ev, sort_keys=True) + "\n")
    else:
        sys.stdout.write(render(snapshot, events=args.events))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
