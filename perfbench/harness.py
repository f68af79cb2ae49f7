"""What ``perfbench/run.py`` does once its arguments are read.

It finds the cell in ``BENCHMARK.json`` and everything the cell names by
that name: the configuration's file, ``traffic/<traffic>.json`` (which names
the driver), ``workloads/<cell>.json``, ``drivers/<driver>.py``,
``families/<family>.py``, ``reference/<family>.py`` and, with ``--trace 1``,
``metrics/<metric>.py`` for each per-layer metric of the cell.  It runs the
driver on the card, checks that no JAX module was loaded, and prints the
numbers compared with their limits as the last lines of standard error and
the result as the last line of standard output.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level names, compared whole


@dataclass
class Context:
    name: str
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: int
    trace: bool
    device: object
    t_start: float
    control: bool = False


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def family(name: str):
    return importlib.import_module(f"perfbench.families.{name}")


def reference(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> value or None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def context(name: str, seed: int, seconds: int, trace: bool, device, t_start: float,
            bench: Optional[dict] = None) -> Context:
    bench = bench or manifest()
    work = {w["name"]: w for w in bench["workloads"]}[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return Context(name=name, config=load_json(ROOT / config_entry["file"]),
                   traffic=load_json(HERE / "traffic" / f"{work['traffic']}.json"),
                   cell=load_json(HERE / "workloads" / f"{name}.json"), seed=seed,
                   seconds=seconds, trace=trace, device=device, t_start=t_start)


def applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return lines[0] if lines else "unknown"


def result(bench: dict, ctx: Context, out: dict, device: dict) -> dict:
    """The result line's object: the cell's end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    metrics = {}
    if ctx.trace:
        e2e = {m["name"] for m in bench["end_to_end"] if applies(m, ctx.name)}
        for m in bench["per_layer"]:
            if ("workloads" in m and ctx.name in m["workloads"]) or (
                    "workloads" not in m and m["moves"] in e2e):
                value = metric_reader(m["name"])(out["record"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, ctx.name):
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    # a NaN reading compares False: not correct
    line = {"correct": all(c["value"] <= c["limit"] for c in out["compared"].values()),
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device}
    if ctx.trace:
        line["breakdown"] = {k: out["trace"][k] for k in ("device_ops", "idle_gaps")}
    line["compared"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else repr(c["value"]),
                            "limit": c["limit"]} for k, c in out["compared"].items()}
    return line


def main(args, t_start: float) -> int:
    import torch

    bench = manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace), device, t_start, bench)
    out = driver(ctx.traffic["driver"]).run(ctx)
    found = banned_modules()
    if found:
        print(f"JAX modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(out["peak_bytes"]), "power_limit": power_limit()}
    if ctx.trace:
        dev.update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
    line = result(bench, ctx, out, dev)
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
