"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3 \
        --seconds 8 [--out chiprun_out/calibrate.json]

For each seed it runs the cell's driver as a benchmark run does (set-up, a
window of ``--seconds``, the check) and prints the numbers compared; for
each seed of ``--control-seeds`` also each control's (the reference's
``CONTROLS``: the reference in the configuration's next lower precision,
whole or in one stage, in the program's place on the same pass), and
whether the harness's result with a control's readings in place of the
program's would be correct.  The lower reading of a number is the largest
over the sound seeds, the upper the smallest a control gives.  The
benchmark's runs never run the controls.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=int, default=8)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate reads the card: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    bench = harness.manifest()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats(device)
        ctx = harness.context(args.workload, seed, args.seconds, False, device,
                              time.perf_counter())
        ctx.control = seed in control
        out = harness.driver(ctx.traffic["driver"]).run(ctx)
        row = {"seed": seed, "rounds": out["attempted"], "e2e": out["e2e"],
               "compared": {k: c["value"] for k, c in out["compared"].items()},
               "control": out["control"], "control_correct": {}}
        for name, readings in (out["control"] or {}).items():
            swapped = dict(out, compared={k: {"value": readings.get(k, c["value"]),
                                              "limit": c["limit"]}
                                          for k, c in out["compared"].items()})
            row["control_correct"][name] = harness.result(bench, ctx, swapped, {})["correct"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    names = rows[0]["compared"].keys()
    controls = [r["control"] for r in rows if r["control"]]
    kinds = sorted({name for c in controls for name in c})
    summary = {k: {"lower": max(r["compared"][k] for r in rows),
                   **{f"upper.{kind}": min((c[kind][k] for c in controls if k in c[kind]),
                                           default=None) for kind in kinds}} for k in names}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
