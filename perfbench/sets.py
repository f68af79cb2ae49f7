"""Sets of benchmark runs, each in its own process, with what the card and the
host did during each window logged beside it.

    python3 perfbench/sets.py --workload <cell> --seeds 11,12,13,14,15,16 --sets 2 \
        --seconds 50 [--trace 0] [--out chiprun_out/sets]

from the root of a checkout.  It runs ``perfbench/run.py`` once a seed, set
after set with the same seeds, as the bounds are measured.  Beside each run
it keeps:

* the card over the run's window: SM and memory clocks, power draw,
  temperature and the clock-event reasons, from one ``nvidia-smi`` logger (a
  line a second) started before the first run and stopped after the last;
* the host over the window: the machine's CPU time by kind (user, system,
  steal, idle, from ``/proc/stat``) and its load average, sampled every half
  second; the run's own CPU seconds, page faults and context switches;
* two probes of the host right before the run, of the two things a round's
  packing does: a copy between warm 256 MiB arrays (memory bandwidth) and
  64 MiB of fresh pages written (the cost of faulting pages in).

It prints a JSON line a run, then each end-to-end metric's median and spread
a set, (Q3 - Q1) / median by ``statistics.quantiles(n=4)``, and writes all of
it to ``<out>/sets.json``.  It imports neither torch nor the port.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from datetime import datetime
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GPU_FIELDS = ["timestamp", "clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "utilization.gpu", "clocks_event_reasons.active"]
STAT_KINDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values):
    """The spread with the run farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


class Logger:
    """The card's readings from one ``nvidia-smi`` process and the host's
    from ``/proc`` every half second, each with its time."""

    def __init__(self, path: Path):
        self.gpu, self.host = [], []
        fields = list(GPU_FIELDS)
        try:
            probe = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            probe = None
        if probe is not None and probe.returncode != 0:  # an older driver's name
            fields[-1] = "clocks_throttle_reasons.active"
        self.fields = fields
        self.path = path
        self.log = open(path, "w")
        self.proc = None if probe is None else subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader,nounits",
             "-lms", "1000"], stdout=self.log, stderr=subprocess.DEVNULL)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()

    def _sample(self):
        while not self.stop.is_set():
            with open("/proc/stat") as f:
                cpu = [int(v) for v in f.readline().split()[1:1 + len(STAT_KINDS)]]
            with open("/proc/loadavg") as f:
                load = float(f.read().split()[0])
            self.host.append((time.time(), cpu, load))
            self.stop.wait(0.5)

    def close(self):
        self.stop.set()
        self.thread.join()
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
        self.log.close()
        for line in self.path.read_text().splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != len(self.fields):
                continue
            try:
                t = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.gpu.append((t, [float(p) if i < 5 else p
                                     for i, p in enumerate(parts[1:])]))
            except ValueError:
                continue

    def window(self, t0: float, t1: float) -> dict:
        """The card's and the host's readings over [t0, t1]."""
        out = {}
        gpu = [v for t, v in self.gpu if t0 <= t <= t1]
        if gpu:
            cols = list(zip(*gpu))
            for name, col in zip(("sm_mhz", "mem_mhz", "power_w", "temp_c"), cols[:4]):
                out[name] = [min(col), statistics.fmean(col), max(col)]
            out["reasons"] = sorted(set(cols[5]))
        host = [(t, cpu, load) for t, cpu, load in self.host if t0 <= t <= t1]
        if len(host) >= 2:
            delta = [b - a for a, b in zip(host[0][1], host[-1][1])]
            total = sum(delta) or 1
            out["cpu_pct"] = {k: 100.0 * v / total for k, v in zip(STAT_KINDS, delta)}
            out["load"] = [min(h[2] for h in host), max(h[2] for h in host)]
        return out


def probes() -> dict:
    """Warm copy bandwidth and the cost of fresh pages, best of three."""
    warm_src = np.ones(32 << 20)  # 256 MiB of float64
    warm_dst = np.empty_like(warm_src)
    np.copyto(warm_dst, warm_src)
    copy, fresh = [], []
    for _ in range(3):
        t = time.perf_counter()
        np.copyto(warm_dst, warm_src)
        copy.append(time.perf_counter() - t)
        t = time.perf_counter()
        page = np.ones(8 << 20)  # 64 MiB, fresh pages
        fresh.append(time.perf_counter() - t)
        del page
    return {"copy_gb_s": warm_src.nbytes / min(copy) / 1e9,
            "fresh_ms_64mib": 1e3 * min(fresh)}


def run_one(args, seed: int, out: Path, tag: str) -> dict:
    cmd = [sys.executable, "perfbench/run.py", "--workload", args.workload, "--seed", str(seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace)]
    probe = probes()
    with open(out / f"{tag}.out", "w") as fo, open(out / f"{tag}.err", "w") as fe:
        t0 = time.time()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fo, stderr=fe)
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        wall = time.time() - t0
    lines = (out / f"{tag}.out").read_text().strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    row = {"tag": tag, "seed": seed, "rc": proc.returncode, "wall_s": wall, "probe": probe,
           "run": {"user_s": usage.ru_utime, "sys_s": usage.ru_stime, "minflt": usage.ru_minflt,
                   "majflt": usage.ru_majflt, "nvcsw": usage.ru_nvcsw, "nivcsw": usage.ru_nivcsw}}
    if result:
        metrics = {k: m["value"] for k, m in result["metrics"].items()}
        row.update(correct=result["correct"], metrics=metrics,
                   compared={k: c["value"] for k, c in result["compared"].items()})
        start = t0 + metrics.get("setup_s", 0.0)
        row["window_t"] = [start, start + args.seconds]
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default="chiprun_out/sets")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = (ROOT / args.out) if not Path(args.out).is_absolute() else Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log = Logger(out / "nvidia-smi.csv")
    rows = []
    try:
        for k in range(args.sets):
            rows += [run_one(args, seed, out, f"s{k + 1}-{seed}") for seed in seeds]
    finally:
        log.close()
    for row in rows:  # the windows' readings, now that the card's log is complete
        if "window_t" in row:
            row["window"] = log.window(*row.pop("window_t"))
            print(json.dumps({"tag": row["tag"], "window": row["window"]}), flush=True)
    summary = {}
    for k in range(args.sets):
        sel = [r for r in rows[k * len(seeds):(k + 1) * len(seeds)] if "metrics" in r]
        for name in (sel[0]["metrics"] if sel else ()):
            values = [r["metrics"][name] for r in sel]
            entry = summary.setdefault(name, [])
            entry.append({"median": statistics.median(values),
                          "spread": spread(values) if len(values) >= 2 else None,
                          "trimmed": trimmed_spread(values) if len(values) >= 3 else None,
                          "values": values})
    for name, sets in summary.items():
        print(json.dumps({"metric": name, "sets": [{k: v for k, v in s.items() if k != "values"}
                                                   for s in sets]}), flush=True)
    (out / "sets.json").write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0 if all(r["rc"] == 0 and r.get("correct") for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
