"""Device-time breakdown of the statistics pass (``launch/train.py`` phase 1).

Runs phase 1 once to warm up (CUDA, cuBLAS and the kernel build), then once
more under ``torch.profiler`` and prints the device's busy share of the
wall time, device time by kernel group, and the ten aten ops that launched
the most device time.  A measurement tool, not a check: ``chip_smoke.py``
holds the checks.

Usage (on the card; it profiles ``chip_smoke.py``'s slice):
  PYTHONPATH=src python -m repro_torch.launch.profile_slice
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.federated.dist import resolve_device
from repro_torch.launch import train

# chip_smoke.py's slice: full-width phase 1
SLICE_ARCH = "fed3r-mnv2-proxy"
SLICE = dict(n_samples=8192, seq_len=128, n_classes=100, n_clients=100, clients_per_round=10)

# (group, substrings of the kernel's name), first match wins
KERNEL_GROUPS = (
    ("fed3r_stats (the port's CUDA kernel)", ("fed3r_stats",)),
    ("GEMM (cuBLAS: projections, MLPs, attention einsums)",
     ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
    ("softmax", ("softmax",)),
    ("reductions (norms, mean-pooling, sums)", ("reduce",)),
    ("copies and casts (dtype casts, contiguous layouts)", ("copy",)),
    ("other elementwise (scale, mask, GELU, RoPE, adds)", ("elementwise",)),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_phase1(arch: str, *, device="cuda", **run_kw) -> dict:
    """Phase 1 warm, then profiled; prints and returns the breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_slice measures device time: it runs on the card only")
    t0 = time.perf_counter()
    train.run(arch, device=dev, verbose=False, **run_kw)
    torch.cuda.synchronize()
    print(f"[profile] warm-up run: wall {time.perf_counter() - t0:.3f}s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.run(arch, device=dev, verbose=False, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy_s <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"[profile] under torch.profiler: wall {wall:.3f}s, device busy {busy_s:.3f}s "
          f"({100 * busy_s / wall:.1f}%), idle {100 * (1 - busy_s / wall):.1f}%")
    groups: dict = {}
    for e in kernels:
        g = kernel_group(e.key)
        us, calls = groups.get(g, (0.0, 0))
        groups[g] = (us + e.self_device_time_total, calls + e.count)
    for g, (us, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {us / 1e3:10.3f} ms  {100 * us / 1e6 / busy_s:5.1f}%  "
              f"{calls:6d} launches  {g}")
    # each kernel's time, charged to the innermost aten op that launched it
    aten = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(aten, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   op {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key}")
    return {"wall_s": wall, "busy_s": busy_s, "groups": groups}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    profile_phase1(SLICE_ARCH, device=ap.parse_args().device, **SLICE)


if __name__ == "__main__":
    main()
