"""Time ``fed3r_stats`` and ``dequant_acc``: each wrapper call against its device work alone.

    PYTHONPATH=src python -m repro_torch.launch.time_kernels

On one Hopper card, at the shapes the main path gives each kernel
(``fed3r_stats`` at the slice's, the simulator's and FED3R-RF's client
shapes; ``dequant_acc`` at the uplink's A and b and at 5000 x 5000, tile
128), three readings (:mod:`repro_torch.launch.timing`) of the kernel and
of the one PyTorch call that computes the same function: ``call_ms``
(back-to-back calls, ``chip_smoke.py``'s ``kernel_ms``), ``device_ms``
(a CUDA graph of the calls replayed) and ``host_us`` (the host clock a
call), which only this script reads.  Beside them the host cost of the
torch calls a launch path may pay (the capability query, the current
stream, the device guard, one ``torch.empty``).

It calls the kernels only through ``repro_torch.kernels.ops``, so a copy
of this file and ``timing.py`` in another tree's ``src/repro_torch/launch/``
reads that tree's wrappers the same way (an A/B in one chip call).

Prints ``[time_kernels]`` lines, then the card's name and power limit
(nvidia-smi).
"""
from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable

import torch

from repro_torch.kernels import ops
from repro_torch.launch.timing import broadcast_addcmul, cuda_ms, device_ms, host_us

STATS_SHAPES = {"slice": (104, 1280, 100), "simulator": (512, 1280, 100), "rf": (512, 5000, 100)}
DEQUANT_SHAPES = {"[wire] A": (1280, 1280), "[wire] b": (1280, 100), "rf width": (5000, 5000)}
TILE = 128


def fmt(fn: Callable[[], object]) -> str:
    fn()  # the first call builds the kernel's library: outside every reading
    torch.cuda.synchronize()
    return (f"call_ms {cuda_ms(fn):.4f}  device_ms {device_ms(fn):.4f}  "
            f"host_us {host_us(fn):.1f}")


def _guarded(dev) -> None:
    with torch.cuda.device(dev):
        pass


def host_pieces() -> str:
    """The host cost of the torch calls a wrapper's launch path may pay, in µs."""
    dev = torch.device("cuda", torch.cuda.current_device())
    pieces = {
        "get_device_capability": lambda: torch.cuda.get_device_capability(dev),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "with torch.cuda.device": lambda: _guarded(dev),
        "torch.empty (1280, 1280)": lambda: torch.empty((1280, 1280), device=dev),
    }
    out = []
    for name, fn in pieces.items():
        for _ in range(10):
            fn()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        out.append(f"{name} {1e3 * (time.perf_counter() - t0):.2f} µs")
    return "  ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernels: torch sees no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[time_kernels] host pieces: {host_pieces()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    for label, (n, d, C) in STATS_SHAPES.items():
        Z = torch.randn((n, d), generator=gen, device="cuda")
        Y = torch.nn.functional.one_hot(
            torch.randint(0, C, (n,), generator=gen, device="cuda"), C).to(torch.float32)
        ZY = torch.cat([Z, Y], dim=1)
        print(f"[time_kernels] fed3r_stats {label} n={n} d={d} C={C}: "
              f"kernel {fmt(lambda: ops.fed3r_stats(Z, Y))} | torch.matmul Z^T[Z|Y] "
              f"{fmt(lambda: torch.matmul(Z.T, ZY))}", flush=True)

    for label, (M, N) in DEQUANT_SHAPES.items():
        x = torch.randn((M, N), generator=gen, device="cuda")
        acc = torch.randn((M, N), generator=gen, device="cuda")
        q, s = ops.quantize_tiles(x, tile=TILE)
        line = (f"[time_kernels] dequant_acc {label} ({M}, {N}) tile {TILE}: kernel "
                f"{fmt(lambda: ops.dequant_accumulate(acc, q, s, tile=TILE))}")
        lib = broadcast_addcmul(acc, q, s, TILE)
        if lib is None:
            line += " | no one PyTorch call computes it at this shape"
        else:
            same = torch.equal(lib().reshape(M, N), ops.dequant_accumulate(acc, q, s, tile=TILE))
            qf = q.to(torch.float32)
            se = s.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)[:M, :N].contiguous()
            line += (f" | torch.addcmul on broadcast views {fmt(lib)}, bitwise the kernel: "
                     f"{same} | torch.addcmul on a float q and pre-expanded scales "
                     f"{fmt(lambda: torch.addcmul(acc, qf, se))}")
        print(line, flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[time_kernels] {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
