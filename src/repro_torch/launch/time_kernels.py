"""Time ``fed3r_stats``, ``dequant_acc``, ``chol_gram``,
``batched_chol_gram``, ``rff`` and ``quantize_tiles``: each wrapper call
against its device work alone.

    PYTHONPATH=src python -m repro_torch.launch.time_kernels

On one Hopper card, at the shapes the main path gives each kernel
(``fed3r_stats`` at the slice's, the simulator's and FED3R-RF's client
shapes; ``dequant_acc`` at the uplink's A and b and at 5000 x 5000, tile
128; ``chol_gram`` at the stream's widest wave as the path packs it,
padding rows included, at a dense wave of the same rows, and at that
wave's design at D = 5000; ``batched_chol_gram`` at a K = 32 cohort of the
heads path, padded to its max_n; ``rff`` at FED3R-RF's shard and at the
stream's widest wave, D = 5000, beside ``torch.addmm``'s GEMM alone, which
computes no cos; ``quantize_tiles`` at the uplink's A and b and at
5000 x 5000), three readings
(:mod:`repro_torch.launch.timing`) of the kernel and of the one PyTorch
call that computes the same function: ``call_ms`` (back-to-back calls,
``chip_smoke.py``'s ``kernel_ms``), ``device_ms`` (a CUDA graph of the
calls replayed) and ``host_us`` (the host clock a call), which only this
script reads.  The Gram kernels, ``rff`` and ``quantize_tiles`` are also
read beside their plain versions, and each of their lines ends in a digest
of the output's bits ((G, B), ψ, (q, s)), so two trees' runs in one call
show whether their kernels agree bitwise (at the timed shapes and at
ragged ones).  Beside them the host cost of the torch
calls a launch path may pay (the capability query, the current stream, the
device guard, one ``torch.empty``).

It calls the kernels only through ``repro_torch.kernels.ops`` (and names
the Gram, ``rff`` and ``quantize_tiles`` instances through
``chol_update.pick_tile``, ``rff.pick_tile`` and ``quant.pick_cluster``
where the tree has them, timing ``rff``'s other instance too), so a copy of this file and ``timing.py`` in another tree's
``src/repro_torch/launch/`` reads that tree's wrappers the same way (an
A/B in one chip call).

Prints ``[time_kernels]`` lines, then the card's name and power limit
(nvidia-smi).
"""
from __future__ import annotations

import hashlib
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import chol_update, ops, quant, ref
from repro_torch.kernels import rff as rff_mod
from repro_torch.launch.timing import broadcast_addcmul, cuda_ms, device_ms, host_us, stacked_gram

STATS_SHAPES = {"slice": (104, 1280, 100), "simulator": (512, 1280, 100), "rf": (512, 5000, 100)}
DEQUANT_SHAPES = {"[wire] A": (1280, 1280), "[wire] b": (1280, 100), "rf width": (5000, 5000)}
TILE = 128
# the stream's and the heads path's runs in chip_smoke.py (serve_stream,
# serve_heads at full width): the arrivals, their data and D of FED3R-RF
STREAM = dict(n_waves=24, rate=4.0, skew=0.0, n_clients=100, d=1280, n_classes=100, seed=0)
RF_D = 5000
HEADS_K = 32
CHOL_RAGGED = (130, 77, 7)  # (d, n, C)
RFF_SHARD = (5120, 1280)  # FED3R-RF's shard: 10 clients of capacity 512, d = 1280
RFF_RAGGED = [(37, 130, 130), (1, 37, 4999)]  # (n, d, D), digests only
QUANT_RAGGED = [(33, 190, 128), (129, 77, 16), (450, 600, 200)]  # (M, N, tile), digests only


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


def digest(*ts: torch.Tensor) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bits."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def factor(gen: torch.Generator, d: int) -> torch.Tensor:
    """A well-conditioned lower-triangular (d, d) factor, row-major, as
    psd_cholesky hands the kernels one (its values do not change their time)."""
    A = torch.randn((d, d), generator=gen, device=gen.device)
    return torch.linalg.cholesky(A @ A.T / d + torch.eye(d, device=gen.device)).contiguous()


def gram_cases(gen: torch.Generator, stream=STREAM, rf_d=RF_D, heads_k=HEADS_K) -> dict:
    """The Gram kernels' inputs: label -> (L, Z, Y), Z and Y 3-D for the
    batched kernel.  The stream wave is the widest wave of ``serve_stream``'s
    arrivals as its engine hands it to ``chol_gram`` (the masked design of
    every client slot, padding rows included); the dense wave the same rows
    with every padding row replaced by a live sample; the stream-rf wave that
    wave's design through a random-features map of width ``rf_d``; the
    cohort the first ``heads_k`` tenants padded to the dataset's max_n, as
    ``serve_heads`` packs a miss list (α = 1)."""
    from repro_torch.configs.base import Fed3RConfig
    from repro_torch.core import fed3r
    from repro_torch.core.random_features import rff_init
    from repro_torch.data.pipeline import pack_personal_cohort
    from repro_torch.federated.arrivals import pack_schedule
    from repro_torch.launch.serve_stream import stream_setup

    dev = gen.device
    d, C = stream["d"], stream["n_classes"]
    fed, _, schedule = stream_setup(stream["n_waves"], stream["rate"], stream["skew"],
                                    stream["n_clients"], d, C, stream["seed"], dev)
    packed = pack_schedule(fed, schedule)
    t = int(np.argmax(packed.mask.sum(axis=(1, 2))))
    x = torch.as_tensor(packed.inputs[t], device=dev).reshape(-1, d)
    y = torch.as_tensor(packed.labels[t], device=dev).reshape(-1)
    m = torch.as_tensor(packed.mask[t], device=dev).reshape(-1)
    z, yh, _ = fed3r.masked_design(x, y, C, m)
    live = m > 0
    fill = torch.nonzero(live).reshape(-1)
    fill = fill[torch.arange(x.shape[0], device=dev) % fill.numel()]
    zd, yd, _ = fed3r.masked_design(torch.where(live[:, None], x, x[fill]),
                                    torch.where(live, y, y[fill]), C)
    params = rff_init(gen, d, rf_d, Fed3RConfig().rff_sigma)
    zr, _, _ = fed3r.masked_design(ref.rff_ref(x, params.omega, params.beta), y, C, m)

    ids = list(range(heads_k))
    cohort = pack_personal_cohort(
        [(fed.client(k).features, fed.client(k).labels) for k in ids], client_ids=ids,
        cohort_size=heads_k, max_n=int(fed.client_sizes().max()))
    cm = torch.as_tensor(cohort.mask, device=dev)
    K, n = cm.shape
    zc, yc, _ = fed3r.masked_design(torch.as_tensor(cohort.inputs, device=dev).reshape(K * n, d),
                                    torch.as_tensor(cohort.labels, device=dev).reshape(-1), C,
                                    cm.reshape(-1))
    L, Lr = factor(gen, d), factor(gen, rf_d)
    dr, nr, cr = CHOL_RAGGED
    Zr = torch.randn((nr, dr), generator=gen, device=dev)
    Yr = torch.nn.functional.one_hot(
        torch.randint(0, cr, (nr,), generator=gen, device=dev), cr).to(torch.float32)
    c = lambda t: t.contiguous()  # noqa: E731
    return {"stream wave": (L, c(z), c(yh)), "dense wave": (L, c(zd), c(yd)),
            "stream-rf wave": (Lr, c(zr), c(yh)), "empty wave": (L, z[:0], yh[:0]),
            "ragged": (factor(gen, dr), Zr, Yr),
            f"cohort K={K}": (L, c(zc.reshape(K, n, d)), c(yc.reshape(K, n, C)))}


def gram_lines(gen: torch.Generator) -> dict:
    sms = torch.cuda.get_device_properties(gen.device).multi_processor_count
    pick = getattr(chol_update, "pick_tile", None)  # absent from trees before it
    cases = gram_cases(gen)
    for label, (L, Z, Y) in cases.items():
        batched = Z.dim() == 3
        kernel = ops.batched_chol_gram if batched else ops.chol_gram
        plain = ref.batched_chol_gram_ref if batched else ref.chol_gram_ref
        d, n, C = L.shape[0], Z.shape[-2], Y.shape[-1]
        live = int(Z.ne(0).any(dim=-1).sum())
        line = (f"[time_kernels] {kernel.__name__} {label} d={d} n={n} ({live} live rows) C={C}"
                + (f" K={Z.shape[0]}" if batched else ""))
        if pick is not None:
            line += (f" tile {pick(d, 0, sms)}/{pick(d, C, sms, Z.shape[0])}" if batched
                     else f" tile {pick(d, C, sms)}")
        if label in ("stream wave", "dense wave", "stream-rf wave") or batched:
            line += (f": kernel {fmt(lambda: kernel(L, Z, Y))} | plain {fmt(lambda: plain(L, Z, Y))}"
                     f" | stacked torch.matmul {fmt(stacked_gram(L, Z, Y))}")
        print(f"{line} | (G, B) digest {digest(*kernel(L, Z, Y))}", flush=True)
    return cases


def rff_lines(gen: torch.Generator, stream_wave: torch.Tensor) -> None:
    """``rff`` at the rf shard and the stream wave (each instance where the
    tree can force one), then digests at ragged shapes."""
    from repro_torch.configs.base import Fed3RConfig
    from repro_torch.core.random_features import rff_init

    sms = torch.cuda.get_device_properties(gen.device).multi_processor_count
    pick = getattr(rff_mod, "pick_tile", None)  # absent from trees before it
    d = RFF_SHARD[1]
    params = rff_init(gen, d, RF_D, Fed3RConfig().rff_sigma)
    om, be = params.omega, params.beta
    shard = torch.randn(RFF_SHARD, generator=gen, device=gen.device)
    for label, Z in (("rf shard", shard), ("stream wave", stream_wave)):
        n = Z.shape[0]
        base = f"[time_kernels] rff {label} n={n} d={d} D={RF_D}"
        line = base if pick is None else f"{base} tile {pick(n, RF_D, sms)}"
        print(f"{line}: kernel {fmt(lambda: ops.rff_transform(Z, om, be))} | plain "
              f"{fmt(lambda: ref.rff_ref(Z, om, be))} | torch.addmm (the GEMM alone, no cos) "
              f"{fmt(lambda: torch.addmm(be, Z, om))} | psi digest "
              f"{digest(ops.rff_transform(Z, om, be))}", flush=True)
        if pick is not None:
            other = 192 - pick(n, RF_D, sms)
            print(f"{base} tile {other} (forced): kernel "
                  f"{fmt(lambda: rff_mod._launch(Z, om, be, tile=other))} | psi digest "
                  f"{digest(rff_mod._launch(Z, om, be, tile=other))}", flush=True)
    for n, d, D in RFF_RAGGED:
        Z = torch.randn((n, d), generator=gen, device=gen.device)
        om = torch.randn((d, D), generator=gen, device=gen.device) / d ** 0.5
        be = torch.rand((D,), generator=gen, device=gen.device) * 6.283185307179586
        print(f"[time_kernels] rff ragged n={n} d={d} D={D}: psi digest "
              f"{digest(ops.rff_transform(Z, om, be))}", flush=True)


def quant_lines(gen: torch.Generator) -> None:
    """``quantize_tiles`` at the uplink's shapes and 5000 x 5000, then
    digests at ragged shapes; a zero tile in each."""
    sms = torch.cuda.get_device_properties(gen.device).multi_processor_count
    pick = getattr(quant, "pick_cluster", None)  # absent from trees before it
    shapes = [(label, M, N, TILE) for label, (M, N) in DEQUANT_SHAPES.items()]
    shapes += [("ragged", M, N, tile) for M, N, tile in QUANT_RAGGED]
    for label, M, N, tile in shapes:
        x = torch.randn((M, N), generator=gen, device=gen.device) * 10.0
        x[:tile, :tile] = 0.0
        line = f"[time_kernels] quantize_tiles {label} ({M}, {N}) tile {tile}"
        if pick is not None:
            line += f" cluster {pick(-(-M // tile) * -(-N // tile), tile, sms)}"
        if label != "ragged":
            # the plain version copies fl(1/127) to the card: no CUDA graph, call_ms only
            line += (f": kernel {fmt(lambda: ops.quantize_tiles(x, tile=tile))} | plain call_ms "
                     f"{cuda_ms(lambda: ref.quantize_tiles_ref(x, tile)):.4f}")
        print(f"{line} | (q, s) digest {digest(*ops.quantize_tiles(x, tile=tile))}", flush=True)


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

    cases = gram_lines(gen)
    # after the Gram lines, on a generator of their own: the lines above keep
    # their inputs and digests
    gen2 = torch.Generator(device="cuda")
    gen2.manual_seed(1)
    rff_lines(gen2, cases["stream wave"][1])
    quant_lines(gen2)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[time_kernels] {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
