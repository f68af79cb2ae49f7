"""Time the flash-attention kernel beside SDPA and beside ablated copies of its source.

    PYTHONPATH=src python -m repro_torch.launch.time_flash

On one Hopper card, at ``chip_smoke.py``'s three timed shapes (serve,
long, hd-256; bf16, causal, no window): the kernel through
``ops.flash_attention``, checked first against its plain version in fp32,
then ``F.scaled_dot_product_attention`` (``is_causal``, ``enable_gqa``)
as the yardstick.  Each reading is the mean of 20 back-to-back launches
after one warm-up, timed with CUDA events.

Beside them, two edited copies of ``csrc/flash_attention.cu``, built
with the same nvcc flags into ``build/flash_variants/`` and launched
through the same C interface: ``no_softmax`` (the online softmax left out:
p is the raw score) and ``no_mma`` (the ``wgmma`` products left out).
Their outputs are garbage and are never checked; their times show which
part of the loop bounds it.  An edit whose anchor the source no longer
holds raises.

Prints one ``[time_flash]`` line a shape, then the card's name and power
limit (nvidia-smi).
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref

SHAPES = {"serve": (8, 2048, 28, 4, 128), "long": (1, 8192, 28, 4, 128),
          "hd-256": (2, 4096, 16, 1, 256)}
ITERS = 20
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet, 700 W)
SIGNATURE = "float& l0, float& l1, float& al0, float& al1) {\n"  # softmax_tile's
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "no_softmax": [(SIGNATURE, SIGNATURE + "  al0 = al1 = 1.0f;\n  return;\n")],
    "no_mma": [("    wgmma_ss(s, da, db, kk > 0);\n", ""),
               ("    wgmma_rs(o, p[kk], db, 1);\n", "")],
}


def build_variant(name: str, edits: List[Tuple[str, str]]):
    """The kernel's source with ``edits`` applied, compiled and bound."""
    src = fa.LIBRARY.source.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"time_flash: variant {name}: anchor not in the source: {old!r}")
        src = src.replace(old, new)
    tag = hashlib.sha256((src + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out_dir = build.BUILD_DIR / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}-{tag}.cu", out_dir / f"{name}-{tag}.so"
    if not so.exists():
        cu.write_text(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                       capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).flash_attention_launch
    fn.argtypes, fn.restype = fa.LIBRARY.functions["flash_attention_launch"]
    return fn


def launch_variant(fn, q, k, v, o) -> None:
    B, S, H, hd = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, 1, B, S, H,
             k.shape[2], hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
             v.stride(1), o.stride(0), o.stride(1), 1, 0, hd ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"time_flash: a variant's launch failed: cudaError {err}")


def mean_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("time_flash: torch sees no CUDA card", file=sys.stderr)
        return 1
    variants = {name: build_variant(name, edits) for name, edits in ABLATIONS.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, (B, S, H, KV, hd) in SHAPES.items():
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (H, KV, KV))
        got = ops.flash_attention(q, k, v).float()
        want = flash_attention_ref(q.float(), k.float(), v.float())
        err = float((got - want).abs().max())
        if not err <= 3e-2:
            raise AssertionError(f"time_flash: the kernel is {err} from its plain version")
        del got, want
        flops = 4.0 * B * H * hd * S * (S + 1) / 2
        bound = flops / BF16_FLOPS * 1e3
        times = {"kernel": mean_ms(lambda: ops.flash_attention(q, k, v))}
        o = torch.empty_like(q)
        for name, fn in variants.items():
            times[name] = mean_ms(lambda: launch_variant(fn, q, k, v, o))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        times["sdpa"] = mean_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"[time_flash] {label} {(B, S, H, KV, hd)} bf16 causal: "
              + "  ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
              + f"  bound {bound:.4f} ms (kernel at {100 * bound / times['kernel']:.1f}% of it,"
              f" {times['kernel'] / times['sdpa']:.3f}x sdpa)  max|do| {err:.3e}", flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[time_flash] {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
