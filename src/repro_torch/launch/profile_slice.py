"""Device-time breakdowns of ``chip_smoke.py``'s cells under ``torch.profiler``.

* ``--cell slice``: the statistics pass (``launch/train.py`` phase 1), run
  once to warm up (CUDA, cuBLAS and the kernel build), then once more
  profiled;
* ``--cell serve``: the dense serving cell (Qwen2-7B at full width, batch
  8 × 2048-token prompts): one prefill and 16 decode steps to warm up, then
  one prefill and 16 decode steps, each profiled on its own;
* ``--cell serve-moe``: the same for the MoE serving cell (DeepSeekMoE 16B
  at full width and depth, batch 8 × 2048-token prompts);
* ``--cell serve-ssm``, ``serve-hybrid``, ``serve-vlm``, ``serve-audio``:
  the same for the SSM, hybrid, VLM and audio serving cells at full width
  and depth (Mamba2 1.3B at 8 × 2048, RecurrentGemma 9B at 2 × 4096,
  Qwen2-VL 2B at 8 × (256 patches + 2048), Whisper large-v3 at 16 × (1500
  frames + 224 tokens));
* ``--cell rf``: ``chip_smoke.py``'s ``[rf]`` cell (``run_fed3r`` FED3R-RF
  at D = 5000 on the simulator's 50,000 features, 100 clients, 10 a
  round; both build it with :mod:`repro_torch.configs.simulator`), run
  once to warm up, then ``RF_WALLS`` times on the host clock
  (the spread of its wall on one card), then once profiled;
* ``--cell ft``: one round of ``launch/train.py`` phase 2 at full width
  (``chip_smoke.py``'s ``[ft]``: FT-FEAT FedAvg, 10 clients × 2 steps × 64
  × 128 tokens, the cohort on the card), run ``FT_WARM`` times to warm up,
  then once profiled: the round's device time by kernel group.

Each prints the device's busy share of the wall time, device time by
kernel group, and the ten aten ops that launched the most device time.
The profiler adds host time to every op, so a host-bound phase (decode)
reads idler here than it runs.  A measurement tool, not a check:
``chip_smoke.py`` holds the checks.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.profile_slice [--cell serve|serve-audio|rf|ft|...]
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

# chip_smoke.py's serve and serve-moe cells
SERVE_ARCH = "qwen2-7b"
MOE_ARCH = "deepseek-moe-16b"
SERVE = dict(batch=8, prompt_len=2048, gen=64)
DECODE_STEPS = 16
# chip_smoke.py's serve-ssm, serve-hybrid, serve-vlm and serve-audio cells
FAMILY_CELLS = {"serve-ssm": ("mamba2-1.3b", SERVE),
                "serve-hybrid": ("recurrentgemma-9b", dict(batch=2, prompt_len=4096, gen=64)),
                "serve-vlm": ("qwen2-vl-2b", SERVE),
                "serve-audio": ("whisper-large-v3", dict(batch=16, prompt_len=224, gen=64))}

RF_WALLS = 3

# chip_smoke.py's [ft] round
FT_LOCAL_BATCH = 64
FT_WARM = 2

# (group, substrings of the kernel's name), first match wins
KERNEL_GROUPS = (
    ("fed3r_stats (the port's CUDA kernel)", ("fed3r_stats",)),
    ("rff (the port's CUDA kernel)", ("rff_kernel",)),
    ("flash_attention (the port's CUDA kernel)", ("flash_bf16", "flash_fp32")),
    ("Cholesky and triangular solves (cuSOLVER, cuBLAS trsm)", ("potrf", "trsm", "trsv")),
    ("GEMM (cuBLAS: projections, MLPs, attention einsums)",
     ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
    ("softmax", ("softmax",)),
    ("sort, scan, scatter, index, gather (MoE routing, dispatch and combine; the SSD's cumsum)",
     ("sort", "scan", "scatter", "index", "gather")),
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


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_slice measures device time: it runs on the card only")
    return dev


def _profiled(fn):
    """Run ``fn`` under torch.profiler; return (its profile, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _report(prof, wall: float, label: str = "") -> dict:
    """Print the busy share, the kernel groups and the top aten ops."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy_s <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    tag = f"[profile]{' ' + label if label else ''}"
    print(f"{tag} under torch.profiler: wall {wall:.3f}s, device busy {busy_s:.3f}s "
          f"({100 * busy_s / wall:.1f}%), idle {100 * (1 - busy_s / wall):.1f}%")
    groups: dict = {}
    for e in kernels:
        g = kernel_group(e.key)
        us, calls = groups.get(g, (0.0, 0))
        groups[g] = (us + e.self_device_time_total, calls + e.count)
    for g, (us, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}   {us / 1e3:10.3f} ms  {100 * us / 1e6 / busy_s:5.1f}%  "
              f"{calls:6d} launches  {g}")
    # each kernel's time, charged to the innermost aten op that launched it
    aten = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(aten, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"{tag}   op {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key}")
    return {"wall_s": wall, "busy_s": busy_s, "groups": groups}


def profile_phase1(arch: str, *, device="cuda", **run_kw) -> dict:
    """Phase 1 warm, then profiled; prints and returns the breakdown."""
    dev = _card(device)
    t0 = time.perf_counter()
    train.run(arch, device=dev, verbose=False, **run_kw)
    torch.cuda.synchronize()
    print(f"[profile] warm-up run: wall {time.perf_counter() - t0:.3f}s", flush=True)
    prof, wall = _profiled(lambda: train.run(arch, device=dev, verbose=False, **run_kw))
    return _report(prof, wall)


def profile_serve(arch: str, *, batch: int, prompt_len: int, gen: int, device="cuda") -> dict:
    """One prefill and DECODE_STEPS decode steps warm, then each profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = _card(device)
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    gen_ = torch.Generator(device=dev)
    gen_.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len + DECODE_STEPS), generator=gen_,
                         device=dev)
    fed, off = {"tokens": toks[:, :prompt_len]}, 0
    if cfg.arch_type == "vlm":  # serve's patch prefix, and the positions it takes
        off = cfg.n_patches
        fed["patch_embeds"] = 0.1 * torch.randn((batch, off, cfg.d_model), generator=gen_,
                                                device=dev)
    if cfg.arch_type == "audio":  # serve's encoder frames
        fed["audio_frames"] = 0.1 * torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                                generator=gen_, device=dev)
    state = {}

    def prefill():
        state["cache"] = model.prefill(params, fed, cache_capacity=off + prompt_len + gen)[1]

    def decode():
        for i in range(DECODE_STEPS):
            p = prompt_len + i
            model.decode_step(params, state["cache"], toks[:, p:p + 1], off + p)

    prefill()
    decode()
    torch.cuda.synchronize()
    shape = f"{arch} batch {batch} x prompt {prompt_len}"
    out = {"prefill": _report(*_profiled(prefill), f"prefill {shape}")}
    out["decode"] = _report(*_profiled(decode), f"decode {shape}, {DECODE_STEPS} steps")
    return out


def profile_rf(device="cuda") -> dict:
    """FED3R-RF warm, then RF_WALLS timed runs, then one profiled."""
    from repro_torch.configs.simulator import RF_D, simulator_setup
    from repro_torch.federated.fed3r_driver import run_fed3r

    dev = _card(device)
    fed, test, f3, fc = simulator_setup(dev, n_random_features=RF_D)

    def run():
        run_fed3r(fed, test.features, test.labels, f3, fc, device=dev)

    walls = []
    for _ in range(1 + RF_WALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"[profile] rf D={RF_D}: warm-up run {walls[0]:.3f}s, then walls "
          + ", ".join(f"{w:.3f}s" for w in walls[1:]), flush=True)
    return _report(*_profiled(run), f"rf D={RF_D}")


def profile_ft(device="cuda") -> dict:
    """One full-width FT round warm (``FT_WARM`` times), then one profiled."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.models import build_model

    dev = _card(device)
    cfg = get_config(SLICE_ARCH)
    params = build_model(cfg).init(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ds = make_token_dataset(gen, SLICE["n_samples"], SLICE["seq_len"], cfg.vocab_size,
                            SLICE["n_classes"])
    gen.manual_seed(0)
    head = {"W": 0.01 * torch.randn((cfg.d_feat, SLICE["n_classes"]), generator=gen, device=dev),
            "b": torch.zeros((SLICE["n_classes"],), device=dev)}
    clients = train.FtClients(ds, SLICE["n_clients"], SLICE["clients_per_round"], FT_LOCAL_BATCH)
    engine = train.ft_engine(cfg, params, n_clients=SLICE["n_clients"])
    state = engine.init({"backbone": params, "head": head})
    cohort = clients.cohort(0).to(dev)
    walls = []
    for _ in range(FT_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step(state, cohort)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"[profile] ft {SLICE_ARCH}: {cohort.cohort} clients x {cohort.mask.shape[1]} steps x "
          f"{FT_LOCAL_BATCH} x {SLICE['seq_len']} tokens; warm-up rounds "
          + ", ".join(f"{w:.3f}s" for w in walls), flush=True)
    return _report(*_profiled(lambda: engine.step(state, cohort)), f"ft {SLICE_ARCH} round")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cell", choices=("slice", "serve", "serve-moe", "rf", "ft", *FAMILY_CELLS),
                    default="slice")
    args = ap.parse_args()
    if args.cell in ("serve", "serve-moe"):
        profile_serve(SERVE_ARCH if args.cell == "serve" else MOE_ARCH, device=args.device,
                      **SERVE)
    elif args.cell in FAMILY_CELLS:
        arch, shape = FAMILY_CELLS[args.cell]
        profile_serve(arch, device=args.device, **shape)
    elif args.cell == "rf":
        profile_rf(device=args.device)
    elif args.cell == "ft":
        profile_ft(device=args.device)
    else:
        profile_phase1(SLICE_ARCH, device=args.device, **SLICE)


if __name__ == "__main__":
    main()
