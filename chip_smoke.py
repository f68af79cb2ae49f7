#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build     -- compile the ``fed3r_stats`` CUDA kernel from
                ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a.
2. slice     -- the port's main path: ``launch/train.py`` phase 1 on
                ``fed3r-mnv2-proxy`` at full width (d_model 1280, 6 layers),
                8192 samples x 128 tokens, 100 one-class clients, 10 per
                shard.  The kernel's launch count is reset just before and
                read just after, and must equal the client slots folded.
                Then the same phase at the smoke width in fp32 on the card
                against the CPU's plain path, on the same params and tokens.
3. simulator -- ``run_fed3r`` / ``run_fedncm`` over 1280-dim features:
                convergence in ceil(K/kappa) rounds and the federated W
                against a centralized solve of the pooled statistics.
4. kernel    -- ``fed3r_stats`` against its plain PyTorch version at the
                shapes the slice and the simulator gave it and at two
                ragged shapes, and at the slice's shape the times of
                kernel, plain version and one ``torch.matmul``.

The device-time breakdown of the slice is a separate command,
``python -m repro_torch.launch.profile_slice``.

The lines before the last are a ``{"kernels": [...]}`` JSON object and the
card's name and power limit (nvidia-smi); the last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero and prints no
result where torch sees no CUDA card or the port's sources are missing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain version, and card vs CPU on the same statistics: fp32 sums
# in different orders, so the gap scales with the largest entry
STATS_REL = 1e-5
# the slice's small-input check: its fp32 backbone runs on the card's and the
# CPU's GEMMs, and the lambda = 0.01 solve amplifies that by cond(A + lambda I)
# of mean-pooled random-backbone features (~1e5): a loose bound on W's
# unit-norm columns, beside the tight one on A and b
SMOKE_W_ATOL = 1e-2
# the simulator's W against the centralized solve: Gaussian class clusters
# with n >> d keep A well-conditioned, so fp32 reassociation only
SIM_W_ATOL = 1e-4
KERNEL_SHAPES_RAGGED = [(513, 1281, 37), (64, 32, 5)]
# the main path: launch/train.py phase 1 at full width
SLICE_ARCH = "fed3r-mnv2-proxy"
SLICE = dict(n_samples=8192, seq_len=128, n_classes=100, n_clients=100, clients_per_round=10)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_rel_err(got, want) -> float:
    """max |got - want| / max |want| (0/0 -> 0)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(kmod) -> dict:
    seconds = kmod.load()
    log(f"[build] {kmod.SOURCE.relative_to(ROOT)} -> {kmod.library_path().relative_to(ROOT)} "
        f"(nvcc {' '.join(kmod.NVCC_FLAGS)}) in {seconds:.2f}s")
    for line in kmod.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    return {"seconds": seconds}


def phase_slice(torch, ops) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.data.synthetic import make_token_dataset

    arch, n_classes, n_samples = SLICE_ARCH, SLICE["n_classes"], SLICE["n_samples"]
    cfg = get_config(arch)
    log(f"[slice] {arch}: d_model={cfg.d_model} layers={cfg.n_layers} heads={cfg.n_heads}x{cfg.hd} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype}; {n_samples} samples x "
        f"{SLICE['seq_len']} tokens, {n_classes} classes, {SLICE['n_clients']} clients "
        f"(alpha=0), {SLICE['clients_per_round']}/shard")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.fed3r_stats.launches = 0
    t0 = time.perf_counter()
    out = train.run(arch, device="cuda", **SLICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.fed3r_stats.launches
    peak = torch.cuda.max_memory_allocated()
    W = out["W"]
    log(f"[slice] wall {wall:.3f}s  peak memory {peak / 2**30:.3f} GiB  fed3r_stats launches "
        f"{launches} for {out['n_slots']} client slots of capacity max_n={out['max_n']}")
    if launches != out["n_slots"]:
        raise AssertionError(f"fed3r_stats launched {launches} times for {out['n_slots']} slots")
    if tuple(W.shape) != (cfg.d_feat, n_classes) or not bool(torch.isfinite(W).all()):
        raise AssertionError(f"W is not a finite {(cfg.d_feat, n_classes)} matrix")
    if not bool(torch.isfinite(out["stats"].A).all()) or float(out["stats"].n) != n_samples:
        raise AssertionError("statistics are not finite or miss samples")
    if out["fed3r_acc"] <= 2.0 / n_classes:
        raise AssertionError(f"accuracy {out['fed3r_acc']} is not above chance {1 / n_classes}")

    # The same phase at the smoke width, fp32 activations, on the card and on
    # the CPU's plain path, from the same params and tokens.
    smoke = get_config(arch + "-smoke").replace(dtype="float32")
    params_cpu = build_model(smoke).init(seed=0, device="cpu")
    params_gpu = _to(params_cpu, "cuda")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    ds_cpu = make_token_dataset(gen, 512, 32, smoke.vocab_size, 16)
    ds_gpu = type(ds_cpu)(*(_to(t, "cuda") for t in ds_cpu[:3]), ds_cpu.n_classes)
    kw = dict(n_clients=16, clients_per_round=4, verbose=False)
    got = train.fed3r_phase(smoke, params_gpu, ds_gpu, device="cuda", **kw)
    want = train.fed3r_phase(smoke, params_cpu, ds_cpu, device="cpu", **kw)
    errs = {
        "A": max_rel_err(got["stats"].A.cpu(), want["stats"].A),
        "b": max_rel_err(got["stats"].b.cpu(), want["stats"].b),
        "W": float((got["W"].cpu() - want["W"]).abs().max()),
    }
    log(f"[slice] smoke width, fp32, card vs CPU plain path: max|dA|/max|A| {errs['A']:.3e}  "
        f"max|db|/max|b| {errs['b']:.3e} (limit {STATS_REL:g})  max|dW| {errs['W']:.3e} "
        f"(limit {SMOKE_W_ATOL:g})  acc {got['fed3r_acc']:.4f} vs {want['fed3r_acc']:.4f}")
    if errs["A"] > STATS_REL or errs["b"] > STATS_REL or errs["W"] > SMOKE_W_ATOL:
        raise AssertionError(f"smoke-width phase 1 on the card disagrees with the CPU: {errs}")
    return {"launches": launches, "max_n": out["max_n"], "d": cfg.d_feat, "C": n_classes,
            "wall_s": wall, "peak_bytes": peak, "acc": out["fed3r_acc"]}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_simulator(torch, ops) -> dict:
    from repro_torch.configs.base import Fed3RConfig, FederatedConfig
    from repro_torch.core import fed3r, ncm
    from repro_torch.data.pipeline import make_federated_features
    from repro_torch.federated.fed3r_driver import PACK_ROUND_TO, run_fed3r, run_fedncm

    n, d, C, K, kappa = 50_000, 1280, 100, 100, 10
    fed, test = make_federated_features(seed=0, n=n, d=d, n_classes=C, n_clients=K, alpha=0.0,
                                        noise=2.0, device="cuda")
    f3 = Fed3RConfig(ridge_lambda=0.01, n_classes=C)
    fc = FederatedConfig(n_clients=K, clients_per_round=kappa, n_rounds=K)
    torch.cuda.synchronize()
    ops.fed3r_stats.launches = 0
    t0 = time.perf_counter()
    W, stats, hist = run_fed3r(fed, test.features, test.labels, f3, fc, eval_every=1,
                               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.fed3r_stats.launches
    rounds = -(-K // kappa)
    log(f"[sim] run_fed3r: {K} clients, {kappa}/round, d={d}, C={C}, {len(fed.labels)} train "
        f"samples: converged in {hist.rounds[-1]} rounds (ceil(K/kappa) = {rounds}), "
        f"acc {hist.accuracy[-1]:.4f}, {launches} fed3r_stats launches, wall {wall:.3f}s")
    if hist.rounds[-1] != rounds or hist.clients_seen[-1] != K:
        raise AssertionError(f"no convergence in {rounds} rounds: {hist.rounds}, {hist.clients_seen}")
    if launches != K:  # one shard of kappa fresh clients per round, no empty slot
        raise AssertionError(f"run_fed3r launched fed3r_stats {launches} times for {K} clients")

    feats = torch.as_tensor(fed.features, device="cuda")
    labels = torch.as_tensor(fed.labels, device="cuda")
    pooled = fed3r.client_stats(feats, labels, C)
    cen = fed3r.solve(pooled, f3.ridge_lambda)
    err_A = max_rel_err(stats.A, pooled.A)
    err_W = float((W - cen).abs().max())
    log(f"[sim] federated vs centralized: max|dA|/max|A| {err_A:.3e} (limit {STATS_REL:g})  "
        f"max|W_fed - W_cen| {err_W:.3e} (limit {SIM_W_ATOL:g})")
    if not bool(torch.isfinite(W).all()) or err_A > STATS_REL or err_W > SIM_W_ATOL:
        raise AssertionError("federated W disagrees with the centralized solve")

    W_ncm, hist_ncm = run_fedncm(fed, test.features, test.labels, fc, device="cuda")
    cen_ncm = ncm.solve(ncm.client_stats(feats, labels, C))
    err_ncm = float((W_ncm - cen_ncm).abs().max())
    log(f"[sim] run_fedncm: acc {hist_ncm.accuracy[0]:.4f} in {hist_ncm.rounds[0]} rounds, "
        f"max|W_fed - W_cen| {err_ncm:.3e} (limit {SIM_W_ATOL:g})")
    if err_ncm > SIM_W_ATOL or hist.accuracy[-1] <= 2.0 / C or hist_ncm.accuracy[0] <= 2.0 / C:
        raise AssertionError("FedNCM disagrees with its centralized form, or accuracy at chance")
    # the largest per-client capacity any round packed: the round that holds
    # the largest client, rounded up as the driver rounds it
    largest = max(len(fed.client(k).labels) for k in range(K))
    max_n = -(-largest // PACK_ROUND_TO) * PACK_ROUND_TO
    return {"launches": launches, "wall_s": wall, "max_n": max_n, "d": d, "C": C}


def _kernel_inputs(torch, n, d, C, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    Z = torch.randn((n, d), generator=gen, device="cuda")
    Y = torch.nn.functional.one_hot(
        torch.randint(0, C, (n,), generator=gen, device="cuda"), C).to(torch.float32)
    return Z, Y


def stats_flops(Z, Y) -> float:
    """The FLOPs that (A, b) = (Z^T Z, Z^T Y) needs on these inputs.

    All-zero rows of Z add nothing.  A is symmetric: d(d+1)/2 distinct
    entries, one FMA (2 FLOPs) per live sample each.  b costs one add per
    entry of Y that is 1 and column of Z, and one FMA per other nonzero.
    """
    d = Z.shape[1]
    live = Z.ne(0).any(dim=1)
    Y = Y[live]
    n_live, nnz, ones = int(live.sum()), int(Y.ne(0).sum()), int(Y.eq(1).sum())
    return float(n_live * d * (d + 1) + d * (ones + 2 * (nnz - ones)))


def phase_kernel(torch, ops, ref, slice_shape, sim_shape) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, abs_err = {}, 0.0
    for i, (n, d, C) in enumerate([slice_shape, sim_shape] + KERNEL_SHAPES_RAGGED):
        Z, Y = _kernel_inputs(torch, n, d, C, seed=10 + i)
        A, b = ops.fed3r_stats(Z, Y)
        torch.cuda.synchronize()
        Ar, br = ref.fed3r_stats_ref(Z, Y)
        eA, eb = max_rel_err(A, Ar), max_rel_err(b, br)
        abs_err = max(abs_err, float((A - Ar).abs().max()), float((b - br).abs().max()))
        log(f"[kernel] fed3r_stats n={n} d={d} C={C}: max|dA|/max|A| {eA:.3e}  "
            f"max|db|/max|b| {eb:.3e}  (limit {STATS_REL:g})  symmetric {bool(torch.equal(A, A.T))}")
        if not (eA <= STATS_REL and eb <= STATS_REL):
            raise AssertionError(f"fed3r_stats disagrees with its plain version at {(n, d, C)}")
        if i:
            continue
        ZY = torch.cat([Z, Y], dim=1)
        ms = cuda_ms(lambda: ops.fed3r_stats(Z, Y))
        plain_ms = cuda_ms(lambda: ref.fed3r_stats_ref(Z, Y))
        library_ms = cuda_ms(lambda: torch.matmul(Z.T, ZY))
        flops = stats_flops(Z, Y)
        nbytes = 4.0 * (n * d + n * C + d * d + d * C)
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernel] slice shape: kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"library_ms {library_ms:.4f} (torch.matmul of Z^T [Z|Y], fp32, no TF32)  "
            f"bound_ms {bound_ms:.4f} by {bound_by} ({flops / 1e9:.4f} GFLOP needed: "
            f"{t_ops:.4f} ms; {nbytes / 1e6:.3f} MB: {t_bytes:.4f} ms)  "
            f"{flops / ms / 1e9:.2f} TFLOP/s needed-work rate = {100 * bound_ms / ms:.1f}% of the bound")
        results = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
    return {"max_abs_err": abs_err, **results}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import fed3r_stats as kmod
    from repro_torch.kernels import ops, ref

    name = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  CUDA "
        f"{torch.version.cuda}  card {name}  capability {torch.cuda.get_device_capability(0)}")
    t_all = time.perf_counter()
    phase_build(kmod)
    sl = phase_slice(torch, ops)
    sim = phase_simulator(torch, ops)
    kern = phase_kernel(torch, ops, ref, (sl["max_n"], sl["d"], sl["C"]),
                        (sim["max_n"], sim["d"], sim["C"]))
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f}s")

    entry = {
        "name": "fed3r_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fed3r_stats.cu",
        "replaces": "src/repro/kernels/fed3r_stats.py:57",
        "launches": sl["launches"],
        **kern,
    }
    print(json.dumps({"kernels": [entry]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
