#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero.  Each
path resets every kernel's launch count just before it runs and reads the
counts just after.

1. build     -- compile the three CUDA kernels (``fed3r_stats``, ``rff``,
                ``chol_gram``) from ``src/repro_torch/kernels/csrc/`` with
                nvcc for sm_90a, one nvcc per source, all started together.
2. slice     -- ``launch/train.py`` phase 1 on ``fed3r-mnv2-proxy`` at full
                width (d_model 1280, 6 layers), 8192 samples x 128 tokens,
                100 one-class clients, 10 per shard: fed3r_stats launches
                equal the client slots folded.  Then the same phase at the
                smoke width in fp32 on the card against the CPU's plain path.
3. simulator -- ``run_fed3r`` / ``run_fedncm`` over 1280-dim features:
                convergence in ceil(K/kappa) rounds and the federated W
                against a centralized solve of the pooled statistics.
4. rf        -- FED3R-RF: ``run_fed3r`` with D = 5000 random features
                (sigma = 1000) on the simulator's set-up: rff launches equal
                the shards folded plus the test-set map, and the federated
                statistics agree with the centralized psi-statistics.
5. stream    -- ``launch/serve_stream.py`` at d = 1280, 100 classes, 100
                clients, 24 waves, both refresh policies: chol_gram launches
                equal the waves absorbed, the served W against a float64
                batch solve, the staleness trace, bitwise invariance under a
                permutation of concurrent arrivals, and ``absorb`` under
                ``torch.cuda.set_sync_debug_mode("error")``.
6. stream-rf -- the same arrivals through ``StreamingEngine(rff_params=...)``
                at D = 5000.
7. kernel    -- each kernel against its plain PyTorch version at the shapes
                the paths gave it and at ragged ones, and at each path's
                shape the times of kernel, plain version and library call.

The device-time breakdown of the slice is a separate command,
``python -m repro_torch.launch.profile_slice``.

The lines before the last are a ``{"kernels": [...]}`` JSON object and the
card's name and power limit (nvidia-smi); the last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero and prints no
result where torch sees no CUDA card or the port's sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

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
# FED3R-RF: the smaller of the paper's D in {5k, 10k}, sigma from the config
# default (paper App. C); psi is bounded by sqrt(2/D), so the kernel holds
# its plain version within 1e-5 of that bound
RF_D = 5000
RFF_REL = 1e-5
RFF_SHAPES_RAGGED = [(37, 100, 130)]
CHOL_SHAPES_RAGGED = [(130, 77, 7)]
# the streaming path: the reference driver's own dataset at full width
STREAM = dict(n_waves=24, rate=4.0, segment=6, n_clients=100, d=1280, n_classes=100,
              ridge_lambda=0.01, seed=0)
STREAM_K = 4  # the every-k policy's cadence
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


def cuda_ms(fn, iters: int = 200, warmup: int = 20, budget_ms: float = 400.0) -> float:
    """Mean device time of ``fn()`` over back-to-back calls: ``iters`` of
    them, fewer where one call is long (about ``budget_ms`` in all, at least 3)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = max(3, min(iters, int(budget_ms / once)))
    for _ in range(min(warmup, iters)):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts(ops) -> None:
    for fn in (ops.fed3r_stats, ops.rff_transform, ops.chol_gram):
        fn.launches = 0


def read_counts(ops) -> dict:
    return {"fed3r_stats": ops.fed3r_stats.launches, "rff": ops.rff_transform.launches,
            "chol_gram": ops.chol_gram.launches}


def phase_build(build, ops) -> dict:
    seconds = build.build_all(ops.LIBRARIES)
    log(f"[build] {len(ops.LIBRARIES)} kernels, one nvcc each in parallel "
        f"(nvcc {' '.join(build.NVCC_FLAGS)}) in {seconds:.2f}s")
    for lib in ops.LIBRARIES:
        log(f"[build] {lib.source.relative_to(ROOT)} -> {lib.path().relative_to(ROOT)}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {lib.name} ptxas: {line.strip()}")
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
    reset_counts(ops)
    t0 = time.perf_counter()
    out = train.run(arch, device="cuda", **SLICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    launches = counts["fed3r_stats"]
    peak = torch.cuda.max_memory_allocated()
    W = out["W"]
    log(f"[slice] wall {wall:.3f}s  peak memory {peak / 2**30:.3f} GiB  fed3r_stats launches "
        f"{launches} for {out['n_slots']} client slots of capacity max_n={out['max_n']}  "
        f"(all counts {counts})")
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
    reset_counts(ops)
    t0 = time.perf_counter()
    W, stats, hist = run_fed3r(fed, test.features, test.labels, f3, fc, eval_every=1,
                               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(ops)["fed3r_stats"]
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
    return {"launches": launches, "wall_s": wall, "max_n": max_n, "d": d, "C": C,
            "fed": fed, "test": test, "f3": f3, "fc": fc}


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


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: FLOPs at the fp32 FMA peak or the
    bytes at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "t_ops": t_ops, "t_bytes": t_bytes, "flops": flops, "nbytes": nbytes}


def timed(name, shape, kernel, plain, library, library_label, b) -> dict:
    """Kernel, plain-version and library times at one shape, with the bound."""
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    library_ms = cuda_ms(library)
    log(f"[kernel] {name} {shape}: kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"{library_label} {library_ms:.4f}  bound_ms {b['bound_ms']:.4f} by {b['bound_by']} "
        f"({b['flops'] / 1e9:.4f} GFLOP needed: {b['t_ops']:.4f} ms; {b['nbytes'] / 1e6:.3f} MB: "
        f"{b['t_bytes']:.4f} ms)  {b['flops'] / ms / 1e9:.2f} TFLOP/s needed-work rate = "
        f"{100 * b['bound_ms'] / ms:.1f}% of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def phase_kernel(torch, ops, ref, slice_shape, sim_shape, rf_shape) -> dict:
    """fed3r_stats against its plain version; times at the slice's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, abs_err = {}, 0.0
    for i, (n, d, C) in enumerate([slice_shape, sim_shape, rf_shape] + KERNEL_SHAPES_RAGGED):
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
        if i > 2:
            continue
        ZY = torch.cat([Z, Y], dim=1)
        t = timed("fed3r_stats", ("slice", "simulator", "rf")[i] + f" shape n={n} d={d} C={C}",
                  lambda: ops.fed3r_stats(Z, Y), lambda: ref.fed3r_stats_ref(Z, Y),
                  lambda: torch.matmul(Z.T, ZY),
                  "library_ms (torch.matmul of Z^T [Z|Y], fp32, no TF32)",
                  bound(stats_flops(Z, Y), 4.0 * (n * d + n * C + d * d + d * C)))
        if i == 0:
            results = t
    return {"max_abs_err": abs_err, **results}


def rff_check(torch, ops, ref, Z, omega, beta, label) -> float:
    """rff against its plain version on the card; returns max |d psi|."""
    D = omega.shape[1]
    out = ops.rff_transform(Z, omega, beta)
    torch.cuda.synchronize()
    err = float((out - ref.rff_ref(Z, omega, beta)).abs().max())
    limit = RFF_REL * math.sqrt(2.0 / D)
    log(f"[kernel] rff {label} n={Z.shape[0]} d={Z.shape[1]} D={D}: max|dpsi| {err:.3e} "
        f"(limit {RFF_REL:g}*sqrt(2/D) = {limit:.3e})  repeatable "
        f"{bool(torch.equal(out, ops.rff_transform(Z, omega, beta)))}")
    if not err <= limit:
        raise AssertionError(f"rff disagrees with its plain version at {tuple(Z.shape)}, D={D}")
    return err


def phase_kernel_rff(torch, ops, ref, rf_shard, stream_wave, omega, beta) -> dict:
    """rff at the RF path's shard, the stream's wave and a ragged shape;
    times at the shard shape (no single PyTorch call computes psi: the
    GEMM alone, torch.addmm, is printed beside it)."""
    abs_err = max(rff_check(torch, ops, ref, rf_shard, omega, beta, "rf shard"),
                  rff_check(torch, ops, ref, stream_wave, omega, beta, "stream wave"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    for n, d, D in RFF_SHAPES_RAGGED:
        # arguments over about [-3, 2*pi + 3]: the product's error matters
        Z = torch.randn((n, d), generator=gen, device="cuda")
        om = torch.randn((d, D), generator=gen, device="cuda") / math.sqrt(d)
        be = torch.rand((D,), generator=gen, device="cuda") * (2.0 * math.pi)
        abs_err = max(abs_err, rff_check(torch, ops, ref, Z, om, be, "ragged"))
    out = {}
    for label, Z in (("rf shard", rf_shard), ("stream wave", stream_wave)):
        n, d = Z.shape
        D = omega.shape[1]
        t = timed("rff", f"{label} shape n={n} d={d} D={D}",
                  lambda: ops.rff_transform(Z, omega, beta), lambda: ref.rff_ref(Z, omega, beta),
                  lambda: torch.addmm(beta, Z, omega),
                  "GEMM only (torch.addmm(beta, Z, Omega), no cos: not the same function)",
                  bound(2.0 * n * d * D, 4.0 * (n * d + d * D + D + n * D)))
        if not out:
            out = {**t, "library_ms": None, "gemm_only_ms": t["library_ms"]}
    return {"max_abs_err": abs_err, **out}


def gram_flops(L, Z, Y) -> float:
    """The FLOPs that (L L^T + Z^T Z, Z^T Y) needs on these inputs: L is
    lower-triangular and G symmetric, so G[i][j] (j <= i) is j + 1 FMAs,
    d(d+1)(d+2)/3 FLOPs in all (~d^3/3); then the samples as stats_flops."""
    d = L.shape[0]
    return float(d * (d + 1) * (d + 2) / 3) + (stats_flops(Z, Y) if Z.shape[0] else 0.0)


def chol_check(torch, ops, ref, L, Z, Y, label) -> float:
    G, B = ops.chol_gram(L, Z, Y)
    torch.cuda.synchronize()
    Gr, Br = ref.chol_gram_ref(L, Z, Y)
    eG = max_rel_err(G, Gr)
    exact_zero = Z.shape[0] == 0
    eB = float(B.abs().max()) if exact_zero else max_rel_err(B, Br)
    G2, B2 = ops.chol_gram(L, Z, Y)
    log(f"[kernel] chol_gram {label} d={L.shape[0]} n={Z.shape[0]} C={Y.shape[1]}: "
        f"max|dG|/max|G| {eG:.3e}  {'max|B|' if exact_zero else 'max|dB|/max|B|'} {eB:.3e} "
        f"(limit {STATS_REL:g}{', B exactly 0' if exact_zero else ''})  symmetric "
        f"{bool(torch.equal(G, G.T))}  repeatable {bool(torch.equal(G, G2) and torch.equal(B, B2))}")
    if not (eG <= STATS_REL and (eB == 0.0 if exact_zero else eB <= STATS_REL)):
        raise AssertionError(f"chol_gram disagrees with its plain version at {label}")
    return max(float((G - Gr).abs().max()), float((B - Br).abs().max()))


def phase_kernel_chol(torch, ops, ref, stream_case, rf_case) -> dict:
    """chol_gram at the stream's wave shape (d = 1280), at D = 5000, at n = 0
    and a ragged shape; times at both path shapes.  The library call is one
    torch.matmul of the pre-stacked [L^T; Z]^T and [[L^T | 0]; [Z | Y]]."""
    L, Z, Y = stream_case
    abs_err = max(chol_check(torch, ops, ref, L, Z, Y, "stream wave"),
                  chol_check(torch, ops, ref, *rf_case, "stream-rf wave"),
                  chol_check(torch, ops, ref, L, Z[:0], Y[:0], "empty wave"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    for d, n, C in CHOL_SHAPES_RAGGED:
        A = torch.randn((d, d), generator=gen, device="cuda")
        Lr = torch.linalg.cholesky(A @ A.T / d + torch.eye(d, device="cuda")).contiguous()
        Zr, Yr = _kernel_inputs(torch, n, d, C, seed=41)
        abs_err = max(abs_err, chol_check(torch, ops, ref, Lr, Zr, Yr, "ragged"))
    out = {}
    for label, (L, Z, Y) in (("stream wave", stream_case), ("stream-rf wave", rf_case)):
        d, (n, C) = L.shape[0], Y.shape
        left = torch.cat([L.T, Z], dim=0).T.contiguous()  # (d, d + n)
        right = torch.cat([torch.cat([L.T, torch.zeros((d, C), device="cuda")], dim=1),
                           torch.cat([Z, Y], dim=1)], dim=0)  # (d + n, d + C)
        t = timed("chol_gram", f"{label} shape d={d} n={n} C={C}",
                  lambda: ops.chol_gram(L, Z, Y), lambda: ref.chol_gram_ref(L, Z, Y),
                  lambda: torch.matmul(left, right),
                  "library_ms (one torch.matmul [L^T; Z]^T [[L^T|0]; [Z|Y]], fp32, no TF32)",
                  bound(gram_flops(L, Z, Y), 4.0 * (d * d + n * d + n * C + d * d + d * C)))
        out = out or t
    return {"max_abs_err": abs_err, **out}


def phase_rf(torch, ops, ref, sim) -> dict:
    """FED3R-RF at D = 5000 through run_fed3r, on the simulator's set-up."""
    from repro_torch.core import fed3r
    from repro_torch.core.random_features import rff_init
    from repro_torch.federated.fed3r_driver import run_fed3r

    fed, test, fc = sim["fed"], sim["test"], sim["fc"]
    f3 = dataclasses.replace(sim["f3"], n_random_features=RF_D)
    K, kappa, C = fc.n_clients, fc.clients_per_round, fed.n_classes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    W, stats, hist = run_fed3r(fed, test.features, test.labels, f3, fc, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    rounds = -(-K // kappa)
    shards = rounds  # kappa fresh clients a round, kappa clients a shard
    log(f"[rf] run_fed3r FED3R-RF: D={RF_D} sigma={f3.rff_sigma:g}, {K} clients, {kappa}/round, "
        f"d={sim['d']}: converged in {hist.rounds[-1]} rounds, acc {hist.accuracy[-1]:.4f}, "
        f"wall {wall:.3f}s, peak memory {peak / 2**30:.3f} GiB, launches {counts} "
        f"(expected rff {shards} shards + 1 test-set map, fed3r_stats {K} client slots)")
    if counts["rff"] != shards + 1 or counts["fed3r_stats"] != K or counts["chol_gram"]:
        raise AssertionError(f"FED3R-RF launched {counts}")
    if hist.rounds[-1] != rounds or hist.accuracy[-1] <= 2.0 / C:
        raise AssertionError(f"FED3R-RF: rounds {hist.rounds}, accuracy {hist.accuracy}")
    if tuple(W.shape) != (RF_D, C) or not bool(torch.isfinite(W).all()):
        raise AssertionError("FED3R-RF W is not a finite (D, C) matrix")

    # the run's own draw (fed_cfg.seed + 101), and the centralized psi-statistics
    gen = torch.Generator(device="cuda")
    gen.manual_seed(fc.seed + 101)
    params = rff_init(gen, sim["d"], RF_D, f3.rff_sigma)
    feats = torch.as_tensor(fed.features, device="cuda")
    labels = torch.as_tensor(fed.labels, device="cuda")
    psi = ref.rff_ref(feats, params.omega, params.beta)
    pooled = fed3r.client_stats(psi, labels, C)
    cen = fed3r.solve(pooled, f3.ridge_lambda)
    err_A, err_b = max_rel_err(stats.A, pooled.A), max_rel_err(stats.b, pooled.b)
    err_W = float((W - cen).abs().max())
    eig = torch.linalg.eigvalsh(pooled.A.double() + f3.ridge_lambda * torch.eye(
        RF_D, dtype=torch.float64, device="cuda"))
    cond = float(eig[-1] / eig[0])
    log(f"[rf] federated vs centralized psi-statistics: max|dA|/max|A| {err_A:.3e}  "
        f"max|db|/max|b| {err_b:.3e} (limit {STATS_REL:g})  n {float(stats.n):.0f}  "
        f"max|W_fed - W_cen| {err_W:.3e}  cond(A + lambda I) {cond:.3e}")
    if err_A > STATS_REL or err_b > STATS_REL or float(stats.n) != len(fed.labels):
        raise AssertionError("FED3R-RF statistics disagree with the centralized ones")
    # the shapes rff was given on this path: a shard of kappa clients of
    # capacity max_n (the first kappa*max_n train rows stand in for one)
    shard = feats[: kappa * sim["max_n"]].contiguous()
    return {"launches": counts["rff"], "wall_s": wall, "peak_bytes": peak, "params": params,
            "shard": shard}


def _float64_solve(torch, packed, C, lam, psi=None):
    """The float64 batch solve of a timeline's statistics (the yardstick)."""
    Z = torch.as_tensor(packed.inputs, device="cuda").reshape(-1, packed.inputs.shape[-1])
    if psi is not None:
        Z = psi(Z)
    m = torch.as_tensor(packed.mask, device="cuda").reshape(-1, 1).double()
    Z = Z.double() * m
    Y = torch.nn.functional.one_hot(
        torch.as_tensor(packed.labels, device="cuda").reshape(-1).long(), C).double() * m
    A = Z.T @ Z + lam * torch.eye(Z.shape[1], dtype=torch.float64, device="cuda")
    W = torch.linalg.solve(A, Z.T @ Y)
    return W / W.norm(dim=0, keepdim=True).clamp_min(1e-12)


def phase_stream(torch, ops) -> dict:
    """serve_stream at full width under both refresh policies."""
    from repro_torch.federated.arrivals import pack_schedule
    from repro_torch.federated.streaming_engine import (
        StreamConfig, StreamingEngine, batch_equivalent)
    from repro_torch.launch.serve_stream import serve_stream, stream_setup

    out = {}
    for policy, k in (("arrival", 1), ("every-k", STREAM_K)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = serve_stream(policy=policy, k=k, verbose=False, device="cuda", **STREAM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        packed, trace, W = res["packed"], res["trace"], res["W"]
        T, P, N = packed.mask.shape
        log(f"[stream] serve_stream policy={policy} k={k}: {T} waves x {P} clients x max_n={N}, "
            f"{packed.n_clients} clients, {packed.n_samples} samples; acc per segment "
            f"{[round(a, 4) for a in res['acc_served']]}, final {res['acc_final']:.4f}; wall "
            f"{wall:.3f}s, peak memory {peak / 2**30:.3f} GiB; launches {counts}")
        if counts["chol_gram"] != T or counts["rff"] or counts["fed3r_stats"]:
            raise AssertionError(f"serve_stream launched {counts} for {T} waves")
        t = torch.arange(1, T + 1)
        want_refresh = (t % k == 0)
        want_stale = torch.where(want_refresh, 0, t % k).to(torch.int32)
        if not (torch.equal(trace.refreshed, want_refresh)
                and torch.equal(trace.stale_waves, want_stale)):
            raise AssertionError(f"staleness trace off policy: {trace.refreshed.tolist()}, "
                                 f"{trace.stale_waves.tolist()}")
        cfg = StreamConfig(n_classes=STREAM["n_classes"], ridge_lambda=STREAM["ridge_lambda"])
        W64 = _float64_solve(torch, packed, cfg.n_classes, cfg.ridge_lambda)
        Wb, _ = batch_equivalent(packed, cfg, device="cuda")
        e_stream = float((W.double() - W64).abs().max())
        e_batch = float((Wb.double() - W64).abs().max())
        log(f"[stream] {policy}: max|W_stream - W_f64| {e_stream:.3e}  max|W_batch32 - W_f64| "
            f"{e_batch:.3e}  (limit 2 x batch + 1e-5 = {2 * e_batch + 1e-5:.3e})")
        if not e_stream <= 2 * e_batch + 1e-5:
            raise AssertionError("the streaming W is further from float64 than the fp32 batch W")

        # the same arrivals, each wave's clients presented in another order,
        # absorbed with the timeline already on the card and every host sync
        # an error
        fed, _, schedule = stream_setup(STREAM["n_waves"], STREAM["rate"], 0.0,
                                        STREAM["n_clients"], STREAM["d"], STREAM["n_classes"],
                                        STREAM["seed"], torch.device("cuda"))
        rng = np.random.default_rng(7)
        permuted = [[wave[i] for i in rng.permutation(len(wave))] for wave in schedule]
        timeline = pack_schedule(fed, permuted).to("cuda")
        eng = StreamingEngine(StreamConfig(n_classes=cfg.n_classes, ridge_lambda=cfg.ridge_lambda,
                                           refresh_every=k), device="cuda")
        state = eng.init(STREAM["d"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = eng.absorb(state, timeline)
            state = eng.refresh(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same = bool(torch.equal(state.W, W))
        log(f"[stream] {policy}: absorb of all {T} waves under sync-debug mode 'error': no host "
            f"sync; W bitwise equal under a permutation of concurrent arrivals: {same}")
        if not same:
            raise AssertionError("the served W changed under a permutation of concurrent arrivals")
        if policy == "arrival":
            wave_breakdown(torch, ops, "stream", state.L, *wave_inputs(torch, packed, widest_wave(
                packed)), cfg.n_classes)
        out[policy] = {"launches": counts["chol_gram"], "wall_s": wall, "peak_bytes": peak,
                       "packed": packed, "L": state.L}
    return out


def phase_stream_rf(torch, ops, ref, packed, params) -> dict:
    """The stream's arrivals through StreamingEngine(rff_params) at D = 5000."""
    from repro_torch.core import fed3r
    from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine

    cfg = StreamConfig(n_classes=STREAM["n_classes"], ridge_lambda=STREAM["ridge_lambda"])
    eng = StreamingEngine(cfg, rff_params=params, device="cuda")
    timeline = packed.to("cuda")
    T = packed.n_waves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    state, _ = eng.absorb(eng.init(RF_D), timeline)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    log(f"[stream-rf] StreamingEngine(rff_params) D={RF_D}: {T} waves, wall {wall:.3f}s "
        f"({1e3 * wall / T:.1f} ms a wave), peak memory {peak / 2**30:.3f} GiB, launches {counts}")
    if counts["rff"] != T or counts["chol_gram"] != T or counts["fed3r_stats"]:
        raise AssertionError(f"stream-rf launched {counts} for {T} waves")

    def psi(Z):
        return ref.rff_ref(Z.contiguous(), params.omega, params.beta)

    Z = psi(torch.as_tensor(packed.inputs, device="cuda").reshape(-1, STREAM["d"]))
    m = torch.as_tensor(packed.mask, device="cuda").reshape(-1)
    y = torch.as_tensor(packed.labels, device="cuda").reshape(-1)
    batch = fed3r.client_stats(Z, y, cfg.n_classes, m)
    W64 = _float64_solve(torch, packed, cfg.n_classes, cfg.ridge_lambda, psi=psi)
    Wb = fed3r.solve(batch, cfg.ridge_lambda)
    e_b = max_rel_err(state.b, batch.b)
    e_stream = float((state.W.double() - W64).abs().max())
    e_batch = float((Wb.double() - W64).abs().max())
    log(f"[stream-rf] max|db|/max|b| {e_b:.3e} (limit {STATS_REL:g})  n {float(state.n):.0f}  "
        f"max|W_stream - W_f64| {e_stream:.3e}  max|W_batch32 - W_f64| {e_batch:.3e}")
    if e_b > STATS_REL or float(state.n) != packed.n_samples or not bool(
            torch.isfinite(state.W).all()):
        raise AssertionError("stream-rf statistics disagree with the batch psi-statistics")
    wave_breakdown(torch, ops, "stream-rf", state.L, *wave_inputs(torch, packed, widest_wave(
        packed)), cfg.n_classes, params=params)
    # the shapes this path gave chol_gram: the final factor and the widest
    # wave's design
    z, y = wave_design(torch, packed, widest_wave(packed), cfg.n_classes, psi=psi)
    return {"launches": counts["chol_gram"], "wall_s": wall, "peak_bytes": peak,
            "case": (state.L, z, y)}


def wave_breakdown(torch, ops, label, L, x, y, m, n_classes, params=None) -> dict:
    """Device time of each step of one wave, each step timed alone on this
    wave's inputs: the rff map, the masked design, chol_gram, the guarded
    factorization (four Cholesky factorizations) against one plain
    ``cholesky_ex``, and the refresh's two triangular solves."""
    from repro_torch.core import fed3r

    steps = {}
    if params is not None:
        steps["rff"] = cuda_ms(lambda: ops.rff_transform(x, params.omega, params.beta))
        x = ops.rff_transform(x, params.omega, params.beta)
    steps["masked_design"] = cuda_ms(lambda: fed3r.masked_design(x, y, n_classes, m))
    z, yh, _ = fed3r.masked_design(x, y, n_classes, m)
    steps["chol_gram"] = cuda_ms(lambda: ops.chol_gram(L, z, yh))
    G, dB = ops.chol_gram(L, z, yh)
    steps["psd_cholesky"] = cuda_ms(lambda: fed3r.psd_cholesky(G))
    steps["one cholesky_ex"] = cuda_ms(lambda: torch.linalg.cholesky_ex(G, check_errors=False))
    fac = fed3r.Fed3RFactored(L=fed3r.psd_cholesky(G), b=dB)
    steps["solve"] = cuda_ms(lambda: fed3r.factored_solution(fac))
    total = sum(v for k, v in steps.items() if k != "one cholesky_ex")
    log(f"[{label}] one wave ({x.shape[0]} rows), each step timed alone: "
        + "  ".join(f"{k} {v:.4f} ms" for k, v in steps.items()) + f"  (sum {total:.4f} ms)")
    return steps


def wave_inputs(torch, packed, t):
    """Wave t's raw rows, labels and mask on the card, as the engine takes them."""
    x = torch.as_tensor(packed.inputs[t], device="cuda")
    return (x.reshape(-1, x.shape[-1]),
            torch.as_tensor(packed.labels[t], device="cuda").reshape(-1),
            torch.as_tensor(packed.mask[t], device="cuda").reshape(-1))


def widest_wave(packed) -> int:
    return int(np.argmax(packed.mask.sum(axis=(1, 2))))


def wave_design(torch, packed, t, n_classes, psi=None):
    """Wave t's masked design, as the streaming engine hands it to chol_gram."""
    from repro_torch.core import fed3r

    x, y, m = wave_inputs(torch, packed, t)
    z, yh, _ = fed3r.masked_design(x if psi is None else psi(x), y, n_classes, m)
    return z.contiguous(), yh.contiguous()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  CUDA "
        f"{torch.version.cuda}  card {name}  capability {torch.cuda.get_device_capability(0)}")
    t_all = time.perf_counter()
    phase_build(build, ops)
    sl = phase_slice(torch, ops)
    sim = phase_simulator(torch, ops)
    rf = phase_rf(torch, ops, ref, sim)
    stream = phase_stream(torch, ops)
    packed = stream["arrival"]["packed"]
    srf = phase_stream_rf(torch, ops, ref, packed, rf["params"])
    t_phases = time.perf_counter() - t_all

    kern = phase_kernel(torch, ops, ref, (sl["max_n"], sl["d"], sl["C"]),
                        (sim["max_n"], sim["d"], sim["C"]), (sim["max_n"], RF_D, sim["C"]))
    z, y = wave_design(torch, packed, widest_wave(packed), STREAM["n_classes"])
    kern_rff = phase_kernel_rff(torch, ops, ref, rf["shard"], z, rf["params"].omega,
                                rf["params"].beta)
    kern_chol = phase_kernel_chol(torch, ops, ref, (stream["arrival"]["L"], z, y), srf["case"])
    log(f"[done] paths in {t_phases:.1f}s, all phases in {time.perf_counter() - t_all:.1f}s")

    entries = [
        {"name": "fed3r_stats", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed3r_stats.cu",
         "replaces": "src/repro/kernels/fed3r_stats.py:57", "launches": sl["launches"], **kern},
        {"name": "rff", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rff.cu",
         "replaces": "src/repro/kernels/rff.py:42", "launches": rf["launches"],
         **{k: v for k, v in kern_rff.items() if k != "gemm_only_ms"}},
        {"name": "chol_gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/chol_gram.cu",
         "replaces": "src/repro/kernels/chol_update.py:86",
         "launches": stream["arrival"]["launches"], **kern_chol},
    ]
    print(json.dumps({"kernels": entries}))
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
