"""Fed3R's statistics pass (phase 1, Algorithm 1), timed round by round.

Set-up: the federation of the traffic file (:mod:`perfbench.federation`),
the family's inputs and weights made on the card from ``--seed``, the
port's ``AccumulationEngine``; one warm-up round of the largest shard the
first rounds pack, and one solve.

Window: rounds back to back in the federation's order.  A round packs its
clients' slots (``data/pipeline.py::pack_client_shards``), folds them
(``federated/engine.py::AccumulationEngine.accumulate``) and synchronises;
its time runs from the start of the packing to the synchronisation.  A pass
folds every client once into a fresh accumulator and ends in
``core/fed3r.py::solve``.  The window starts rounds until ``--seconds`` have
passed and ends when the round in flight ends; a pass left partial ends in
a solve too.  Rates divide by the whole window.

Check, once the window has closed and the peak memory has been read, by the
plain reference of the family (``perfbench/reference/<family>.py``):

* ``A_gap``, ``b_gap``: one complete pass drawn from the seed (the window's
  partial pass where none completed), its statistics recomputed from the raw
  inputs, the widest entry gap over the reference's widest entry;
* ``solve_resid``: the last solve of the window, its normwise backward error
  against the statistics it was solved from (the program's own: the
  reference follows the solve from the program's state);
* ``n_gap``, ``counts_gap``: every pass's sample count and class counts,
  exactly.

With ``ctx.control`` each of the reference's controls (``CONTROLS`` of
``perfbench/reference/<family>.py``: the reference in the configuration's
next lower precision, whole or in one stage) stands in the program's place
on the same pass, and their readings come back under ``control``
(``perfbench/calibrate.py``; the benchmark's runs never compute them).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from perfbench import federation, harness
from perfbench.reference import ridge
from perfbench.trace import Tracer, digest

LABELS = ("pack", "accumulate", "sync", "solve")
WARM_ROUNDS = 8  # the warm-up shard is the largest of these rounds'


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pack(fed, inputs: np.ndarray, r: int):
    from repro_torch.data.pipeline import pack_client_shards

    slots = fed.rounds[r]
    clients = [(inputs[s:e], fed.labels[s:e]) for s, e in slots]
    return pack_client_shards(clients, fed.clients_per_shard,
                              client_ids=np.arange(len(slots)), round_to=8)


def _warm(engine, params, fed, inputs, d, lam, dev) -> None:
    """The largest shard of the first rounds through the engine, and a solve."""
    from repro_torch.core import fed3r
    from repro_torch.data.pipeline import pack_client_shards

    r = max(range(min(WARM_ROUNDS, len(fed.rounds))),
            key=lambda i: int((fed.rounds[i][:, 1] - fed.rounds[i][:, 0]).max()))
    slots = fed.rounds[r][:fed.clients_per_shard]
    packed = pack_client_shards([(inputs[s:e], fed.labels[s:e]) for s, e in slots],
                                fed.clients_per_shard, client_ids=np.arange(len(slots)),
                                max_n=int((fed.rounds[r][:, 1] - fed.rounds[r][:, 0]).max()))
    acc = engine.accumulate(engine.init(d), packed, params)
    fed3r.solve(acc.stats, lam)
    _sync(dev)


def _rows(fed, rounds) -> np.ndarray:
    return np.concatenate([np.arange(s, e) for r in rounds for s, e in fed.rounds[r]])


def run(ctx) -> dict:
    from repro_torch.core import fed3r

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    fam, ref = harness.family(cfg["family"]), harness.reference(cfg["family"])
    lam = cfg["ridge_lambda"]
    fed = federation.build(traffic, ctx.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    inputs = fam.make_inputs(cfg, traffic, fed, gen)
    params = fam.make_params(cfg, gen)
    engine, d = fam.engine(cfg, params, fed.n_classes, dev)
    tracer = Tracer(ctx.trace, dev)
    _warm(engine, params, fed, inputs, d, lam, dev)
    pick = np.random.default_rng([ctx.seed, 1])  # the pass the check draws

    rounds, passes = [], []  # passes: the rounds, n and class counts of each
    unit: Optional[dict] = None  # the pass the check judges: its rounds, its accumulator
    last: Optional[dict] = None  # the accumulator and W of the last solve
    acc, in_pass, r, n_complete = engine.init(d), 0, 0, 0
    with tracer.window():  # the profiler starts before the window does
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        while True:
            t_round = time.perf_counter()
            with tracer.label("pack"):
                packed = _pack(fed, inputs, r)
            t_packed = time.perf_counter()
            with tracer.label("accumulate"):
                new = engine.accumulate(acc, packed, params)
            with tracer.label("sync"):
                _sync(dev)
            t_done = time.perf_counter()
            slot_live = packed.mask.sum(-1)
            rounds.append({"round": r, "pack_s": t_packed - t_round, "round_s": t_done - t_round,
                           "rows": int(packed.mask.size), "live": int(slot_live.sum()),
                           "slot_live": [int(n) for n in slot_live.ravel()],
                           "shard_live": [int(n) for n in slot_live.sum(-1)]})
            acc, in_pass, r = new, in_pass + 1, (r + 1) % len(fed.rounds)
            over = time.perf_counter() - t0 >= ctx.seconds
            if in_pass == len(fed.rounds) or over:
                with tracer.label("solve"), tracer.span("solve"):
                    W = fed3r.solve(acc.stats, lam)
                    _sync(dev)
                first = (r - in_pass) % len(fed.rounds)
                done = [(first + i) % len(fed.rounds) for i in range(in_pass)]
                passes.append({"rounds": done, "n": acc.stats.n, "counts": acc.class_counts})
                last = {"acc": acc, "W": W}
                if in_pass == len(fed.rounds):
                    n_complete += 1
                    if pick.random() * n_complete < 1:
                        unit = {"rounds": done, "acc": acc}
                acc, in_pass = engine.init(d), 0
            if over:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if unit is None:  # no pass completed: the partial one
        unit = {"rounds": passes[-1]["rounds"], "acc": last["acc"]}

    samples = sum(x["live"] for x in rounds)
    out = {
        "attempted": len(rounds), "failed": 0, "peak_bytes": peak,
        "e2e": {"stats_samples_per_s": samples / window_s,
                "round_p95_ms": float(np.percentile([x["round_s"] for x in rounds], 95)) * 1e3,
                "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
    }
    rec = {"config": cfg, "traffic": traffic, "rounds": rounds, "window_s": window_s,
           "samples": samples, "dims": {"d": d, "C": fed.n_classes},
           "sample_flops": fam.sample_flops(cfg, traffic),
           "launches": fam.launches(cfg, rounds), "spans_ms": tracer.span_ms()}
    if tracer.prof is not None:
        trace = digest(tracer.prof, LABELS)
        rec.update(busy_s=trace["busy_s"], trace_window_s=trace["window_s"],
                   kernels=trace["kernels"])
        out["trace"] = {k: trace[k] for k in ("busy_s", "window_s", "device_ops", "idle_gaps")}
    out["record"] = rec

    # the program's state goes before the reference runs: only what is judged stays
    judged = {"unit": unit, "last": last, "passes": passes}
    del engine, acc, new, packed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["compared"], out["control"] = _judge(ctx, ref, fed, inputs, params, d, lam, judged)
    return out


def _reference_stats(ctx, ref, fed, inputs, params, d, rounds, control=None):
    """The statistics of ``rounds`` from the raw inputs.  The reference's:
    float64 sums, block by block.  A control's (``ref.CONTROLS[control]``):
    its map precision, and, where it holds the statistics in TF32, TF32
    operands summed in fp32 a slot and merged in fp32, in the program's order."""
    dev, C = ctx.device, fed.n_classes
    precision, tf32_stats = (ref.PRECISION, False) if control is None else ref.CONTROLS[control]
    if tf32_stats:
        stats = ridge.new_stats(d, C, dev, torch.float32)
        blocks = [np.arange(s, e) for r in rounds for s, e in fed.rounds[r]]
    else:
        stats = ridge.new_stats(d, C, dev)
        rows = _rows(fed, rounds)
        blocks = [rows[lo:lo + ref.BLOCK] for lo in range(0, len(rows), ref.BLOCK)]
    for idx in blocks:
        x = torch.as_tensor(inputs[idx], device=dev)
        y = torch.as_tensor(fed.labels[idx], device=dev)
        ridge.fold(stats, ref.features(ctx.config, params, x, precision), y, tf32=tf32_stats)
    return stats


def _judge(ctx, ref, fed, inputs, params, d, lam, judged):
    """The numbers compared, each with its limit, and the controls' readings."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        unit, last = judged["unit"], judged["last"]
        expect = _reference_stats(ctx, ref, fed, inputs, params, d, unit["rounds"])
        stats = unit["acc"].stats
        nums = {"A_gap": ridge.rel_gap(stats.A, expect["A"]),
                "b_gap": ridge.rel_gap(stats.b, expect["b"]),
                "solve_resid": ridge.solve_residual(last["acc"].stats.A, last["acc"].stats.b,
                                                    last["W"], lam)}
        n_gap = counts_gap = 0.0
        for p in judged["passes"]:
            labels = fed.labels[_rows(fed, p["rounds"])]
            counts = np.bincount(labels, minlength=fed.n_classes)
            n_gap = max(n_gap, abs(float(p["n"]) - len(labels)))
            counts_gap = max(counts_gap, float(np.abs(p["counts"].double().cpu().numpy()
                                                      - counts).max()))
        nums.update(n_gap=n_gap, counts_gap=counts_gap)
        control = None
        if ctx.control:
            control = {}
            for name in ref.CONTROLS:
                low = _reference_stats(ctx, ref, fed, inputs, params, d, unit["rounds"], name)
                W = ridge.round_bf16(ridge.solve(low["A"], low["b"], lam))  # the head in bf16
                control[name] = {"A_gap": ridge.rel_gap(low["A"], expect["A"]),
                                 "b_gap": ridge.rel_gap(low["b"], expect["b"]),
                                 "solve_resid": ridge.solve_residual(low["A"], low["b"], W, lam)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    limits = ctx.cell["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    return compared, control
