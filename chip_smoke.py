#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero.  Each
path resets every kernel's launch count just before it runs and reads the
counts just after.

1. build     -- compile the six CUDA sources (``fed3r_stats``, ``rff``,
                ``chol_gram``, ``batched_chol_gram``, ``quant``,
                ``flash_attention``: seven kernels) from
                ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a, one
                nvcc per source, all started together.
2. slice     -- ``launch/train.py`` phase 1 on ``fed3r-mnv2-proxy`` at full
                width (d_model 1280, 6 layers), 8192 samples x 128 tokens,
                100 one-class clients, 10 per shard: fed3r_stats launches
                equal the client slots folded.  Then the same phase at the
                smoke width in fp32 on the card against the CPU's plain path.
3. simulator -- ``run_fed3r`` / ``run_fedncm`` over 1280-dim features:
                convergence in ceil(K/kappa) rounds and the federated W
                against a centralized solve of the pooled statistics.
   ft        -- FED3R+FT: ``train.run`` on ``fed3r-mnv2-proxy`` with 3
                fine-tuning rounds (FT-FEAT, FedAvg, 10 clients x 64
                sequences a local step): fed3r_stats launches equal phase
                1's client slots, the head stays bitwise the calibrated
                W_head, the backbone moves, all finite; ms a round, tok/s,
                peak memory.  Then one full-width round under
                ``set_sync_debug_mode("error")``, repeated, against
                ``ReferenceLoop`` within a bf16 bound (a dropped client
                outside it), no fed3r_stats launch; the smoke width in
                fp32 card vs CPU; and ``run_fed3r_ft`` on the simulator's
                set-up for all six algorithms: W bitwise its init under
                FT-FEAT, a round bitwise under a reversed cohort, stage 2
                stopped after 2 rounds and resumed bitwise.
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
7. stream-slots -- ``serve_stream(engine="slots")`` at the stream's shape:
                the slot engine's absorb and serve stages, its served W
                bitwise the arrival policy's.
8. heads     -- ``launch/serve_heads.py`` at d = 1280, 100 classes, 100
                tenants, 24 waves, Zipf query bursts: ``engine="lru"`` under
                both invalidation policies and ``engine="slots"``;
                batched_chol_gram launches equal the solves with misses, the
                two engines serve the same answers under "strict"; then, on
                the widest cohort of the run, alpha = 0 and padded rows
                bitwise the global head, every head against a float64 closed
                form, permutation-bitwise heads, and the solve's steps timed.
9. wire      -- the simulator's federation through ``AccumulationEngine``
                under the fp32, int8 (tile 128), fp8 and sketch (rank 16)
                wires: fp32 bitwise the uncompressed accumulator, int8
                within half a quantization step per client of it
                (quantize_tiles and dequant_acc launched twice a client),
                fp8 and sketch finite; wire bytes, accuracy, wall, memory.
10. stream-int8 -- the stream's arrivals through ``StreamingEngine`` under
                the int8 wire: finite, W within the reference's 0.5 of the
                fp32 stream's, the waves on which the guard retried.
11. uplink   -- ``UplinkCompressor`` with and without error feedback, 12
                uploads of one full-width client: the telescoping bound and
                the priced compression ratio.
12. secure   -- a 10-client cohort quantized against shared scales and
                masked mod 2^32 on the card: the masked sum and the
                survivors' sum after 2 drop out, bitwise; an int32 wrap probe.
13. async    -- ``serve_stream(engine="async")`` at the stream's set-up: 24
                chaos rounds of ~4 clients (fed3r_stats launches = the 100
                client payloads), live accuracy a segment, the chaos
                counters, the drained W against a float64 closed form over
                the uploads that folded; ``run_chaos_timeline`` at d = 1280
                under the five fault types of ``tests/test_async.py``, async W
                and L bitwise the synchronous barrier's, with every host sync
                an error in the async runs; the same under the int8 wire
                (quantize_tiles and dequant_acc 2 an upload folded); the fp8
                and int8 client folds and streams under sync-debug "error";
                secure mode with 2 of 10 clients dropped, bitwise the
                survivor-only unmasked round.
14. tiers    -- ``StreamingEngine.tiered_absorber`` over an edge 4 / region 2
                / cloud 2 tree (16 leaves at d = 1280, 4 segments of
                grid-exact features), fp32 and with an int8 cloud tier:
                blocking and overlapped bitwise, the fp32 tree bitwise the
                flat ``absorb_stats`` of ``shard_stats``; fed3r_stats 16, chol_gram
                1 and (int8) quantize_tiles and dequant_acc 4 a segment; no
                host sync in an overlapped ``absorb_segment``,
                ``tier_overlap_efficiency`` 1.0.
15. dist     -- the psum backend (``DistConfig(aggregation="psum", mesh=
                make_host_mesh())``), first at world 1 under NCCL in this
                process: ``launch/train.py`` phase 1 (A, b bitwise [slice]'s)
                and [ft]'s full-width round (bitwise) under psum, the stream
                at d 1280 (fp32 and int8 wires), ``AccumulationEngine`` on the
                simulator's clients, a 32-tenant head solve and the async ring
                under a ``mesh_tree`` (each bitwise its merge engine, the same
                launches), accumulate / absorb / ``RoundEngine.step`` /
                ``deliver`` / ``close_round`` under sync-debug "error"; then
                the same paths on 4 gloo ranks sharing the card
                (``launch/world.py::run_world``): equal bits on every rank,
                phase 1's fed3r_stats launches summing to the client slots,
                A and b within 1e-5 of [slice]'s, equal accuracy, the FT round
                (12 slots, 3 a rank) within 2e-3 of [ft]'s max|dtheta|, the
                stream's W in its float64 gate (quant pair 2 a wave a rank
                under int8), the async ring under a 2-tier mesh tree bitwise
                merge; walls of each path at world 1 and 4, peak memory a rank.
16. serve    -- ``launch/serve.py`` on ``qwen2-7b`` at full width (28
                layers, d_model 3584, GQA 28/4, vocab 152,064), bf16, random
                weights: batch 8, 2048-token prompts, 64 tokens; flash_attention
                launches 28 in the prefill and 0 in the decode steps.  Then a
                ragged 1000-token prompt at batch 1.
17. serve-consistency -- at full width, bf16: prefill (the kernel) + 64
                decode steps against one train-mode forward over the 2048
                tokens (the plain attention), the logits' gap and the share
                of equal argmaxes within the bounds measured once, and
                three faults planted in the prefill's attention (window 1,
                KV heads rolled in every layer or in one) outside them; decode
                with the fp32 weights cast at every product against a bf16
                copy of the matrices cast once (the same bits); the same
                contract for ``sliding_window=1024`` (the window through the
                kernel, the ring cache wrapping) and for the int8 KV cache,
                each against its own train forward within its bound, with a
                planted fault outside it (window 1; int8 scales rolled
                across KV heads); then ``qwen2-7b-smoke`` in fp32, card
                against CPU: the same greedy tokens, logits within 2e-4 of
                the largest.
18. serve-moe -- ``launch/serve.py`` on ``deepseek-moe-16b`` at full width and
                depth (28 layers, d_model 2048, MHA 16/16, 64 routed experts
                top 6 and 2 shared, d_expert 1408, vocab 102,400), bf16,
                random fp32 weights (62.9 GiB): batch 8, 2048-token prompts,
                64 tokens, cold and warm; flash_attention launches 28 in the
                prefill and 0 in decode; the share of (token, choice)
                entries the prefill's capacity dropped.
19. serve-moe-consistency -- at full width, bf16, capacity factor E / top_k
                (no drop): prefill + 64 decode steps against one train-mode
                forward within the bounds measured once, no entry dropped,
                every token's first expert rolled by one outside them; a
                decode step under sync-debug "error"; one layer's
                ``moe_apply`` in fp32 against the dense oracle (every expert
                on every token) over 1024 tokens.
20. serve-ssm, serve-hybrid, serve-vlm -- ``launch/serve.py`` at full width
                and depth, bf16, random fp32 weights from seed 0, cold and
                warm: ``mamba2-1.3b`` (48 SSD layers, d_model 2048) at batch
                8 x 2048 + 64 tokens, no flash launch; ``recurrentgemma-9b``
                (26 RG-LRU and 12 local-attention layers, d_model 4096, MQA
                16/1 x 256, window 2048) at batch 2 x 4096 + 64, 12 flash
                launches a prefill (the prompt longer than the window);
                ``qwen2-vl-2b`` (28 layers, GQA 12/2 x 128, M-RoPE) at batch 8
                x (256 patches + 2048 tokens) + 64, 28 a prefill; none in
                decode; a decode step under sync-debug "error".
21. ssm-, hybrid-, vlm-consistency -- at full width in bf16 and fp32,
                prefill + 64 decode steps against one train forward within
                twice one sound run's gap, a planted fault outside it (the
                SSM's decode without the state decay, the hybrid's prefill
                attention without its window, the VLM's text positions from
                n_patches); layer 0 in fp32 against a float64 oracle (the
                SSM and RG-LRU recurrences a step at a time, the attention
                with its M-RoPE streams).
22. kernel    -- each kernel against its plain PyTorch version at the shapes
                the paths gave it and at ragged ones (the quantization pair
                bitwise, on all-zero tiles and exact half-way inputs too;
                flash attention in bf16 and fp32, with and without a
                window, at head widths 16 to 256; in bf16 also each row
                within 2 bf16 ulps of the plain version in fp32, a limit
                that an emulated skipped key tile must exceed, and each
                row's log-sum-exp, written by the kernel, within 1e-5 of an
                fp32 logsumexp, a limit that an emulated early rounding of
                p must exceed; fed3r_stats also exactly symmetric at every
                shape and bitwise repeatable at the rf shape; rff bitwise
                repeatable, its two instances bitwise each other at the
                paths' and edge shapes, and psi(Z[perm]) == psi(Z)[perm],
                psi(Z[:k]) == psi(Z)[:k] at the rf shard and the stream
                wave; quantize_tiles bitwise at edge shapes under every
                cluster size, x aligned or not; chol_gram's
                stream and stream-rf waves and batched_chol_gram's widest
                cohort also bitwise equal to their live rows compacted, with
                the instance that ran), and at each
                path's shape the times of kernel, plain version and library
                call, and the device time alone of kernel and library call
                (a CUDA graph of the calls replayed) beside the call time
                (flash attention at the serve, long, hd-256, serve-moe,
                serve-hybrid (window 2048) and serve-vlm shapes;
                quantize_tiles and dequant_acc also at 5000 x 5000, where
                no one PyTorch call computes them).

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
# FED3R-RF at D = repro_torch.configs.simulator.RF_D, sigma from the config
# default (paper App. C); psi is bounded by sqrt(2/D), so the kernel holds
# its plain version within 1e-5 of that bound
RFF_REL = 1e-5
RFF_SHAPES_RAGGED = [(37, 100, 130)]
# both rff instances give the same bits (one fmaf chain an element in k
# order, whichever thread runs it), each within RFF_REL of the plain
# version: one sample, d % 4 != 0, D % 4 != 0, d < 16 (the paths' shapes:
# rff_placement)
RFF_EDGES = [(1, 37, 130), (37, 130, 130), (130, 37, 4999), (5, 7, 64), (300, 12, 4999)]
# quantize_tiles against its plain version, bitwise, at every cluster size,
# with x aligned and 4 bytes past a 16-byte boundary, the first and last
# tile all zero: tile 1 (single elements), 16 (runs of 16), 64 with
# N % 16 != 0 (runs of 4), the wire's A and b at tile 128 (runs of 16 and
# of 4), tile 200 (runs of 4, ragged both ways), N % 4 != 0 with a ragged
# last tile (single elements)
QUANT_EDGES = [(7, 5, 1), (100, 96, 16), (130, 100, 64), (1280, 1280, 128), (1280, 100, 128),
               (450, 600, 200), (33, 190, 128), (129, 77, 16)]
CHOL_SHAPES_RAGGED = [(130, 77, 7)]
BATCHED_SHAPES_RAGGED = [(3, 130, 77, 7)]  # (K, d, n, C)
# the streaming path: the reference driver's own dataset at full width
STREAM = dict(n_waves=24, rate=4.0, segment=6, n_clients=100, d=1280, n_classes=100,
              ridge_lambda=0.01, seed=0)
STREAM_K = 4  # the every-k policy's cadence
# the head-serving path: the stream's arrivals and data, Zipf(1.1) query
# bursts from the tenants' own data, the reference driver's alpha grid
HEADS = dict(n_waves=24, segment=6, rate=4.0, queries_per_burst=48, bursts_per_segment=2,
             cache_capacity=32, n_clients=100, d=1280, n_classes=100, ridge_lambda=0.01,
             alpha_grid=(0.0, 0.5, 1.0, 2.0, 4.0), seed=0)
HEADS_RUNS = (("lru strict", "lru", "strict"), ("lru segmented", "lru", "segmented"),
              ("slots", "slots", "strict"))
# the two engines' served scores under "strict": the same cohorts and solves,
# contracted by batched GEMMs of different widths
SCORE_REL = 1e-5
# the compressed uplink: the reference's default tile and sketch rank
WIRES = (("fp32", {}), ("int8", {"tile": 128}), ("fp8", {"tile": 128}), ("sketch", {"rank": 16}))
UPLINK_ROUNDS = 12
SECURE_CLIENTS, SECURE_DROPPED = 10, (3, 7)
# the async engine at the stream's set-up: serve_stream's cohort (~rate),
# and the chaos replay of tests/test_async.py at d 1280 (5 rounds of 4 of
# 10 clients, staleness 3) under each of its five fault types
ASYNC_COHORT = 4
ASYNC_CHAOS_CLIENTS, ASYNC_CHAOS_ROUNDS = 10, 5
ASYNC_FAULTS = {
    "drop": dict(drop=0.5, rto=0.1, max_attempts=6, seed=3),
    "duplicate": dict(duplicate=0.6, seed=3),
    "reorder": dict(reorder=0.9, rto=0.2, seed=3),
    "delay": dict(delay=0.5, delay_factor=2.0, seed=3),
    "all": dict(drop=0.3, duplicate=0.3, reorder=0.5, delay=0.2, delay_factor=2.0, rto=0.1,
                max_attempts=6, seed=3),
}
# the host-tier tree: 16 leaves of up to 128 grid-exact rows, 4 segments
TIERS = dict(rows=128, segments=4, seed=21)
QUANT_SHAPES = [(1280, 1280, 128), (1280, 100, 128), (5000, 5000, 128), (200, 150, 64),
                (33, 190, 128), (1281, 77, 16)]
# [dist]: the psum backend at world 1 under NCCL (this process) and on
# DIST_WORLD gloo ranks sharing the card (NCCL takes one card a rank), each
# a deadline; the 32 tenants of the [heads] refit's cohort; the async ring's
# clients of 64 grid-exact rows at d 1280 (every fp32 partial sum exact)
DIST_WORLD = 4
DIST_TIMEOUT_S = 420
DIST_HEADS = 32
DIST_ASYNC_ROWS = 64
# phase 1's A and b over 4 ranks against one process: each rank folds its 30
# of the 100 client slots in order and the ring sums 4 partials, a
# reassociation of 100 fp32 terms, at most 100 x 2^-24 (6e-6) of the largest
# partial sum: STATS_REL (1e-5) of max|A| bounds it
DIST_STATS_REL = STATS_REL
# world 1's psum stream against [stream]'s merge stream: the same waves, its
# Gram formed as L Lᵀ + S after the (one-rank) sum where merge runs the fused
# chol_gram, so the two differ by fp32 rounding only
DIST_STREAM_REL = 1e-5
# the int8 psum stream against a float64 emulation of the same wire (each
# rank's (S, ΔB) quantized per 128-tile, the four summed), relative to
# max|W|: read 5.5e-4 at world 1 and 4.4e-3 at world 4 on an H100, where
# an fp32 rounding moves some entries across a rounding edge of the int8
# grid (one step each; [dist] counts them); a roundtripped SUM, or no wire,
# read 3.1e-2 to 4.5e-2 on the same run.  The limit sits between.
DIST_INT8_REL = 1e-2
# the dense serving path (launch/serve.py) at Qwen2-7B's full width, bf16
SERVE_ARCH = "qwen2-7b"
SERVE_FULL = dict(batch=8, prompt_len=2048, gen=64)
SERVE_RAGGED = dict(batch=1, prompt_len=1000, gen=16)
CONSIST = dict(B=2, S=1984, T=64)  # the decode-consistency test's contract at full width
DECODE_COST_STEPS = 16
# prefill (the kernel: fp32 scores, p rounded before the normalization) +
# decode against the train forward (the plain attention: bf16 scores, p
# rounded after it) over 28 bf16 layers of random weights.  Measured once on
# the card (PERF.md, PR 15): max|dlogit| 1.105e-2 of max|logit| 5.656 (2 bf16
# ulps of it), 130 of 130 argmaxes equal.  Bounds: twice the gap (4 ulps),
# and at most 3 of the 130 positions flipped; never to be loosened.
CONSIST_REL = 2.2e-2
CONSIST_ARGMAX = 0.97
# faults planted in the consistency prefill (a wrapper around the kernel,
# installed for one run and removed): the gap must read above CONSIST_REL
# for each, or the bound could not see a wrong prefill attention
CONSIST_FAULTS = ("window 1", "KV heads rolled", "KV heads rolled in one layer")
# the same contract for two variants of the configuration, each against its
# own train forward: a 1024-token sliding window (the prefill's window path
# through the kernel, the ring cache of 1024 slots wrapping in the prefill
# and in decode) and the int8 KV cache (decode reads K/V rounded to int8).
# Bounds: twice the gap of one sound run (measured on one H100, PERF.md:
# 8.333e-3 and 1.105e-2 of max|logit|, 130 of 130 argmaxes equal in both),
# never to be loosened; the planted fault must read above each (read 1.544
# and 0.178).
CONSIST_VARIANTS = (
    ("sliding_window=1024", dict(sliding_window=1024), "window 1"),
    ("kv_cache_quant", dict(kv_cache_quant=True), "int8 scales rolled"),
)
CONSIST_VARIANT_REL = {"sliding_window=1024": 1.67e-2, "kv_cache_quant": 2.21e-2}
SMOKE_SERVE = dict(arch="qwen2-7b-smoke", B=2, S=16, gen=8, rel=2e-4)
# the MoE serving path (launch/serve.py) at DeepSeekMoE 16B's full width and
# depth, bf16 activations, fp32 weights (62.9 GiB) from seed 0
MOE_ARCH = "deepseek-moe-16b"
MOE_SERVE = dict(batch=8, prompt_len=2048, gen=64)
# prefill + decode against the train forward at capacity factor E / top_k
# (C >= T: no entry drops, as tests/test_decode_consistency.py assumes), in
# bf16 and in fp32: (max|dlogit|/max|logit|, least share of equal argmaxes).
# Measured once on the card (PERF.md §6), the same in two runs: bf16
# 1.1143e-2 of max|logit| 4.031 and 117 of 130 argmaxes equal (the router's
# bf16 logits round apart between the decode and train shapes, so near-tied
# experts swap; 65 positions have a top-2 gap under twice the largest
# logit gap); fp32 3.0122e-6, 130 of 130.  Bounds: twice the gap and twice
# the flipped argmaxes (bf16; at most 3 of 130 in fp32), never to be
# loosened.  The planted fault (every token's first expert rolled by one)
# read 3.1734e-2 (argmax 0.7538) in bf16 and 2.6508e-2 in fp32: above them.
MOE_CONSIST = {"bfloat16": (2.23e-2, 0.80), "float32": (6.1e-6, 0.97)}
# one layer's moe_apply at full width in fp32 against the dense oracle of
# tests/test_layers.py (every expert on every token, weighted by the top k),
# over 1024 tokens with no drops; the reference test's rtol = atol
MOE_ORACLE_TOKENS = 1024
MOE_ORACLE_TOL = 2e-4
# the SSM, hybrid and VLM serving paths (launch/serve.py) at full width and
# depth, bf16 activations, fp32 weights from seed 0, cold then warm: the
# hybrid's prompt is longer than its 2048-token local window, so the
# windowed prefill and the window-sized ring cache both run; the VLM's
# prompt is 256 patch embeddings and 2048 text tokens.  Flash launches a
# prefill: one an attention layer (none for the SSM).
FAMILY_SERVE = {
    "ssm": ("mamba2-1.3b", dict(batch=8, prompt_len=2048, gen=64), 0),
    "hybrid": ("recurrentgemma-9b", dict(batch=2, prompt_len=4096, gen=64), 12),
    "vlm": ("qwen2-vl-2b", dict(batch=8, prompt_len=2048, gen=64), 28),
}
# prefill + T decode steps against one train forward, B 2.  The SSM's
# sequence mode takes whole 256-step chunks, so its prefill is 7 of them and
# its train forward runs over 8 (the logits compared do not see the tokens
# after S + T: the forward is causal); the hybrid's S is longer than its
# window; the VLM's 256 patches + S + T are 2048 positions, which the train
# forward's plain attention takes in one piece (past 2048 it needs whole
# 1024-query chunks, as the reference's)
FAMILY_CONSIST = {"ssm": dict(B=2, S=1792, T=64), "hybrid": dict(B=2, S=4032, T=64),
                  "vlm": dict(B=2, S=1728, T=64)}
# (max|dlogit|/max|logit|, least share of equal argmaxes) in bf16 and fp32:
# twice one sound run and twice its flipped argmaxes (at most 3 of 130 in
# fp32, as the dense path's), never to be loosened.  Measured once on the
# card (PERF.md §6, PR 24; NVIDIA H100 80GB HBM3, 700 W): ssm bf16 5.5063e-1
# and 54 of 130 argmaxes equal, fp32 3.9854e-4 and 130; hybrid bf16
# 1.2921e-2 and 128, fp32 5.3521e-6 and 130; vlm bf16 8.7891e-3 and 124,
# fp32 2.2612e-6 and 130.  The random 48-layer SSM amplifies any rounding:
# its fp32 prefill position, the same chunked algorithm on the same tokens
# but GEMMs of another length, is already 1.7192e-4 apart, so in bf16 the
# chunked and recurrent forms read 0.55 apart and its bf16 argmax share
# carries no bound; its fp32 gate is the contract.  The reference's two
# forms round apart alike (tests/test_torch_ssm.py::
# test_bf16_decode_gap_is_the_references holds the port's gap within twice
# the reference's on the CPU).
# A planted fault must read above each: the SSM's decode skipping the state
# decay dA (read 1.3608), the hybrid's prefill attention run with no window
# (0.7115, 0.7123), the VLM's text positions starting at n_patches instead
# of g (7.0312e-2, 6.9231e-2)
FAMILY_CONSIST_LIMITS = {
    "ssm": {"bfloat16": (1.1, 0.0), "float32": (8.0e-4, 0.97)},
    "hybrid": {"bfloat16": (2.58e-2, 0.96), "float32": (1.07e-5, 0.97)},
    "vlm": {"bfloat16": (1.75e-2, 0.90), "float32": (4.5e-6, 0.97)},
}
FAMILY_FAULTS = {"ssm": "decode skips the state decay dA",
                 "hybrid": "prefill attention with window None",
                 "vlm": "text positions start at n_patches"}
# one layer at full width in fp32 against a float64 oracle written apart
# from the port's algorithm: the SSM mixer and the RG-LRU block by their
# recurrences a step at a time, the VLM's attention by its M-RoPE streams
# and a softmax over the causal keys; tokens, and the limit on
# max|dy| / max|y| (the reference's SSD test's 1e-4; read 2.381e-6,
# 4.795e-6 and 4.078e-7 on the card)
FAMILY_ORACLE = {"ssm": (512, 1e-4), "hybrid": (2048, 1e-4), "vlm": (512, 1e-4)}
# flash attention: the reference test's tolerances (tests/test_kernels.py),
# at the serve shape, a long one, the reference test's MHA/GQA/MQA shapes,
# ragged lengths, recurrentgemma-9b's attention (hd 256, one KV head; its
# local window 2048, and 128), a width that runs on a wider instance (hd
# 96 on the 128-column one), serve-moe's MHA 16/16 prefill and serve-vlm's
# GQA 12/2 over 256 patches + 2048 tokens; times (bf16, causal) at the
# shapes and windows FLASH_TIMED names
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_SHAPES = [(8, 2048, 28, 4, 128), (1, 8192, 28, 4, 128), (1, 128, 2, 2, 32),
                (2, 256, 4, 2, 64), (1, 384, 8, 1, 16), (1, 1000, 28, 4, 128), (3, 77, 4, 1, 64),
                (2, 4096, 16, 1, 256), (2, 300, 4, 2, 96), (8, 2048, 16, 16, 128),
                (8, 2304, 12, 2, 128)]
FLASH_WINDOWS = {(2, 4096, 16, 1, 256): (None, 2048, 128)}  # else (None, 128)
FLASH_TIMED = {((8, 2048, 28, 4, 128), None): "serve", ((1, 8192, 28, 4, 128), None): "long",
               ((2, 4096, 16, 1, 256), None): "hd-256",
               ((8, 2048, 16, 16, 128), None): "serve-moe",
               ((2, 4096, 16, 1, 256), 2048): "serve-hybrid",
               ((8, 2304, 12, 2, 128), None): "serve-vlm"}
# the bf16 kernel's row log-sum-exp m + log l against an fp32 logsumexp of
# the scaled, masked scores: max |difference| over the rows.  The sound
# kernel read at most 1.907e-6 (measured on one H100: ex2.approx and the fp32
# sums); the limit is 5x that.  An emulated fault, p rounded to bf16 before
# the row sum (its second rounding taken first), must read above it (read
# 9.8e-4 to 1.55e-3).
FLASH_LSE_LIMIT = 1e-5
# bf16 kernel against the plain version on the same inputs in fp32 (exact
# to ~1e-6 here): the kernel rounds p and the output to bf16, so each row's
# largest error should stay within a bf16 ulp or so of the row's max|o|.
# Limit in ulps of that max; a planted fault (key tile 0 skipped for the
# last query tile) must read above it.
FLASH_BF16_ULPS = 2.0
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet, 700 W)
# the main path: launch/train.py phase 1 at full width
SLICE_ARCH = "fed3r-mnv2-proxy"
SLICE = dict(n_samples=8192, seq_len=128, n_classes=100, n_clients=100, clients_per_round=10)
# [ft]: phase 2 of launch/train.py on the slice, 3 rounds of FT-FEAT FedAvg,
# local batches of 64 sequences (10 clients x 2 steps x 64 x 128 tokens)
FT_ROUNDS = 3
FT_LOCAL_BATCH = 64
# one full-width round, RoundEngine (the cohort's local steps vmapped) vs
# ReferenceLoop (a client at a time): the same math in bf16 activations on
# other kernels (batched vs single GEMMs), so each client's two SGD steps
# round apart.  The first card run read 1.68e-4 of max|dtheta| (NVIDIA H100
# 80GB HBM3); the bound is 12 times that, half a bf16 ulp.  A client's
# batches dropped from the engine's cohort read 0.676: outside it.
FT_ROUND_REL = 2e-3
# the smoke width in fp32, card vs CPU (fp32 reassociation over 2 rounds)
FT_SMOKE_REL = 1e-4
FT_SMOKE = dict(n_samples=512, seq_len=32, n_classes=16, n_clients=16, clients_per_round=4,
                rounds=2, local_batch_size=16)
# run_fed3r_ft on configs/simulator.py's set-up: 5 rounds of FT-FEAT for
# each algorithm (the adaptive servers at the reference tests' lr), stopped
# after 2 and resumed for 3 in a second run
FT_SIM_ROUNDS, FT_SIM_STOP = 5, 2
FT_ALGOS = (("fedavg", {}), ("fedavgm", {"server_momentum": 0.9}), ("fedprox", {}),
            ("scaffold", {}), ("fedadam", {"server_lr": 0.01}), ("fedyogi", {"server_lr": 0.01}))


def log(msg: str) -> None:
    print(msg, flush=True)


def max_rel_err(got, want) -> float:
    """max |got - want| / max |want| (0/0 -> 0)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


def reset_counts(ops) -> None:
    for fn in (ops.fed3r_stats, ops.rff_transform, ops.chol_gram, ops.batched_chol_gram,
               ops.quantize_tiles, ops.dequant_accumulate, ops.flash_attention):
        fn.launches = 0


def read_counts(ops) -> dict:
    return {"fed3r_stats": ops.fed3r_stats.launches, "rff": ops.rff_transform.launches,
            "chol_gram": ops.chol_gram.launches,
            "batched_chol_gram": ops.batched_chol_gram.launches,
            "quantize_tiles": ops.quantize_tiles.launches,
            "dequant_acc": ops.dequant_accumulate.launches,
            "flash_attention": ops.flash_attention.launches}


def phase_build(build, ops) -> dict:
    seconds = build.build_all(ops.LIBRARIES)
    log(f"[build] {len(ops.LIBRARIES)} kernels, one nvcc each in parallel "
        f"(nvcc {' '.join(build.NVCC_FLAGS)}) in {seconds:.2f}s")
    for lib in ops.LIBRARIES:
        log(f"[build] {lib.source.relative_to(ROOT)} -> {lib.path().relative_to(ROOT)}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
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
            "wall_s": wall, "peak_bytes": peak, "acc": out["fed3r_acc"],
            "A": out["stats"].A.cpu(), "b": out["stats"].b.cpu()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_simulator(torch, ops) -> dict:
    from repro_torch.configs.simulator import simulator_setup
    from repro_torch.core import fed3r, ncm
    from repro_torch.federated.fed3r_driver import PACK_ROUND_TO, run_fed3r, run_fedncm

    fed, test, f3, fc = simulator_setup("cuda")
    d, C, K, kappa = fed.features.shape[1], fed.n_classes, fc.n_clients, fc.clients_per_round
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


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return list(tree_leaves(tree))


def _bitwise(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and bool((x == y).all())
                                      for x, y in zip(la, lb))


def _dtheta_rel(got, want, start) -> tuple:
    """(max|(got - start) - (want - start)|, max|want - start|) over all leaves."""
    err = scale = 0.0
    for g, w, s0 in zip(_leaves(got), _leaves(want), _leaves(start)):
        dw = w.float() - s0.float()
        err = max(err, float(((g.float() - s0.float()) - dw).abs().max()))
        scale = max(scale, float(dw.abs().max()))
    return err, scale


def phase_ft(torch, ops, sim) -> dict:
    """Phase 2 (FED3R+FT) of launch/train.py at full width, its round at full
    width (no host sync; engine vs the per-client loop), the smoke width in
    fp32 card vs CPU, and run_fed3r_ft for six algorithms at simulator scale."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.federated.round_engine import ReferenceLoop
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model

    cfg = get_config(SLICE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    out = train.run(SLICE_ARCH, rounds=FT_ROUNDS, ft_strategy="feat", algorithm="fedavg",
                    local_batch_size=FT_LOCAL_BATCH, device="cuda", verbose=False, **SLICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts(ops)
    ft, state = out["ft"], out["ft"]["state"]
    ms, toks = ft["round_ms"], ft["round_tokens"]
    log(f"[ft] train.run({SLICE_ARCH!r}, rounds={FT_ROUNDS}, ft_strategy='feat', "
        f"algorithm='fedavg', local_batch_size={FT_LOCAL_BATCH}): wall {wall:.3f}s  phase 1 "
        f"acc {out['fed3r_acc']:.4f} T={out['temperature']:g}; FT acc {ft['ft_acc']} at rounds "
        f"{ft['rounds']}  peak memory {peak / 2**30:.3f} GiB  fed3r_stats launches "
        f"{counts['fed3r_stats']} for {out['n_slots']} phase-1 client slots")
    for i, (m, n) in enumerate(zip(ms, toks)):
        log(f"[ft]   round {i + 1}: {m:.1f} ms (host clock around RoundEngine.step, ending in "
            f"torch.cuda.synchronize())  {n} real tokens of local training: "
            f"{n / m * 1e3:,.0f} tok/s")
    if counts["fed3r_stats"] != out["n_slots"]:
        raise AssertionError(f"fed3r_stats launched {counts['fed3r_stats']} times for "
                             f"{out['n_slots']} phase-1 slots")
    if not torch.equal(state.params["head"]["W"], out["W_head"]):
        raise AssertionError("FT-FEAT moved the head: it must stay bitwise the calibrated W_head")
    if _bitwise(state.params["backbone"], out["params0"]):
        raise AssertionError("the backbone did not move in FT-FEAT's rounds")
    if not all(bool(torch.isfinite(t).all()) for t in _leaves(state.params)):
        raise AssertionError("FT params are not finite")

    # One full-width round (FT, FedAvg): under sync-debug "error", repeated,
    # against ReferenceLoop, and with a client's batches dropped.  The head
    # is drawn 0.01 N(0, 1): the calibrated one fits the training clients
    # so closely that the round's gradients nearly vanish.
    params0, n_classes = out["params0"], SLICE["n_classes"]
    del out, ft, state
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ds = make_token_dataset(gen, SLICE["n_samples"], SLICE["seq_len"], cfg.vocab_size, n_classes)
    clients = train.FtClients(ds, SLICE["n_clients"], SLICE["clients_per_round"], FT_LOCAL_BATCH)
    engine = train.ft_engine(cfg, params0, n_clients=SLICE["n_clients"], ft_strategy="full")
    gen.manual_seed(2)
    head = {"W": 0.01 * torch.randn((cfg.d_feat, n_classes), generator=gen, device="cuda"),
            "b": torch.zeros((n_classes,), device="cuda")}
    s0 = engine.init({"backbone": params0, "head": head})
    cohort = clients.cohort(0).to("cuda")
    reset_counts(ops)
    s1 = engine.step(s0, cohort)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s1b = engine.step(s0, cohort)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0)
    round_peak = torch.cuda.max_memory_allocated()
    repeat = _bitwise(s1b.params, s1.params)
    rep_err, _ = _dtheta_rel(s1b.params, s1.params, s0.params)
    loop = ReferenceLoop(engine.cfg, steps.make_cls_per_example_loss(cfg), engine.freeze)
    sl = loop.step(s0, cohort)
    err, scale = _dtheta_rel(s1.params, sl.params, s0.params)
    dropped = cohort._replace(mask=cohort.mask.clone())
    dropped.mask[0].zero_()
    sf = engine.step(s0, dropped)
    ferr, _ = _dtheta_rel(sf.params, sl.params, s0.params)
    counts = read_counts(ops)
    log(f"[ft] full-width round (FT, FedAvg, {cohort.cohort} clients x {cohort.mask.shape[1]} "
        f"steps x {FT_LOCAL_BATCH} x {SLICE['seq_len']} tokens) under set_sync_debug_mode('error'): "
        f"{round_ms:.1f} ms, peak memory {round_peak / 2**30:.3f} GiB; repeated: "
        f"{'bitwise' if repeat else f'max|d dtheta| {rep_err:.3e}'}; RoundEngine vs "
        f"ReferenceLoop max|d dtheta|/max|dtheta| {err / scale:.4e} (limit {FT_ROUND_REL:.4e}; "
        f"max|dtheta| {scale:.4e}); client slot 0 dropped {ferr / scale:.4e}; fed3r_stats "
        f"launches in these rounds {counts['fed3r_stats']}")
    if counts["fed3r_stats"] != 0:
        raise AssertionError("a fine-tuning round launched fed3r_stats")
    if not (scale > 0 and err <= FT_ROUND_REL * scale and rep_err <= FT_ROUND_REL * scale):
        raise AssertionError("the full-width round disagrees with the per-client loop")
    if ferr <= FT_ROUND_REL * scale:
        raise AssertionError("a dropped client reads inside the engine-vs-loop bound")
    theta0, theta1 = _to(s0.params, "cpu"), _to(s1.params, "cpu")  # [dist]'s yardstick
    del s0, s1, s1b, sl, sf, engine, loop, params0
    torch.cuda.empty_cache()

    # The smoke width in fp32, card vs the CPU's plain path.
    smoke = get_config(SLICE_ARCH + "-smoke").replace(dtype="float32")
    params_cpu = build_model(smoke).init(seed=0, device="cpu")
    gen_cpu = torch.Generator(device="cpu")
    gen_cpu.manual_seed(1)
    kw = dict(FT_SMOKE)
    ds_cpu = make_token_dataset(gen_cpu, kw.pop("n_samples"), kw.pop("seq_len"),
                                smoke.vocab_size, kw.pop("n_classes"))
    ds_gpu = type(ds_cpu)(*(_to(t, "cuda") for t in ds_cpu[:3]), ds_cpu.n_classes)
    W_cpu = 0.01 * torch.randn((smoke.d_feat, ds_cpu.n_classes), generator=gen_cpu)
    kw.update(ft_strategy="full", algorithm="fedavg", verbose=False)
    got = train.ft_phase(smoke, _to(params_cpu, "cuda"), ds_gpu, W_cpu.cuda(), device="cuda", **kw)
    want = train.ft_phase(smoke, params_cpu, ds_cpu, W_cpu, device="cpu", **kw)
    start = {"backbone": params_cpu, "head": {"W": W_cpu, "b": torch.zeros(ds_cpu.n_classes)}}
    serr, sscale = _dtheta_rel(_to(got["state"].params, "cpu"), want["state"].params, start)
    log(f"[ft] smoke width, fp32, {FT_SMOKE['rounds']} rounds, card vs CPU: max|d dtheta|/"
        f"max|dtheta| {serr / sscale:.3e} (limit {FT_SMOKE_REL:g})  acc {got['ft_acc']} vs "
        f"{want['ft_acc']}")
    if not (sscale > 0 and serr <= FT_SMOKE_REL * sscale):
        raise AssertionError("smoke-width FT on the card disagrees with the CPU")

    sim_out = phase_ft_sim(torch, sim)
    return {"round_ms": ms, "round_tokens": toks, "peak_bytes": peak, "round_peak": round_peak,
            "engine_vs_loop": err / scale, "repeat_bitwise": repeat, "theta0": theta0,
            "theta1": theta1, **sim_out}


def phase_ft_sim(torch, sim) -> dict:
    """run_fed3r_ft on the simulator's set-up for every algorithm: FT-FEAT
    keeps W bitwise, a round is bitwise invariant to the cohort's order, and
    stage 2 stopped after FT_SIM_STOP rounds and resumed is bitwise the
    uninterrupted run."""
    import shutil
    import tempfile

    from repro_torch.data.pipeline import pack_cohort_batches
    from repro_torch.federated.fed3r_driver import feature_finetune_task, run_fed3r_ft
    from repro_torch.federated.simulator import make_round_engine, pack_round, run_federated

    fed, test, f3, fc = sim["fed"], sim["test"], sim["f3"], sim["fc"]
    d, C = fed.features.shape[1], fed.n_classes
    n_batches = -(-int(fed.client_sizes().max()) // fc.local_batch_size)
    ck_root = os.path.join(ROOT, "build")
    os.makedirs(ck_root, exist_ok=True)
    out = {}
    for algo, extra in FT_ALGOS:
        fca = dataclasses.replace(fc, n_rounds=FT_SIM_ROUNDS, algorithm=algo, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, info = run_fed3r_ft(fed, test.features, test.labels, f3, fca, strategy="feat",
                                    device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not torch.equal(params["W"], info["W_init"]):
            raise AssertionError(f"{algo}: FT-FEAT moved W off its FED3R init")

        task = feature_finetune_task(d, C, info["W_init"], test.features, test.labels,
                                     strategy="feat", device="cuda")
        engine = make_round_engine(task, fed, fca)
        s0 = engine.init(task.params0)
        chosen, cohort = pack_round(fed, fca, 0, n_batches)
        rev = [int(k) for k in chosen][::-1]
        perm = pack_cohort_batches(
            [(fed.client(k).features, fed.client(k).labels) for k in rev],
            fca.local_batch_size, n_batches, fca.local_epochs, client_ids=rev,
            seed=(fca.seed + 7, 0))
        if not all(np.array_equal(a, b) for a, b in zip(cohort, perm)):
            raise AssertionError(f"{algo}: the reversed cohort packed other arrays")
        perm_bitwise = _bitwise(engine.step(s0, cohort.to("cuda")),
                                engine.step(s0, perm.to("cuda")))

        ck = tempfile.mkdtemp(prefix="ft_ckpt_", dir=ck_root)
        try:
            run_federated(task, fed, dataclasses.replace(fca, n_rounds=FT_SIM_STOP),
                          ckpt_dir=ck, ckpt_every=FT_SIM_STOP)
            resumed, rinfo = run_fed3r_ft(fed, test.features, test.labels, f3, fca,
                                          strategy="feat", ckpt_dir=ck, resume=True,
                                          device="cuda")
        finally:
            shutil.rmtree(ck)
        resume_bitwise = _bitwise(resumed, params)
        acc = info["ft_history"].accuracy[-1]
        log(f"[ft-sim] run_fed3r_ft {algo} {extra or ''}: {FT_SIM_ROUNDS} FT-FEAT rounds on "
            f"{fed.n_clients} clients x d={d}, {fca.clients_per_round}/round, after stage 1 "
            f"({info['fed3r_rounds']} rounds, FED3R acc {info['fed3r_history'].accuracy[-1]:.4f}, "
            f"T={info['temperature']:g}): acc {acc:.4f}, wall {wall:.3f}s; W bitwise the init; "
            f"a round under the reversed cohort {'bitwise' if perm_bitwise else 'DIFFERS'}; "
            f"stopped after {FT_SIM_STOP} and resumed for {FT_SIM_ROUNDS - FT_SIM_STOP} "
            f"({rinfo['ft_history'].rounds}): {'bitwise' if resume_bitwise else 'DIFFERS'}")
        if not (perm_bitwise and resume_bitwise):
            raise AssertionError(f"{algo}: a round is not bitwise invariant to the cohort's "
                                 "order, or the resumed run is not bitwise the uninterrupted one")
        out[algo] = {"acc": acc, "wall_s": wall}
    return {"sim": out}


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


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS) -> dict:
    """The least time the card could take: FLOPs at the peak of their type
    (the fp32 FMA peak unless given) or the bytes at the HBM rate, whichever
    is larger."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "t_ops": t_ops, "t_bytes": t_bytes, "flops": flops, "nbytes": nbytes}


def timed(name, shape, kernel, plain, library, library_label, b) -> dict:
    """Kernel, plain-version and library times at one shape, with the bound.

    ``ms`` and ``library_ms`` time back-to-back calls (``cuda_ms``): the
    slower of the device work and the host's launch path.  ``device_ms``
    and ``library_device_ms`` are each call's device time alone, from a CUDA
    graph of the calls replayed; the gap between the two is host time
    (:mod:`repro_torch.launch.timing`).
    """
    from repro_torch.launch.timing import cuda_ms, device_ms

    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    dev_ms = device_ms(kernel)
    library_ms = cuda_ms(library) if library is not None else None
    lib_dev_ms = device_ms(library) if library is not None else None
    lib = (f"{library_label} {library_ms:.4f} (device_ms {lib_dev_ms:.4f})"
           if library is not None else library_label)
    log(f"[kernel] {name} {shape}: kernel_ms {ms:.4f}  device_ms {dev_ms:.4f}  plain_ms "
        f"{plain_ms:.4f}  {lib}  bound_ms {b['bound_ms']:.4f} by {b['bound_by']} "
        f"({b['flops'] / 1e9:.4f} GFLOP needed: {b['t_ops']:.4f} ms; {b['nbytes'] / 1e6:.3f} MB: "
        f"{b['t_bytes']:.4f} ms)  {b['flops'] / ms / 1e9:.2f} TFLOP/s needed-work rate = "
        f"{100 * b['bound_ms'] / ms:.1f}% of the bound ({100 * b['bound_ms'] / dev_ms:.1f}% in "
        f"device_ms)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}


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
        symmetric = bool(torch.equal(A, A.T))
        log(f"[kernel] fed3r_stats n={n} d={d} C={C}: max|dA|/max|A| {eA:.3e}  "
            f"max|db|/max|b| {eb:.3e}  (limit {STATS_REL:g})  symmetric {symmetric}")
        if not (eA <= STATS_REL and eb <= STATS_REL and symmetric):
            raise AssertionError(f"fed3r_stats disagrees with its plain version at {(n, d, C)}, "
                                 f"or its A is not symmetric")
        if i == 2:  # no atomics, no split-K: a second launch gives the same bits
            A2, b2 = ops.fed3r_stats(Z, Y)
            same = bool(torch.equal(A, A2) and torch.equal(b, b2))
            log(f"[kernel] fed3r_stats rf shape: two launches bitwise equal: {same}")
            if not same:
                raise AssertionError("fed3r_stats is not bitwise repeatable at the rf shape")
            del A2, b2
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
    repeatable = bool(torch.equal(out, ops.rff_transform(Z, omega, beta)))
    log(f"[kernel] rff {label} n={Z.shape[0]} d={Z.shape[1]} D={D}: max|dpsi| {err:.3e} "
        f"(limit {RFF_REL:g}*sqrt(2/D) = {limit:.3e})  repeatable {repeatable}")
    if not err <= limit:
        raise AssertionError(f"rff disagrees with its plain version at {tuple(Z.shape)}, D={D}")
    if not repeatable:  # no atomics, no split-K: a second launch gives the same bits
        raise AssertionError(f"rff is not bitwise repeatable at {tuple(Z.shape)}, D={D}")
    return err


def rff_placement(torch, ops, rff_mod, Z, omega, beta, label) -> None:
    """psi of a sample row is the same bits wherever the row sits in Z and
    whatever n is (Z permuted, Z cut to a prefix), and both instances give
    the same bits: the chain the rf and streaming engines' invariance to
    the order of clients and arrivals rests on."""
    n, D = Z.shape[0], omega.shape[1]
    psi = ops.rff_transform(Z, omega, beta)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    perm = torch.randperm(n, generator=gen, device="cuda")
    permuted = bool(torch.equal(ops.rff_transform(Z[perm].contiguous(), omega, beta), psi[perm]))
    prefixes = [k for k in (1, 77, n // 2 + 3) if k <= n]
    prefix = all(bool(torch.equal(ops.rff_transform(Z[:k].contiguous(), omega, beta), psi[:k]))
                 for k in prefixes)
    both = all(bool(torch.equal(rff_mod._launch(Z, omega, beta, tile=t), psi)) for t in (64, 128))
    sms = sm_count(torch)
    log(f"[kernel] rff {label} n={n} D={D} (instance {rff_mod.pick_tile(n, D, sms)}): "
        f"psi(Z[perm]) == psi(Z)[perm] {permuted}, psi(Z[:k]) == psi(Z)[:k] at k {prefixes} "
        f"{prefix}, both instances bitwise {both}")
    if not (permuted and prefix and both):
        raise AssertionError(f"rff's rows depend on their place or instance at {label}")


def phase_kernel_rff(torch, ops, ref, rf_shard, stream_wave, omega, beta) -> dict:
    """rff at the RF path's shard, the stream's wave and a ragged shape;
    times at the shard shape (no single PyTorch call computes psi: the
    GEMM alone, torch.addmm, is printed beside it)."""
    from repro_torch.kernels import rff as rff_mod

    abs_err = max(rff_check(torch, ops, ref, rf_shard, omega, beta, "rf shard"),
                  rff_check(torch, ops, ref, stream_wave, omega, beta, "stream wave"))
    rff_placement(torch, ops, rff_mod, rf_shard, omega, beta, "rf shard")
    rff_placement(torch, ops, rff_mod, stream_wave, omega, beta, "stream wave")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    for n, d, D in RFF_SHAPES_RAGGED + RFF_EDGES:
        # arguments over about [-3, 2*pi + 3]: the product's error matters
        Z = torch.randn((n, d), generator=gen, device="cuda")
        om = torch.randn((d, D), generator=gen, device="cuda") / math.sqrt(d)
        be = torch.rand((D,), generator=gen, device="cuda") * (2.0 * math.pi)
        abs_err = max(abs_err, rff_check(torch, ops, ref, Z, om, be, "ragged"))
        psi = {t: rff_mod._launch(Z, om, be, tile=t) for t in (64, 128)}
        same = bool(torch.equal(psi[64], psi[128]))
        log(f"[kernel] rff n={n} d={d} D={D}: both instances bitwise {same}")
        if not same:
            raise AssertionError(f"rff's instances disagree at n={n}, d={d}, D={D}")
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
            out = {**t, "library_ms": None, "library_device_ms": None,
                   "gemm_only_ms": t["library_ms"]}
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


def live_rows(Z, Y):
    """The rows of a masked design that are not all zero, in order."""
    live = Z.ne(0).any(dim=-1) | Y.ne(0).any(dim=-1)
    return Z[live].contiguous(), Y[live].contiguous()


def padding_gate(torch, ops, L, Z, Y, label) -> None:
    """The path's own padded wave against its live rows compacted: G and B
    bitwise equal (the kernel skips all-zero panels and multiplies the other
    padding rows; either leaves every fmaf chain as it was)."""
    from repro_torch.kernels.chol_update import pick_tile

    d, (n, C) = L.shape[0], Y.shape
    Zl, Yl = live_rows(Z, Y)
    G, B = ops.chol_gram(L, Z, Y)
    Gl, Bl = ops.chol_gram(L, Zl, Yl)
    same = bool(torch.equal(G, Gl) and torch.equal(B, Bl))
    minus0 = int((Z.eq(0) & torch.signbit(Z)).sum())
    log(f"[kernel] chol_gram {label}: instance {pick_tile(d, C, sm_count(torch))}-wide tiles; "
        f"{Zl.shape[0]} live rows of {n} ({minus0} entries -0.0); G and B bitwise equal to the "
        f"live rows compacted: {same}")
    if not same:
        raise AssertionError(f"chol_gram's padding rows changed a bit at {label}")


def sm_count(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_kernel_chol(torch, ops, ref, stream_case, rf_case) -> dict:
    """chol_gram at the stream's wave shape (d = 1280), at D = 5000, at n = 0
    and a ragged shape; both path waves also against their live rows
    compacted; times at both path shapes.  The library call is one
    torch.matmul of the pre-stacked [L^T; Z]^T and [[L^T | 0]; [Z | Y]]."""
    from repro_torch.launch.timing import stacked_gram

    L, Z, Y = stream_case
    abs_err = max(chol_check(torch, ops, ref, L, Z, Y, "stream wave"),
                  chol_check(torch, ops, ref, *rf_case, "stream-rf wave"),
                  chol_check(torch, ops, ref, L, Z[:0], Y[:0], "empty wave"))
    padding_gate(torch, ops, L, Z, Y, "stream wave")
    padding_gate(torch, ops, *rf_case, "stream-rf wave")
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
        t = timed("chol_gram", f"{label} shape d={d} n={n} C={C}",
                  lambda: ops.chol_gram(L, Z, Y), lambda: ref.chol_gram_ref(L, Z, Y),
                  stacked_gram(L, Z, Y),
                  "library_ms (one torch.matmul [L^T; Z]^T [[L^T|0]; [Z|Y]], fp32, no TF32)",
                  bound(gram_flops(L, Z, Y), 4.0 * (d * d + n * d + n * C + d * d + d * C)))
        out = out or t
    return {"max_abs_err": abs_err, **out}


def phase_rf(torch, ops, ref, sim) -> dict:
    """FED3R-RF at D = 5000 through run_fed3r, on the simulator's set-up."""
    from repro_torch.configs.simulator import RF_D
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
                       "packed": packed, "L": state.L, "W": W, "W64": W64, "e_batch": e_batch}
    return out


def phase_stream_rf(torch, ops, ref, packed, params) -> dict:
    """The stream's arrivals through StreamingEngine(rff_params) at D = 5000."""
    from repro_torch.configs.simulator import RF_D
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
    from repro_torch.launch.timing import cuda_ms

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


def phase_stream_slots(torch, ops, W_arrival) -> dict:
    """serve_stream(engine="slots") at the stream's shape."""
    from repro_torch.launch.serve_stream import serve_stream

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    res = serve_stream(engine="slots", verbose=False, device="cuda", **STREAM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    T = res["packed"].n_waves
    same = bool(torch.equal(res["W"], W_arrival))
    log(f"[stream-slots] serve_stream engine=slots: {T} waves, acc per segment "
        f"{[round(a, 4) for a in res['acc_served']]}, final {res['acc_final']:.4f}; "
        f"{res['dispatches']} dispatches ({res['serve_dispatches']} serve); stage seconds "
        + " ".join(f"{k} {v:.4f}" for k, v in res["stage_s"].items())
        + f"; wall {wall:.3f}s, peak memory {peak / 2**30:.3f} GiB; launches {counts}; served W "
        f"bitwise the arrival policy's: {same}")
    if counts["chol_gram"] != T or counts["batched_chol_gram"] or counts["rff"] or counts[
            "fed3r_stats"]:
        raise AssertionError(f"serve_stream(engine='slots') launched {counts} for {T} waves")
    if not same or res["acc_final"] <= 2.0 / STREAM["n_classes"]:
        raise AssertionError("the slot engine's served head is not the stream's")
    return {"wall_s": wall, "peak_bytes": peak}


def burst_tenants(log_, k: int) -> list:
    """The distinct tenants of burst k of a serve_heads run (its Zipf trace)."""
    from repro_torch.launch.serve_heads import _make_traffic

    q = HEADS["queries_per_burst"]
    n_bursts = len(log_["solved_now"])
    trace = _make_traffic("zipf", HEADS["n_clients"], n_bursts * q, 1.1, HEADS["seed"] + 17)
    return sorted({int(t) for t in trace[k * q:(k + 1) * q]})


def phase_heads(torch, ops) -> dict:
    """serve_heads at full width: lru strict, lru segmented and slots."""
    from repro_torch.launch.serve_heads import serve_heads

    runs = {}
    C = HEADS["n_classes"]
    for label, engine, invalidation in HEADS_RUNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = serve_heads(engine=engine, invalidation=invalidation, verbose=False,
                          device="cuda", **HEADS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        solves = sum(1 for n in res["solved_now"] if n > 0)
        c = res["cache"]
        line = (f"[heads] serve_heads {label}: {len(res['solved_now'])} bursts of "
                f"{HEADS['queries_per_burst']}, heads solved per burst {res['solved_now']}; hit "
                f"rate {res['hit_rate'][-1]:.3f} ({c['hits']} hits / {c['misses']} misses, "
                f"{c['stale_evictions']} stale, {c['lru_evictions']} evictions); acc on "
                f"tenant-local queries {np.mean(res['acc_personal']):.4f} (per burst "
                f"{[round(a, 4) for a in res['acc_personal']]}), global head test acc "
                f"{res['acc_global_test']:.4f}; wall {wall:.3f}s, peak memory "
                f"{peak / 2**30:.3f} GiB; launches {counts}")
        if engine == "slots":
            line += ("; stage seconds " + " ".join(f"{k} {v:.4f}" for k, v in
                                                   res["stage_s"].items())
                     + f"; latency p50 {1e3 * res['latency_p50_s']:.3f} ms p99 "
                     f"{1e3 * res['latency_p99_s']:.3f} ms")
        log(line)
        if counts["batched_chol_gram"] != solves or counts["chol_gram"] != HEADS["n_waves"] or \
                counts["rff"] or counts["fed3r_stats"]:
            raise AssertionError(f"serve_heads {label} launched {counts} for {solves} solves "
                                 f"and {HEADS['n_waves']} waves")
        if engine == "lru" and res["personalize_dispatches"] != solves:
            raise AssertionError(f"{res['personalize_dispatches']} head solves for {solves}")
        if not all(bool(torch.isfinite(sc).all()) for sc in res["scores"]):
            raise AssertionError(f"serve_heads {label} served a non-finite score")
        if np.mean(res["acc_personal"]) <= 2.0 / C or res["acc_global_test"] <= 2.0 / C:
            raise AssertionError(f"serve_heads {label}: accuracy at chance")
        runs[label] = {**res, "wall_s": wall, "peak_bytes": peak,
                       "launches": counts["batched_chol_gram"]}

    lru, slots = runs["lru strict"], runs["slots"]
    err = max(float((a - b).abs().max()) / float(a.abs().max())
              for a, b in zip(lru["scores"], slots["scores"]))
    same_modes = lru["modes"] == slots["modes"]
    log(f"[heads] strict: lru and slots serve the same modes: {same_modes}; max|score_lru - "
        f"score_slots| / max|score| {err:.3e} (limit {SCORE_REL:g})")
    if not same_modes or err > SCORE_REL:
        raise AssertionError("the lru and slots engines serve different answers under strict")
    return runs


def widest_cohort(run) -> tuple:
    """The run's widest solve: its burst's distinct tenants, packed as the
    server packs a miss list (cohort rounded up to 8, the dataset's max_n)."""
    from repro_torch.data.pipeline import pack_personal_cohort

    k = int(np.argmax(run["solved_now"]))
    tenants = burst_tenants(run, k)
    fed = run["server"].dataset
    max_n = int(fed.client_sizes().max())

    def pack(ids):
        return pack_personal_cohort(
            [(fed.client(t).features, fed.client(t).labels) for t in ids], client_ids=ids,
            cohort_size=-(-len(ids) // 8) * 8, max_n=max_n)

    return tenants, pack


def phase_heads_gates(torch, run) -> dict:
    """The heads' numerics on the run's final global state and widest cohort."""
    from repro_torch.core import fed3r
    from repro_torch.federated.personalization import PersonalizationEngine, PersonalizeConfig

    C = HEADS["n_classes"]
    state = run["server"].state.factored
    tenants, pack = widest_cohort(run)
    packed = pack(tenants)
    eng = PersonalizationEngine(PersonalizeConfig(n_classes=C, alpha_grid=HEADS["alpha_grid"]),
                                device="cuda")
    heads = eng.solve_heads(state, packed)
    Wg = fed3r.factored_solution(state)
    ids = heads.client_ids.tolist()
    alphas = heads.alpha.tolist()
    alpha0 = [k for k in range(len(ids)) if ids[k] < 0 or alphas[k] == 0.0]
    # solve_at with every other real row pinned to 0
    pinned = [0.0 if k % 2 == 0 else float(HEADS["alpha_grid"][1 + k % 4])
              for k in range(packed.cohort)]
    at = eng.solve_at(state, packed, pinned)
    bitwise = all(torch.equal(heads.W[k], Wg) for k in alpha0) and all(
        torch.equal(at.W[k], Wg) for k in range(packed.cohort) if pinned[k] == 0.0)
    log(f"[heads] widest cohort: {len(tenants)} tenants in a cohort of {packed.cohort} "
        f"(max_n {packed.inputs.shape[1]}), selected alpha {alphas}; alpha = 0 and padded rows "
        f"({len(alpha0)} of solve_heads, {pinned.count(0.0)} of solve_at) bitwise "
        f"factored_solution: {bitwise}")
    if not bitwise:
        raise AssertionError("an alpha = 0 or padded head is not the global head, bitwise")

    # every real head against a float64 closed form at its alpha, beside the
    # fp32 unbatched personalized_solution: the swept heads at their selected
    # alpha, and the solve_at heads at the pinned ones (alpha > 0 on odd rows)
    L64, b64 = state.L.double(), state.b.double()
    G0 = L64 @ L64.T
    errs, worst_ratio = [], 0.0
    for k in range(packed.cohort):
        if ids[k] < 0:
            continue
        x = torch.as_tensor(packed.inputs[k], device="cuda")
        y = torch.as_tensor(packed.labels[k], device="cuda")
        m = torch.as_tensor(packed.mask[k], device="cuda")
        st = fed3r.client_stats(x, y, C, m)
        z = x.double() * m.double()[:, None]
        yh = torch.nn.functional.one_hot(y.long(), C).double() * m.double()[:, None]
        for W, a in ((heads.W[k], alphas[k]), (at.W[k], pinned[k])):
            W64 = torch.linalg.solve(G0 + a * (z.T @ z), b64 + a * (z.T @ yh))
            W64 = W64 / W64.norm(dim=0, keepdim=True).clamp_min(1e-12)
            e_eng = float((W.double() - W64).abs().max())
            e_one = float((fed3r.personalized_solution(state, st, a).double() - W64).abs().max())
            errs.append((a, e_eng, e_one))
            worst_ratio = max(worst_ratio, e_eng / (2 * e_one + 1e-5))
    pos = [e for e in errs if e[0] > 0.0]
    log(f"[heads] float64 closed form, {len(errs)} heads ({len(pos)} at alpha > 0): max|W_engine "
        f"- W_f64| {max(e[1] for e in errs):.3e} (alpha > 0: "
        f"{max((e[1] for e in pos), default=0.0):.3e}), max|W_unbatched32 - W_f64| "
        f"{max(e[2] for e in errs):.3e} (alpha > 0: {max((e[2] for e in pos), default=0.0):.3e}); "
        f"worst head at {worst_ratio:.3f} of its limit (2 x unbatched + 1e-5)")
    if worst_ratio > 1.0 or not pos:
        raise AssertionError("a solved head is further from float64 than 2x the unbatched solve")

    rng = np.random.default_rng(11)
    perm = [tenants[i] for i in rng.permutation(len(tenants))]
    again = eng.solve_heads(state, pack(perm))
    same = bool(torch.equal(again.W, heads.W) and torch.equal(again.alpha, heads.alpha)
                and torch.equal(again.client_ids, heads.client_ids))
    log(f"[heads] heads bitwise equal under a permutation of the miss list: {same}")
    if not same:
        raise AssertionError("the heads changed under a permutation of the miss list")
    steps = solve_breakdown(torch, eng, state, packed, heads.alpha)
    return {"packed": packed, "state": state, "alphas": heads.alpha, "steps": steps}


def solve_breakdown(torch, eng, state, packed, alphas) -> dict:
    """Device time of each step of one solve_heads on the widest cohort, each
    step timed alone on that cohort's inputs, and the solve's peak memory."""
    from repro_torch.core import fed3r
    from repro_torch.core.fed3r import Fed3RFactored
    from repro_torch.kernels.ops import batched_chol_gram
    from repro_torch.launch.timing import cuda_ms

    L, b = state.L, state.b
    x, y, m, ho = eng._cohort(packed, "inputs", "labels", "mask", "holdout")
    grid = torch.tensor(HEADS["alpha_grid"], dtype=torch.float32, device="cuda")
    g = grid[:, None, None, None]
    z, yh = eng._design(x, y, m)
    tr = (1.0 - ho)[..., None]
    z_tr, yh_tr, z_ho = z * tr, yh * tr, z * ho[..., None]

    def grams():
        S = z_tr.transpose(-1, -2) @ z_tr
        Bt = z_tr.transpose(-1, -2) @ yh_tr
        return L @ L.T + g * S[None], b + g * Bt[None]

    Gs, rhs = grams()
    Lg = fed3r.psd_cholesky(Gs)

    def sweep_solve():
        W = fed3r.normalize_columns(torch.cholesky_solve(rhs, Lg), axis=2)
        score = torch.sum(ho[None] * (torch.argmax(z_ho @ W, -1) != y[None].long()), dim=2)
        return torch.argmin(score, dim=0)

    s = torch.sqrt(alphas)[:, None, None]
    zs, ys = (z * s).contiguous(), (yh * s).contiguous()
    G, B = batched_chol_gram(L, zs, ys)
    Lk = fed3r.psd_cholesky(G)
    Wp = eng._batched_solve(Lk, b[None] + B)
    steps = {
        "design": cuda_ms(lambda: eng._design(x, y, m)),
        "sweep grams": cuda_ms(grams),
        "sweep psd_cholesky": cuda_ms(lambda: fed3r.psd_cholesky(Gs)),
        "sweep solves+score": cuda_ms(sweep_solve),
        "refit batched_chol_gram": cuda_ms(lambda: batched_chol_gram(L, zs, ys)),
        "refit psd_cholesky": cuda_ms(lambda: fed3r.psd_cholesky(G)),
        "refit solves": cuda_ms(lambda: eng._batched_solve(Lk, b[None] + B)),
        "global solve+select": cuda_ms(lambda: torch.where(
            alphas[:, None, None] == 0.0, fed3r.factored_solution(Fed3RFactored(L=L, b=b))[None],
            Wp)),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    total = cuda_ms(lambda: eng.solve_heads(state, packed))
    peak = torch.cuda.max_memory_allocated() - base
    K, d = packed.cohort, L.shape[0]
    log(f"[heads] one solve_heads of the widest cohort (K={K}, grid {len(grid)}, d={d}): "
        f"{total:.4f} ms, peak memory above its inputs {peak / 2**30:.3f} GiB; each step timed "
        "alone: " + "  ".join(f"{k} {v:.4f} ms" for k, v in steps.items())
        + f"  (sum {sum(steps.values()):.4f} ms)")
    return {"total_ms": total, "peak_bytes": peak, **steps}


def phase_kernel_batched(torch, ops, ref, L, packed) -> dict:
    """batched_chol_gram at the heads path's shape (the widest cohort and its
    first 8 heads: d = 1280, n = max_n, C = 100), at a ragged shape and at
    n = 0; times at the widest cohort.  Each head is also held bitwise
    against chol_gram(L, Z_k, Y_k): the two kernels share their tile loop."""
    from repro_torch.core import fed3r
    from repro_torch.kernels.chol_update import pick_tile
    from repro_torch.launch.timing import stacked_gram

    C = HEADS["n_classes"]
    x = torch.as_tensor(packed.inputs, device="cuda")
    y = torch.as_tensor(packed.labels, device="cuda")
    m = torch.as_tensor(packed.mask, device="cuda")
    K, n = m.shape
    z, yh, _ = fed3r.masked_design(x.reshape(K * n, -1), y.reshape(-1), C, m.reshape(-1))
    Z, Y = z.reshape(K, n, -1).contiguous(), yh.reshape(K, n, C).contiguous()

    def check(L, Z, Y, label) -> float:
        G, B = ops.batched_chol_gram(L, Z, Y)
        torch.cuda.synchronize()
        Gr, Br = ref.batched_chol_gram_ref(L, Z, Y)
        eG = max_rel_err(G, Gr)
        empty = Z.shape[1] == 0
        eB = float(B.abs().max()) if empty else max_rel_err(B, Br)
        sym = bool(torch.equal(G, G.transpose(1, 2)))
        heads_bitwise = all(
            torch.equal(G[k], Gk) and torch.equal(B[k], Bk)
            for k in range(Z.shape[0]) for Gk, Bk in [ops.chol_gram(L, Z[k], Y[k])])
        log(f"[kernel] batched_chol_gram {label} K={Z.shape[0]} d={L.shape[0]} n={Z.shape[1]} "
            f"C={Y.shape[2]}: max|dG|/max|G| {eG:.3e}  "
            f"{'max|B|' if empty else 'max|dB|/max|B|'} {eB:.3e} (limit {STATS_REL:g}"
            f"{', B exactly 0' if empty else ''})  symmetric {sym}  every head bitwise "
            f"chol_gram(L, Z_k, Y_k) {heads_bitwise}")
        if not (eG <= STATS_REL and (eB == 0.0 if empty else eB <= STATS_REL) and sym
                and heads_bitwise):
            raise AssertionError(f"batched_chol_gram disagrees at {label}")
        return max(float((G - Gr).abs().max()), float((B - Br).abs().max()))

    abs_err = max(check(L, Z, Y, "widest cohort"), check(L, Z[:8], Y[:8], "8 heads"),
                  check(L, Z[:8, :0], Y[:8, :0], "no sample rows"))
    # each head's live rows moved to the front, the cohort cut to the widest
    # head's live rows: G and B bitwise equal to the padded cohort's
    live = [live_rows(Z[k], Y[k]) for k in range(K)]
    w = max(z.shape[0] for z, _ in live)
    Zp, Yp = Z.new_zeros((K, w, Z.shape[2])), Y.new_zeros((K, w, C))
    for k, (zk, yk) in enumerate(live):
        Zp[k, :zk.shape[0]], Yp[k, :yk.shape[0]] = zk, yk
    G, B = ops.batched_chol_gram(L, Z, Y)
    Gp, Bp = ops.batched_chol_gram(L, Zp, Yp)
    same = bool(torch.equal(G, Gp) and torch.equal(B, Bp))
    sms, d = sm_count(torch), L.shape[0]
    log(f"[kernel] batched_chol_gram widest cohort: instances {pick_tile(d, 0, sms)}-wide (L L^T) "
        f"and {pick_tile(d, C, sms, K)}-wide (heads); {sum(z.shape[0] for z, _ in live)} live rows "
        f"of {K * n}, at most {w} a head; G and B bitwise equal to the live rows compacted: {same}")
    if not same:
        raise AssertionError("batched_chol_gram's padding rows changed a bit")
    del G, B, Gp, Bp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(50)
    for Kr, d, nr, Cr in BATCHED_SHAPES_RAGGED:
        A = torch.randn((d, d), generator=gen, device="cuda")
        Lr = torch.linalg.cholesky(A @ A.T / d + torch.eye(d, device="cuda")).contiguous()
        Zr = torch.randn((Kr, nr, d), generator=gen, device="cuda")
        Yr = torch.nn.functional.one_hot(
            torch.randint(0, Cr, (Kr, nr), generator=gen, device="cuda"), Cr).to(torch.float32)
        abs_err = max(abs_err, check(Lr, Zr, Yr, "ragged"))

    d = L.shape[0]
    flops = float(d * (d + 1) * (d + 2) / 3) + sum(stats_flops(Z[k], Y[k]) for k in range(K))
    t = timed("batched_chol_gram", f"widest cohort K={K} d={d} n={n} C={C}",
              lambda: ops.batched_chol_gram(L, Z, Y), lambda: ref.batched_chol_gram_ref(L, Z, Y),
              stacked_gram(L, Z, Y),
              "library_ms (one torch.matmul [L^T; Z_k]^T [[L^T|0]; [Z_k|Y_k]] over K, fp32, "
              "no TF32)",
              bound(flops, 4.0 * (d * d + K * n * d + K * n * C + K * (d * d + d * C))))
    return {"max_abs_err": abs_err, **t}


def client_design(torch, packed, s, c, n_classes):
    """Slot (s, c) of a packed selection: its masked design on the card."""
    from repro_torch.core import fed3r

    x = torch.as_tensor(packed.inputs[s, c], device="cuda")
    y = torch.as_tensor(packed.labels[s, c], device="cuda")
    m = torch.as_tensor(packed.mask[s, c], device="cuda")
    z, yh, _ = fed3r.masked_design(x, y, n_classes, m)
    return z.contiguous(), yh.contiguous()


def phase_wire(torch, ops, ref, sim) -> dict:
    """The simulator's federation through AccumulationEngine under each wire."""
    from repro_torch.core import fed3r
    from repro_torch.data.pipeline import pack_client_shards
    from repro_torch.federated.compress import WireFormat
    from repro_torch.federated.costs import stats_wire_bytes
    from repro_torch.federated.engine import AccumulationEngine, EngineConfig
    from repro_torch.federated.fed3r_driver import PACK_ROUND_TO

    fed, test, f3, fc = sim["fed"], sim["test"], sim["f3"], sim["fc"]
    K, kappa, C, d = fc.n_clients, fc.clients_per_round, fed.n_classes, sim["d"]
    clients = [(fed.client(k).features, fed.client(k).labels) for k in range(K)]
    packed = pack_client_shards(clients, kappa, client_ids=list(range(K)), round_to=PACK_ROUND_TO)
    n_slots = packed.n_shards * packed.clients_per_shard
    plain = AccumulationEngine(EngineConfig(n_classes=C), device="cuda")
    base = plain.accumulate(plain.init(d), packed)
    W32 = fed3r.solve(base.stats, f3.ridge_lambda)
    tx = torch.as_tensor(test.features, device="cuda")
    ty = torch.as_tensor(test.labels, device="cuda")
    fp32_bytes = stats_wire_bytes(d, C, "fp32")
    out = {}
    for kind, kw in WIRES:
        fmt = WireFormat(kind=kind, **kw)
        eng = AccumulationEngine(EngineConfig(n_classes=C, wire=fmt), device="cuda")
        acc = eng.init(d)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        t0 = time.perf_counter()
        acc = eng.accumulate(acc, packed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        W = fed3r.solve(acc.stats, f3.ridge_lambda)
        acc_test = float(fed3r.accuracy(W, tx, ty))
        eA = max_rel_err(acc.stats.A, base.stats.A)
        eW = float((W - W32).abs().max())
        nbytes = fmt.wire_bytes(d, C)
        per_client = {k: v / n_slots for k, v in counts.items() if v}
        log(f"[wire] {kind} {kw or ''}: {K} clients in {n_slots} slots, launches per client "
            f"{per_client}; {nbytes:.0f} B an upload ({fp32_bytes / nbytes:.3f}x fewer than fp32 "
            f"{fp32_bytes:.0f} B); max|dA|/max|A| vs fp32 {eA:.3e}, max|W - W_fp32| {eW:.3e}, test "
            f"acc {acc_test:.4f}; wall {wall:.3f}s, peak memory {peak / 2**30:.3f} GiB")
        quant = 2 * n_slots if kind == "int8" else 0
        if counts["fed3r_stats"] != n_slots or counts["quantize_tiles"] != quant or \
                counts["dequant_acc"] != quant or counts["chol_gram"] or counts["rff"]:
            raise AssertionError(f"[wire] {kind}: launches {counts} for {n_slots} client slots")
        if not all(bool(torch.isfinite(t).all()) for t in (acc.stats.A, acc.stats.b, W)):
            raise AssertionError(f"[wire] {kind}: the statistics or W are not finite")
        if float(acc.stats.n) != float(base.stats.n) or not torch.equal(
                acc.class_counts, base.class_counts):
            raise AssertionError(f"[wire] {kind}: n or the class counts moved")
        if kind == "fp32" and not (torch.equal(acc.stats.A, base.stats.A)
                                   and torch.equal(acc.stats.b, base.stats.b)):
            raise AssertionError("[wire] fp32: not bitwise the uncompressed accumulator")
        if kind == "int8":
            # each client's upload errs by at most half its tile's step per entry
            halfA = torch.zeros_like(acc.stats.A)
            halfb = torch.zeros_like(acc.stats.b)
            tile = fmt.tile
            for s_ in range(packed.n_shards):
                for c in range(packed.clients_per_shard):
                    Ak, bk = ops.fed3r_stats(*client_design(torch, packed, s_, c, C))
                    halfA += 0.5 * ref.expand_tiles(ref.quantize_tiles_ref(Ak, tile)[1], tile, d, d)
                    halfb += 0.5 * ref.expand_tiles(ref.quantize_tiles_ref(bk, tile)[1], tile, d, C)
            slackA = STATS_REL * float(base.stats.A.abs().max())
            slackb = STATS_REL * float(base.stats.b.abs().max())
            overA = float(((acc.stats.A - base.stats.A).abs() - halfA).max())
            overb = float(((acc.stats.b - base.stats.b).abs() - halfb).max())
            log(f"[wire] int8: max(|dA| - sum_k s_k/2) {overA:.3e} (limit {STATS_REL:g} x max|A| "
                f"= {slackA:.3e}), max(|db| - sum_k s_k/2) {overb:.3e} (limit {slackb:.3e}); "
                f"sum_k s_k/2 up to {float(halfA.max()):.3e} on A")
            if overA > slackA or overb > slackb:
                raise AssertionError("[wire] int8 is off by more than half a step a client")
            last = client_design(torch, packed, packed.n_shards - 1, packed.clients_per_shard - 1, C)
        out[kind] = {"wall_s": wall, "peak_bytes": peak, "counts": counts, "acc": acc_test,
                     "bytes": nbytes, "err_A": eA}
    # the path's own kernel inputs: the last client's upload into the int8 accumulator
    Ak, bk = ops.fed3r_stats(*last)
    out["case"] = {"A": Ak, "b": bk}
    out["launches"] = out["int8"]["counts"]
    return out


def phase_stream_int8(torch, ops, W32) -> dict:
    """serve_stream's arrivals through StreamingEngine under the int8 wire."""
    from repro_torch.core import fed3r
    from repro_torch.federated import compress
    from repro_torch.federated.arrivals import pack_schedule
    from repro_torch.federated.compress import WireFormat
    from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
    from repro_torch.launch.serve_stream import stream_setup

    d, C = STREAM["d"], STREAM["n_classes"]
    fed, test, schedule = stream_setup(STREAM["n_waves"], STREAM["rate"], 0.0, STREAM["n_clients"],
                                       d, C, STREAM["seed"], torch.device("cuda"))
    timeline = pack_schedule(fed, schedule).to("cuda")
    wire = WireFormat(kind="int8")
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=STREAM["ridge_lambda"],
                                       wire=wire), device="cuda")
    T = timeline.n_waves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    state, _ = eng.absorb(eng.init(d), timeline)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    acc = float(fed3r.accuracy(state.W, test.features, test.labels))
    rel = float((state.W - W32).abs().max() / W32.abs().max())
    # the waves whose plain factorization failed, replayed one at a time
    retried, st = [], eng.init(d)
    for t in range(T):
        x = timeline.inputs[t]
        z, yh, _ = fed3r.masked_design(x.reshape(-1, d), timeline.labels[t].reshape(-1), C,
                                       timeline.mask[t].reshape(-1))
        S, dB = ops.fed3r_stats(z.contiguous(), yh.contiguous())
        G0, _ = ops.chol_gram(st.L, st.L.new_zeros((0, d)), st.b.new_zeros((0, C)))
        G, _ = compress.roundtrip_add(G0, st.b, S, dB, wire)
        if int(torch.linalg.cholesky_ex(G)[1]) != 0:
            retried.append(t)
        st, _ = eng.absorb(st, timeline.slice_waves(t, t + 1))
    same = bool(torch.equal(st.W, state.W))
    log(f"[stream-int8] StreamingEngine(wire=int8, tile {wire.tile}): {T} waves, wall {wall:.3f}s "
        f"({1e3 * wall / T:.2f} ms a wave), peak memory {peak / 2**30:.3f} GiB, launches {counts}; "
        f"final acc {acc:.4f}; max|W - W_fp32|/max|W_fp32| {rel:.3e} (limit 0.5); the guard "
        f"retried on {len(retried)} of {T} waves {retried}; replayed wave by wave, W bitwise: {same}")
    if counts["fed3r_stats"] != T or counts["chol_gram"] != T or \
            counts["quantize_tiles"] != 2 * T or counts["dequant_acc"] != 2 * T:
        raise AssertionError(f"[stream-int8] launched {counts} for {T} waves")
    if not (bool(torch.isfinite(state.L).all()) and bool(torch.isfinite(state.W).all())):
        raise AssertionError("[stream-int8] L or W is not finite")
    if not rel < 0.5 or not same or acc <= 2.0 / C:
        raise AssertionError("[stream-int8] W strays from the fp32 stream's, or is not repeatable")
    return {"wall_s": wall, "peak_bytes": peak, "retried": retried, "acc": acc, "rel": rel}


def phase_uplink(torch, ops, sim) -> dict:
    """UplinkCompressor with and without error feedback: 12 uploads of one
    full-width client."""
    from repro_torch.core import fed3r
    from repro_torch.federated.compress import UplinkCompressor, WireFormat
    from repro_torch.federated.costs import CostModel, stats_wire_bytes
    from repro_torch.federated.telemetry import Telemetry

    fed, d = sim["fed"], sim["d"]
    C = fed.n_classes
    cd = fed.client(0)
    s = fed3r.client_stats(torch.as_tensor(cd.features, device="cuda"),
                           torch.as_tensor(cd.labels, device="cuda"), C)
    step = float(ops.quantize_tiles(s.A.contiguous())[1].max())
    res = {}
    for ef in (True, False):
        up = UplinkCompressor(WireFormat(kind="int8", error_feedback=ef),
                              cost_model=CostModel(b=2.22e6, d=d, C=C), telemetry=Telemetry())
        tot, exact = fed3r.init_stats(d, C, "cuda"), fed3r.init_stats(d, C, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(UPLINK_ROUNDS):
            tot = fed3r.merge(tot, up.upload(0, s))
            exact = fed3r.merge(exact, s)
        torch.cuda.synchronize()
        res[ef] = {"err": float((tot.A - exact.A).abs().max()), "ratio": up.compression_ratio,
                   "ms": 1e3 * (time.perf_counter() - t0) / UPLINK_ROUNDS,
                   "drift": up.telemetry.gauge("wire_cost_model_drift", kind="int8", inst=0).value,
                   "scale": float(exact.A.abs().max())}
    want_ratio = stats_wire_bytes(d, C, "fp32") / stats_wire_bytes(d, C, "int8")
    slack = STATS_REL * res[True]["scale"]
    log(f"[uplink] {UPLINK_ROUNDS} int8 uploads of client 0 (n={len(cd.labels)}, d={d}, C={C}): "
        f"max|sum A_hat - sum A| with error feedback {res[True]['err']:.4e} (limit one step "
        f"{step:.4e} + {slack:.3e}), without {res[False]['err']:.4e}; compression ratio "
        f"{res[True]['ratio']:.6f} (stats_wire_bytes: {want_ratio:.6f}), cost-model drift "
        f"{res[True]['drift']:.3f}; {res[True]['ms']:.3f} ms an upload")
    if not (res[True]["err"] <= step + slack and res[True]["err"] < res[False]["err"]):
        raise AssertionError("[uplink] error feedback does not telescope")
    if res[True]["ratio"] != want_ratio or res[True]["drift"] != 1.0:
        raise AssertionError("[uplink] the priced ratio disagrees with stats_wire_bytes")
    return res


def phase_secure(torch, ops, sim) -> dict:
    """A 10-client cohort quantized against shared scales, masked mod 2^32
    on the card, summed and recovered after dropout, bitwise."""
    from repro_torch.core import fed3r
    from repro_torch.federated import compress, secure_agg

    fed = sim["fed"]
    C = fed.n_classes
    cohort = list(range(SECURE_CLIENTS))
    stats = [fed3r.client_stats(torch.as_tensor(fed.client(k).features, device="cuda"),
                                torch.as_tensor(fed.client(k).labels, device="cuda"), C)
             for k in cohort]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads, sA, sb = compress.cohort_quantize_int8(stats)
    masked = [secure_agg.mask_quantized_payload(p, k, cohort, seed=2024)
              for k, p in zip(cohort, payloads)]
    agg = secure_agg.secure_aggregate_quantized(masked)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def int_sum(ps):
        return [sum(p[i].to(torch.int64) for p in ps) for i in range(2)]

    plain = int_sum(payloads)
    on_card = all(t.device.type == "cuda" for m in masked for t in m)
    hidden = min(float((m.qA != p.qA).float().mean()) for m, p in zip(masked, payloads))
    exact_sum = torch.equal(agg.qA.to(torch.int64), plain[0]) and torch.equal(
        agg.qb.to(torch.int64), plain[1])
    survivors = [k for k in cohort if k not in SECURE_DROPPED]
    rec = secure_agg.recover_survivor_sum_quantized(
        secure_agg.secure_aggregate_quantized([masked[k] for k in survivors]), survivors,
        list(SECURE_DROPPED), seed=2024)
    want = int_sum([payloads[k] for k in survivors])
    exact_rec = torch.equal(rec.qA.to(torch.int64), want[0]) and torch.equal(
        rec.qb.to(torch.int64), want[1])
    A_sum, _ = compress.dequantize_int_sum(agg, sA, sb)
    exact = fed3r.merge(*stats)
    rel = max_rel_err(A_sum, exact.A)
    probe_a = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32, device="cuda")
    probe_b = torch.tensor([1, -1], dtype=torch.int32, device="cuda")
    want_wrap = [-(2**31), 2**31 - 1]
    ring = secure_agg.ring_add(probe_a, probe_b).tolist()
    native = (probe_a + probe_b).tolist()
    log(f"[secure] {SECURE_CLIENTS} clients x (d={sim['d']}, C={C}) int32 payloads, masks on the "
        f"card: {on_card}, each upload masked on >= {hidden:.4f} of its entries; quantize + mask + "
        f"sum {wall:.3f}s; masked sum bitwise the plain integer sum: {exact_sum}; {len(SECURE_DROPPED)}"
        f" dropped {list(SECURE_DROPPED)}: recovered survivors' sum bitwise: {exact_rec}; "
        f"dequantized sum vs fp32 sum max|dA|/max|A| {rel:.3e}; int32 wrap probe on the card: "
        f"ring_add {ring}, native + {native} (want {want_wrap})")
    if not (on_card and hidden > 0.99 and exact_sum and exact_rec and ring == want_wrap
            and rel < 0.02):
        raise AssertionError("[secure] masked aggregation is not exact on the card")
    return {"wall_s": wall, "rel": rel}


_CARD = []


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them (read once)."""
    if not _CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        _CARD.append(smi.stdout.strip().splitlines()[0])
    return _CARD[0]


def no_sync(torch, fn, *args, **kw):
    """Run fn with every host sync an error (the card idle first)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _async_engine(torch, **kw):
    from repro_torch.federated.async_engine import AsyncConfig, AsyncRoundEngine

    base = dict(n_classes=STREAM["n_classes"], ridge_lambda=STREAM["ridge_lambda"],
                cohort=ASYNC_COHORT, deadline=1.0, staleness_rounds=3, early_close=False,
                demote_after=10_000)
    base.update(kw)
    return AsyncRoundEngine(AsyncConfig(**base), device="cuda")


def phase_async(torch, ops) -> dict:
    """serve_stream(engine="async") at the stream's set-up, the chaos replay
    at d 1280 under every fault type, the wires' folds under sync-debug
    "error", and secure dropout recovery."""
    from repro_torch.core import fed3r
    from repro_torch.data.pipeline import PackedClients, pack_client_shards
    from repro_torch.federated import compress, secure_agg
    from repro_torch.federated.arrivals import (
        ChaosSpec, UploadEvent, chaos_timeline, latency_profile, pack_schedule)
    from repro_torch.federated.async_engine import run_chaos_timeline
    from repro_torch.federated.compress import WireFormat
    from repro_torch.federated.engine import AccumulationEngine, EngineConfig, shard_stats
    from repro_torch.federated.fed3r_driver import PACK_ROUND_TO
    from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
    from repro_torch.launch.serve_stream import serve_stream, stream_setup

    d, C, lam = STREAM["d"], STREAM["n_classes"], STREAM["ridge_lambda"]
    totals = {k: 0 for k in read_counts(ops)}

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    # serve_stream(engine="async"): 24 chaos rounds of ~4 clients, live bursts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    res = serve_stream(engine="async", verbose=False, device="cuda", **STREAM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    add(counts)
    peak = torch.cuda.max_memory_allocated()
    rep = res["chaos"]
    log(f"[async] serve_stream engine=async: {STREAM['n_waves']} rounds of ~{ASYNC_COHORT} "
        f"clients, live acc per segment {[round(a, 4) for a in res['acc_served']]}, final "
        f"{res['acc_final']:.4f}; folded {rep['folded']}, late {rep['late_folds']}, duplicates "
        f"{rep['duplicates']}, stale {rep['stale_rejected']}, dropped {rep['dropped_uploads']}, "
        f"demoted {rep['demoted']}; {res['dispatches']} dispatches; wall {wall:.3f}s, peak memory "
        f"{peak / 2**30:.3f} GiB ({card()}); launches {counts}")
    if counts["fed3r_stats"] != STREAM["n_clients"] or sum(counts.values()) != STREAM["n_clients"]:
        raise AssertionError(f"[async] serve_stream launched {counts}")
    if rep["dropped_uploads"] or rep["stale_rejected"] or len(res["folded"]) != (
            rep["folded"] + rep["late_folds"]) or rep["duplicates"] == 0:
        raise AssertionError(f"[async] the chaos counters are off: {rep}")
    # the drained W against a float64 closed form over the uploads that folded
    fed, _, _ = stream_setup(STREAM["n_waves"], STREAM["rate"], 0.0, STREAM["n_clients"], d, C,
                             STREAM["seed"], torch.device("cuda"))
    mult = {}
    for _, c in res["folded"]:
        mult[c] = mult.get(c, 0) + 1
    A64 = lam * torch.eye(d, dtype=torch.float64, device="cuda")
    b64 = torch.zeros((d, C), dtype=torch.float64, device="cuda")
    parts = []
    for c, m in sorted(mult.items()):
        cd = fed.client(c)
        z = torch.as_tensor(cd.features, device="cuda").double()
        y = torch.nn.functional.one_hot(torch.as_tensor(cd.labels, device="cuda").long(), C)
        A64 += m * (z.T @ z)
        b64 += m * (z.T @ y.double())
        for _ in range(m):
            parts.append(fed3r.client_stats(z.float(), y.argmax(1), C))
    W64 = torch.linalg.solve(A64, b64)
    W64 = W64 / W64.norm(dim=0, keepdim=True).clamp_min(1e-12)
    W32 = fed3r.solve(fed3r.merge(*parts), lam)
    e_async = float((res["W"].double() - W64).abs().max())
    e_batch = float((W32.double() - W64).abs().max())
    log(f"[async] {len(res['folded'])} uploads folded ({len(mult)} clients): max|W_async - W_f64| "
        f"{e_async:.3e}  max|W_batch32 - W_f64| {e_batch:.3e}  (limit 2 x batch + 1e-5 = "
        f"{2 * e_batch + 1e-5:.3e})")
    if not e_async <= 2 * e_batch + 1e-5:
        raise AssertionError("[async] the async W is further from float64 than the fp32 batch W")

    # the chaos replay at d 1280: the first clients' uploads, computed once
    payloads = {k: shard_stats(torch.as_tensor(fed.client(k).features, device="cuda"),
                               torch.as_tensor(fed.client(k).labels, device="cuda"), C)
                for k in range(ASYNC_CHAOS_CLIENTS)}
    cohorts = [sorted(np.random.default_rng((0, r)).choice(
        ASYNC_CHAOS_CLIENTS, size=ASYNC_COHORT, replace=False).tolist())
        for r in range(ASYNC_CHAOS_ROUNDS)]
    latency = latency_profile(ASYNC_CHAOS_CLIENTS, 0.2, straggler_factor=3.0, base=0.3,
                              jitter=0.5, seed=1)

    def replay(fault, wire, synchronous):
        eng = _async_engine(torch, synchronous=synchronous, wire=wire)
        events = chaos_timeline(cohorts, latency, ChaosSpec(**ASYNC_FAULTS[fault]))
        state = eng.init(d)
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        if synchronous:
            state, rep = run_chaos_timeline(eng, state, cohorts, events,
                                            lambda c, r: payloads[c])
        else:  # deliver, close_round and drain never wait for the card
            state, rep = no_sync(torch, run_chaos_timeline, eng, state, cohorts, events,
                                 lambda c, r: payloads[c])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        add(counts)
        return state, rep, counts, wall

    chaos, W_all = {}, None
    for fault in sorted(ASYNC_FAULTS):
        sa, ra, ca, wa = replay(fault, WireFormat(), False)
        ss, rs, cs, ws = replay(fault, WireFormat(), True)
        same = bool(torch.equal(sa.W, ss.W) and torch.equal(sa.L, ss.L))
        log(f"[async] chaos {fault}: {ASYNC_CHAOS_ROUNDS} rounds x {ASYNC_COHORT} of "
            f"{ASYNC_CHAOS_CLIENTS} clients, d {d}: async (no host sync) folded {ra['folded']} late "
            f"{ra['late_folds']} duplicates {ra['duplicates']} dropped {ra['dropped_uploads']}, "
            f"makespan {ra['makespan']:.3f} vs sync {rs['makespan']:.3f} (sim time); W and L "
            f"bitwise the synchronous barrier's: {same}; wall async {wa:.3f}s, sync {ws:.3f}s")
        if not same or ra["dropped_uploads"] or (fault in ("duplicate", "all")
                                                 and ra["duplicates"] == 0):
            raise AssertionError(f"[async] chaos {fault}: async is not the synchronous barrier")
        if sum(ca.values()) or sum(cs.values()):
            raise AssertionError(f"[async] chaos {fault}: fp32 launched {ca} / {cs}")
        chaos[fault] = {"async_s": wa, "sync_s": ws}
        W_all = sa.W if fault == "all" else W_all
    wire = WireFormat(kind="int8")
    sa, ra, ca, wa = replay("all", wire, False)
    ss, rs, cs, ws = replay("all", wire, True)
    same = bool(torch.equal(sa.W, ss.W) and torch.equal(sa.L, ss.L))
    want_a = 2 * (ra["folded"] + ra["late_folds"])
    want_s = 2 * (rs["folded"] + rs["late_folds"])
    log(f"[async] chaos all under the int8 wire (tile {wire.tile}): async (no host sync) "
        f"launches {ca}, sync {cs} (want quantize_tiles = dequant_acc = 2 an upload folded: "
        f"{want_a}, {want_s}); W bitwise the synchronous barrier's: {same}; max|W_int8 - W_fp32| "
        f"{float((sa.W - W_all).abs().max()):.3e}; wall async "
        f"{wa:.3f}s, sync {ws:.3f}s")
    if not same or ca["quantize_tiles"] != want_a or ca["dequant_acc"] != want_a or \
            cs["quantize_tiles"] != want_s or cs["dequant_acc"] != want_s or ca["fed3r_stats"]:
        raise AssertionError("[async] the int8 replay is off")
    if not bool(torch.isfinite(sa.W).all()):
        raise AssertionError("[async] the int8 W is not finite")

    # the compressed wires' folds under sync-debug "error": the fp8 and int8
    # client folds, the fp8 and int8 streams' absorb
    clients = [(fed.client(k).features, fed.client(k).labels) for k in range(ASYNC_CHAOS_CLIENTS)]
    host = pack_client_shards(clients, 5, client_ids=list(range(len(clients))),
                              round_to=PACK_ROUND_TO)
    packed = PackedClients(*(torch.as_tensor(np.asarray(a), device="cuda") for a in host))
    _, _, schedule = stream_setup(STREAM["n_waves"], STREAM["rate"], 0.0, STREAM["n_clients"], d,
                                  C, STREAM["seed"], torch.device("cuda"))
    timeline = pack_schedule(fed, schedule).to("cuda")
    folds = {}
    for kind in ("fp8", "int8"):
        eng = AccumulationEngine(EngineConfig(n_classes=C, wire=WireFormat(kind=kind)),
                                 device="cuda")
        acc = no_sync(torch, eng.accumulate, eng.init(d), packed)
        seng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=lam,
                                            wire=WireFormat(kind=kind)), device="cuda")
        st, _ = no_sync(torch, seng.absorb, seng.init(d), timeline)
        ok = all(bool(torch.isfinite(t).all()) for t in (acc.stats.A, st.L, st.W))
        folds[kind] = ok
        if not ok:
            raise AssertionError(f"[async] the {kind} fold or stream is not finite")
    log(f"[async] under sync-debug mode 'error', no host sync: AccumulationEngine fold of "
        f"{len(clients)} clients and StreamingEngine absorb of {timeline.n_waves} waves under fp8 "
        f"and int8 (finite: {folds})")

    # secure mode: 10 clients masked mod 2^32, 2 drop out
    cohort = list(range(SECURE_CLIENTS))
    survivors = [c for c in cohort if c not in SECURE_DROPPED]
    q, sA, sb = compress.cohort_quantize_int8([payloads[c] for c in cohort])
    masked = {c: secure_agg.mask_quantized_payload(q[i], c, cohort, 2024)
              for i, c in enumerate(cohort)}

    def secure_round(ids, uploads):
        eng = _async_engine(torch, cohort=len(ids), staleness_rounds=0, secure=True,
                            secure_seed=2024)
        state = eng.init(d)
        eng.begin_round(0, ids, 0.0, scales=(sA, sb))
        for i, c in enumerate(survivors):
            state, status = eng.deliver(state, UploadEvent(0.1 * i, 0, c, 0), uploads[c])
            if status != "folded":
                raise AssertionError(f"[async] secure upload of {c}: {status}")
        return eng.close_round(state, 0, now=1.0), eng.report()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_drop, rep_drop = secure_round(cohort, masked)
    torch.cuda.synchronize()
    wall_secure = time.perf_counter() - t0
    s_base, _ = secure_round(survivors, {c: q[c] for c in survivors})
    same = bool(torch.equal(s_drop.W, s_base.W) and torch.equal(s_drop.L, s_base.L))
    log(f"[async] secure: {SECURE_CLIENTS} clients masked mod 2^32, {len(SECURE_DROPPED)} dropped "
        f"{list(SECURE_DROPPED)} (dropped_uploads {rep_drop['dropped_uploads']}): retired W and L "
        f"bitwise the survivor-only unmasked round's: {same}; W finite: "
        f"{bool(torch.isfinite(s_drop.W).all())}; round with mask recovery {wall_secure:.3f}s")
    if not same or rep_drop["dropped_uploads"] != len(SECURE_DROPPED) or not bool(
            torch.isfinite(s_drop.W).all()):
        raise AssertionError("[async] secure dropout recovery is not bitwise")
    return {"wall_s": wall, "peak_bytes": peak, "launches": totals, "chaos": chaos}


def phase_tiers(torch, ops) -> dict:
    """An edge/region/cloud tree through StreamingEngine.tiered_absorber at
    d 1280: blocking and overlapped bitwise, fp32 bitwise the flat sum."""
    from repro_torch.federated.compress import WireFormat
    from repro_torch.federated.engine import shard_stats
    from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
    from repro_torch.federated.telemetry import Telemetry
    from repro_torch.federated.tiers import AggregationTree, TierSpec

    d, C, lam = STREAM["d"], STREAM["n_classes"], STREAM["ridge_lambda"]
    N, S = TIERS["rows"], TIERS["segments"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TIERS["seed"])
    segs = []
    for _ in range(S):
        leaves = 4 * 2 * 2
        # features on a 1/8 grid in [-2, 2]: every fp32 partial sum of A is exact
        x = torch.randint(-16, 17, (leaves, N, d), generator=gen, device="cuda").float() / 8.0
        y = torch.randint(0, C, (leaves, N), generator=gen, device="cuda")
        n = torch.randint(N // 2, N + 1, (leaves, 1), generator=gen, device="cuda")
        m = (torch.arange(N, device="cuda")[None, :] < n).float()
        segs.append((x, y, m))

    def tree(top_wire):
        return AggregationTree((TierSpec("edge", fan_in=4), TierSpec("region", fan_in=2),
                                TierSpec("cloud", fan_in=2, wire=top_wire, staleness=1)))

    totals = {k: 0 for k in read_counts(ops)}
    out = {}

    def run(kind, overlap):
        t = tree(WireFormat(kind=kind))
        eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=lam), device="cuda")
        tel = Telemetry()
        ab = eng.tiered_absorber(t, overlap=overlap, telemetry=tel)
        ab.reset(d)
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        for seg in segs:
            if overlap:  # the overlapped absorb never waits for the card
                no_sync(torch, ab.absorb_segment, *seg)
            else:
                ab.absorb_segment(*seg)
        state = ab.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        for k, v in counts.items():
            totals[k] += v
        gauges = {g["name"]: g["value"] for g in tel.snapshot()["gauges"]}
        quant = 2 * 2 * S if kind == "int8" else 0  # A and b of 2 children a segment
        want = {k: v for k, v in (("fed3r_stats", t.leaves * S), ("chol_gram", S),
                                  ("quantize_tiles", quant), ("dequant_acc", quant)) if v}
        log(f"[tiers] {kind} tree edge 4 / region 2 / cloud 2 ({kind}, staleness 1), {t.leaves} "
            f"leaves x {N} rows, d {d}, {S} segments, {'overlapped' if overlap else 'blocking'}: "
            f"wall {wall:.3f}s ({1e3 * wall / S:.2f} ms a segment; {card()}), launches {counts}, "
            f"tier_overlap_efficiency {gauges.get('tier_overlap_efficiency')}")
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"[tiers] {kind} launched {counts}, want {want}")
        if gauges.get("tier_overlap_efficiency") != (1.0 if overlap else 0.0):
            raise AssertionError(f"[tiers] overlap efficiency {gauges}")
        if not bool(torch.isfinite(state.W).all()):
            raise AssertionError(f"[tiers] {kind}: W is not finite")
        out[(kind, overlap)] = {"wall_s": wall, "W": state.W, "L": state.L}
        return state

    for kind in ("fp32", "int8"):
        blocking, overlapped = run(kind, False), run(kind, True)
        same = bool(torch.equal(blocking.W, overlapped.W) and torch.equal(blocking.L, overlapped.L))
        log(f"[tiers] {kind}: blocking and overlapped W and L bitwise: {same}")
        if not same:
            raise AssertionError(f"[tiers] {kind}: blocking and overlapped differ")
    # the planted fault: the blocking form's one sync a segment is caught
    ab = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=lam), device="cuda"
                         ).tiered_absorber(tree(WireFormat()), overlap=False)
    ab.reset(d)
    try:
        no_sync(torch, ab.absorb_segment, *segs[0])
        caught = ""
    except RuntimeError as err:
        caught = str(err).splitlines()[0]
    log(f"[tiers] a blocking absorb_segment under sync-debug mode 'error' raises: {caught!r}")
    if "synchroniz" not in caught:
        raise AssertionError("[tiers] the sync gate did not see the blocking form's sync")
    # the flat sum: one shard_stats of each segment's rows, absorb_stats
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=lam), device="cuda")
    st = eng.init(d)
    for x, y, m in segs:
        s = shard_stats(x.reshape(-1, d), y.reshape(-1), C, m.reshape(-1))
        st = eng.absorb_stats(st, s.A, s.b, s.n)
    fp32 = out[("fp32", True)]
    flat = bool(torch.equal(st.W, fp32["W"]) and torch.equal(st.L, fp32["L"]))
    rel = float((out[("int8", True)]["W"] - st.W).abs().max() / st.W.abs().max())
    log(f"[tiers] fp32 tree W and L bitwise the flat absorb_stats of shard_stats: {flat}; int8 "
        f"cloud tier max|W - W_fp32|/max|W_fp32| {rel:.3e} (limit 0.5)")
    if not flat or not rel < 0.5:
        raise AssertionError("[tiers] the fp32 tree is not the flat sum, or int8 strays")
    return {"launches": totals, "walls": {f"{k} {'overlapped' if o else 'blocking'}": v["wall_s"]
                                          for (k, o), v in out.items()}}


# ---------------------------------------------------------------------------
# [dist]: the psum backend on the one card
# ---------------------------------------------------------------------------


def _digest(*tensors) -> str:
    """sha256 of the tensors' bits (equal bits across ranks: equal digests)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _gated(torch, gate, fn, *args, **kw):
    """fn with every host sync an error when gate (the NCCL run), else plain."""
    return no_sync(torch, fn, *args, **kw) if gate else fn(*args, **kw)


def _timed(torch, ops, fn):
    """(result, wall seconds, launch counts) of fn, the card idle around it."""
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts(ops)


def dist_paths(rank: int, world: int, dev, sync_gate: bool = False) -> dict:
    """[dist]'s paths on one rank of an initialized world, every engine under
    DistConfig(aggregation="psum", mesh=make_host_mesh()): launch/train.py
    phase 1 at full width; one full-width FT round; the stream at d 1280 under
    the fp32 and int8 wires; the statistics engine on the simulator's 100
    clients; a sharded 32-tenant head solve; the async ring under a mesh
    tree.  The last three are held against their merge engines here.  With
    sync_gate (the NCCL run) accumulate, absorb, RoundEngine.step, deliver and
    close_round run with every host sync an error, after one run that warms
    the communicators.  Returns walls, launch counts, digests, and on rank 0
    the tensors the parent compares (on the CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.simulator import simulator_setup
    from repro_torch.core.fed3r import Fed3RFactored
    from repro_torch.data.pipeline import PackedClients, pack_client_shards, pack_personal_cohort
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.federated.arrivals import UploadEvent, pack_schedule
    from repro_torch.federated.async_engine import AsyncConfig, AsyncRoundEngine
    from repro_torch.federated.compress import WireFormat
    from repro_torch.federated.dist import DistConfig
    from repro_torch.federated.engine import AccumulationEngine, EngineConfig, shard_stats
    from repro_torch.federated.fed3r_driver import PACK_ROUND_TO
    from repro_torch.federated.personalization import PersonalizationEngine, PersonalizeConfig
    from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
    from repro_torch.federated.tiers import mesh_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import data_parallel_size, make_host_mesh, make_tier_host_mesh
    from repro_torch.launch.serve_stream import stream_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(device_type="cuda")
    psum = DistConfig(aggregation="psum", mesh=mesh)
    dp = data_parallel_size(mesh)
    lead = rank == 0
    out = {"walls": {}, "launches": {}, "digests": {}}

    def keep(name, wall, counts, **digests):
        out["walls"][name] = wall
        out["launches"][name] = counts
        out["digests"].update({f"{name} {k}": v for k, v in digests.items()})

    # launch/train.py phase 1 at the slice's full width
    torch.cuda.reset_peak_memory_stats()
    p1, wall, counts = _timed(torch, ops, lambda: train.run(
        SLICE_ARCH, device=dev, mesh=mesh, verbose=False, **SLICE))
    keep("phase 1", wall, counts, A=_digest(p1["stats"].A), b=_digest(p1["stats"].b),
         W=_digest(p1["W"]))
    out["phase 1"] = {"acc": p1["fed3r_acc"], "n_slots": p1["n_slots"],
                      **({"A": p1["stats"].A.cpu(), "b": p1["stats"].b.cpu(), "W": p1["W"].cpu()}
                         if lead else {})}
    params0 = p1["params0"]
    del p1

    # one full-width FT round (FT, FedAvg), [ft]'s round: the cohort's 10
    # clients padded to a multiple of the ranks, each rank its block
    cfg = get_config(SLICE_ARCH)
    n_classes = SLICE["n_classes"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ds = make_token_dataset(gen, SLICE["n_samples"], SLICE["seq_len"], cfg.vocab_size, n_classes)
    clients = train.FtClients(ds, SLICE["n_clients"], SLICE["clients_per_round"], FT_LOCAL_BATCH)
    engine = train.ft_engine(cfg, params0, n_clients=SLICE["n_clients"], ft_strategy="full",
                             mesh=mesh)
    gen.manual_seed(2)
    head = {"W": 0.01 * torch.randn((cfg.d_feat, n_classes), generator=gen, device=dev),
            "b": torch.zeros((n_classes,), device=dev)}
    s0 = engine.init({"backbone": params0, "head": head})
    cohort = clients.cohort(0, mesh).to(dev)
    s1 = engine.step(s0, cohort)  # warm: the first backward's set-up, the communicators
    torch.cuda.reset_peak_memory_stats()
    s1b, wall, counts = _timed(torch, ops, lambda: _gated(torch, sync_gate, engine.step, s0, cohort))
    keep("ft round", wall, counts, theta=_digest(*_leaves(s1b.params)))
    out["ft round"] = {"cohort": cohort.cohort, "repeat_bitwise": _bitwise(s1b.params, s1.params),
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       **({"theta": _to(s1b.params, "cpu")} if lead else {})}
    del engine, s0, s1, s1b, cohort, clients, ds, params0
    torch.cuda.empty_cache()

    # the stream at d 1280, fp32 and int8 wires; the wave width padded to
    # a multiple of the ranks, each rank its block of every wave
    d, C, lam = STREAM["d"], STREAM["n_classes"], STREAM["ridge_lambda"]
    fed, test, schedule = stream_setup(STREAM["n_waves"], STREAM["rate"], 0.0,
                                       STREAM["n_clients"], d, C, STREAM["seed"], dev)
    width = -(-max(len(w) for w in schedule) // dp) * dp
    timeline = pack_schedule(fed, schedule, clients_per_wave=width).to(dev)
    out["stream"] = {"waves": timeline.n_waves, "width": width}
    for kind in ("fp32", "int8"):
        eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=lam, dist=psum,
                                           wire=WireFormat(kind=kind)), device=dev)
        if sync_gate:
            eng.absorb(eng.init(d), timeline)
        (st, _), wall, counts = _timed(torch, ops, lambda: _gated(
            torch, sync_gate, eng.absorb, eng.init(d), timeline))
        keep(f"stream {kind}", wall, counts, W=_digest(st.W), L=_digest(st.L))
        out["stream"][kind] = {"W": st.W.cpu(), "L": st.L.cpu()} if lead else {}
        if kind == "fp32":
            state = st
    del timeline

    # the statistics engine on the simulator's 100 clients, the packed
    # arrays on the card first; psum against merge on this rank
    sfed, _, _, sfc = simulator_setup(dev)
    sclients = [(sfed.client(k).features, sfed.client(k).labels) for k in range(sfc.n_clients)]
    packed = pack_client_shards(sclients, sfc.clients_per_round,
                                client_ids=list(range(sfc.n_clients)), round_to=PACK_ROUND_TO,
                                mesh=mesh)
    packed = PackedClients(*(torch.as_tensor(a, device=dev) for a in packed))
    d_sim, C_sim = packed.inputs.shape[-1], sfed.n_classes
    eng = AccumulationEngine(EngineConfig(n_classes=C_sim, dist=psum), device=dev)
    if sync_gate:
        eng.accumulate(eng.init(d_sim), packed)
    acc, wall, counts = _timed(torch, ops, lambda: _gated(
        torch, sync_gate, eng.accumulate, eng.init(d_sim), packed))
    keep("accumulate", wall, counts, A=_digest(acc.stats.A), b=_digest(acc.stats.b))
    merge = AccumulationEngine(EngineConfig(n_classes=C_sim), device=dev)
    ref, _, mcounts = _timed(torch, ops, lambda: merge.accumulate(merge.init(d_sim), packed))
    out["accumulate"] = {
        "slots": packed.n_slots, "merge_launches": mcounts,
        "bitwise": bool(torch.equal(acc.stats.A, ref.stats.A) and torch.equal(acc.stats.b, ref.stats.b)
                        and torch.equal(acc.class_counts, ref.class_counts)),
        "rel": max(max_rel_err(acc.stats.A, ref.stats.A), max_rel_err(acc.stats.b, ref.stats.b)),
    }
    del packed, sclients, sfed, acc, ref

    # 32 tenants' heads over the fp32 stream's state, the cohort split
    tenants = [(fed.client(k).features, fed.client(k).labels) for k in range(DIST_HEADS)]
    pc = pack_personal_cohort(tenants, mesh=mesh)
    fac = Fed3RFactored(L=state.L, b=state.b)
    eng = PersonalizationEngine(PersonalizeConfig(n_classes=C, alpha_grid=HEADS["alpha_grid"],
                                                  dist=psum), device=dev)
    heads, wall, counts = _timed(torch, ops, lambda: eng.solve_heads(fac, pc))
    keep("heads", wall, counts, W=_digest(heads.W), alpha=_digest(heads.alpha))
    mheads = PersonalizationEngine(PersonalizeConfig(n_classes=C, alpha_grid=HEADS["alpha_grid"]),
                                   device=dev).solve_heads(fac, pc)
    out["heads"] = {"cohort": pc.cohort,
                    "alpha_bitwise": bool(torch.equal(heads.alpha, mheads.alpha)),
                    "W_bitwise": bool(torch.equal(heads.W, mheads.W)),
                    "W_err": float((heads.W - mheads.W).abs().max())}
    del fed, test, schedule, state, fac, heads, mheads

    # the async ring under a mesh tree of the ranks (region x edge on 4,
    # one edge tier on 1): K = 4 clients of grid-exact rows at d 1280
    tmesh = make_tier_host_mesh((2, world // 2) if world > 1 else (1,), device_type="cuda")
    tree = mesh_tree(tmesh)
    K, rows = ASYNC_COHORT, DIST_ASYNC_ROWS
    g = torch.Generator(device=dev)
    g.manual_seed(TIERS["seed"])
    payloads = {c: shard_stats(torch.randint(-16, 17, (rows, d), generator=g, device=dev).float() / 8,
                               torch.randint(0, C, (rows,), generator=g, device=dev), C)
                for c in range(K)}
    order = np.random.default_rng(3).permutation(K)

    def fold(dist_cfg, gate):
        eng = AsyncRoundEngine(AsyncConfig(n_classes=C, ridge_lambda=lam, cohort=K,
                                           dist=dist_cfg), device=dev)
        st = eng.init(d)
        eng.begin_round(0, list(range(K)), 0.0)
        for i, c in enumerate(order):
            st, _ = _gated(torch, gate, eng.deliver, st, UploadEvent(0.1 * i, 0, int(c), 0),
                           payloads[int(c)])
        st = _gated(torch, gate, eng.close_round, st, 0, now=1.0)
        return eng.drain(st)

    routed = DistConfig(aggregation="psum", mesh=tmesh, tree=tree)
    if sync_gate:
        fold(routed, False)
    st, wall, counts = _timed(torch, ops, lambda: fold(routed, sync_gate))
    keep("async", wall, counts, W=_digest(st.W), L=_digest(st.L))
    ref = fold(DistConfig(), False)
    out["async"] = {"tree_axes": tree.axes,
                    "bitwise": bool(torch.equal(st.W, ref.W) and torch.equal(st.L, ref.L))}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _quantize64(torch, x, tile):
    """Per-tile absmax int8 quantization in float64: s = max|tile| / 127 (1
    for an all-zero tile), q = clip(round(x / s), ±127), both (Mt, tile,
    Nt, tile)-shaped over x zero-padded to whole tiles."""
    M, N = x.shape
    xp = torch.nn.functional.pad(x, (0, (-N) % tile, 0, (-M) % tile))
    blocks = xp.reshape(xp.shape[0] // tile, tile, xp.shape[1] // tile, tile)
    s = blocks.abs().amax(dim=(1, 3), keepdim=True) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.round(blocks / s).clamp(-127, 127), s


def _untile(q, M, N):
    """A (Mt, tile, Nt, tile) grid back to (M, N)."""
    return q.reshape(q.shape[0] * q.shape[1], -1)[:M, :N]


def _roundtrip64(torch, x, tile):
    """The int8 wire in float64: q · s back on x's shape."""
    q, s = _quantize64(torch, x, tile)
    return _untile(q * s, *x.shape)


def _rank_design(torch, timeline, t, r, k, C, dtype):
    """Rank r's block (k clients) of wave t as the masked (Z, Y) in dtype."""
    d = timeline.inputs.shape[-1]
    m = torch.as_tensor(timeline.mask[t, r * k:(r + 1) * k], device="cuda").reshape(-1, 1)
    z = torch.as_tensor(timeline.inputs[t, r * k:(r + 1) * k], device="cuda").reshape(-1, d)
    y = torch.nn.functional.one_hot(torch.as_tensor(
        timeline.labels[t, r * k:(r + 1) * k], device="cuda").reshape(-1).long(), C)
    m = m.to(dtype)
    return z.to(dtype) * m, y.to(dtype) * m


def int8_psum_stream64(torch, timeline, world, C, lam, tile, form):
    """The psum stream under the int8 wire, emulated in float64 on the
    timeline the run absorbed (its wave width a multiple of ``world``).
    ``form`` "rank": each rank's (S, ΔB) of its block of the wave
    roundtripped, then summed (the psum wire); "sum": the sum roundtripped
    once; "none": no wire.  G carries λI + the received sums, with the
    engines' guard: on a failed factorization, jitter of 1, 4 or 16 x
    √d · max|S| / 254, the first that factors.  Returns the served W and
    the guard's (wave, multiple) retries."""
    T, P = timeline.mask.shape[:2]
    d, k = timeline.inputs.shape[-1], P // world
    eye = torch.eye(d, dtype=torch.float64, device="cuda")
    G, b = lam * eye, torch.zeros((d, C), dtype=torch.float64, device="cuda")
    retried = []
    for t in range(T):
        S, dB = torch.zeros_like(G), torch.zeros_like(b)
        for r in range(world):
            z, y = _rank_design(torch, timeline, t, r, k, C, torch.float64)
            Sr, dBr = z.T @ z, z.T @ y
            if form == "rank":
                Sr, dBr = _roundtrip64(torch, Sr, tile), _roundtrip64(torch, dBr, tile)
            S, dB = S + Sr, dB + dBr
        if form == "sum":
            S, dB = _roundtrip64(torch, S, tile), _roundtrip64(torch, dB, tile)
        G, b = G + S, b + dB
        if form != "none" and int(torch.linalg.cholesky_ex(G)[1]) != 0:
            bound = math.sqrt(d) * 0.5 * float(S.abs().max()) / 127.0
            for mult in (1.0, 4.0, 16.0):
                if int(torch.linalg.cholesky_ex(G + mult * bound * eye)[1]) == 0:
                    G = G + mult * bound * eye
                    retried.append((t, mult))
                    break
    W = torch.linalg.solve(G, b)
    return W / W.norm(dim=0, keepdim=True).clamp_min(1e-12), retried


def int8_step_flips(torch, ops, timeline, world, C, tile):
    """How many entries of the ranks' (S, ΔB) the fp32 wire (the port's
    fed3r_stats and quantize_tiles, as the engine runs them) puts on
    another int8 step than the float64 emulation, of how many."""
    T, P = timeline.mask.shape[:2]
    k = P // world
    flips = total = 0
    for t in range(T):
        for r in range(world):
            z, y = _rank_design(torch, timeline, t, r, k, C, torch.float32)
            for x32, x64 in zip(ops.fed3r_stats(z.contiguous(), y.contiguous()),
                                (z.double().T @ z.double(), z.double().T @ y.double())):
                q32 = ops.quantize_tiles(x32.contiguous(), tile)[0]
                q64 = _untile(_quantize64(torch, x64, tile)[0], *x64.shape)
                flips += int((q32.double() != q64).sum())
                total += x64.numel()
    return flips, total


def phase_dist(torch, ops, sl, ft, stream) -> dict:
    """The psum backend at world 1 under NCCL in this process (every engine
    bitwise its merge result where the algebra is the same, no host sync),
    then dist_paths on DIST_WORLD gloo ranks sharing this card (NCCL takes
    one card a rank): equal bits on every rank, launch counts, phase 1 and
    the FT round against the one-process runs of [slice] and [ft], the
    stream against its float64 yardstick."""
    from repro_torch.launch.world import run_world, single_rank_world

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with single_rank_world("nccl", "cuda") as dev:
        one = dist_paths(0, 1, dev, sync_gate=True)
    wall1 = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(dist_paths, DIST_WORLD, backend="gloo", device="cuda",
                      timeout_s=DIST_TIMEOUT_S)
    wall4 = time.perf_counter() - t0
    T = one["stream"]["waves"]

    # world 1, NCCL: the one-process results' bits, the same launches
    c1 = one["launches"]
    checks = {
        "phase 1 A, b bitwise [slice]'s": torch.equal(one["phase 1"]["A"], sl["A"])
        and torch.equal(one["phase 1"]["b"], sl["b"]),
        "phase 1 fed3r_stats = [slice]'s": c1["phase 1"]["fed3r_stats"] == sl["launches"],
        "ft round bitwise [ft]'s": _bitwise(one["ft round"]["theta"], ft["theta1"]),
        "ft round launches no kernel": not any(c1["ft round"].values()),
        "accumulate bitwise merge": one["accumulate"]["bitwise"],
        "accumulate launches = merge's": c1["accumulate"] == one["accumulate"]["merge_launches"],
        "heads bitwise merge": one["heads"]["alpha_bitwise"] and one["heads"]["W_bitwise"],
        "heads: one batched_chol_gram": c1["heads"]["batched_chol_gram"] == 1,
        "async under a tree bitwise merge": one["async"]["bitwise"],
        "stream fp32: fed3r_stats and chol_gram a wave": c1["stream fp32"]["fed3r_stats"] == T
        and c1["stream fp32"]["chol_gram"] == T,
        "stream int8: quant pair 2 a wave": c1["stream int8"]["quantize_tiles"] == 2 * T
        and c1["stream int8"]["dequant_acc"] == 2 * T,
    }
    # world 1: the merge stream's W and L within fp32 rounding
    merge_rel = max(max_rel_err(one["stream"]["fp32"]["W"], stream["W"].cpu()),
                    max_rel_err(one["stream"]["fp32"]["L"], stream["L"].cpu()))
    checks["stream fp32 world 1 within DIST_STREAM_REL of [stream]'s merge W, L"] = \
        merge_rel <= DIST_STREAM_REL
    W64, e_batch = stream["W64"], stream["e_batch"]
    from repro_torch.federated.arrivals import pack_schedule
    from repro_torch.federated.compress import WireFormat
    from repro_torch.launch.serve_stream import stream_setup

    d, C, lam = STREAM["d"], STREAM["n_classes"], STREAM["ridge_lambda"]
    tile = WireFormat(kind="int8").tile
    fed, _, schedule = stream_setup(STREAM["n_waves"], STREAM["rate"], 0.0, STREAM["n_clients"],
                                    d, C, STREAM["seed"], torch.device("cuda"))
    errs, rel8 = {}, {}
    for name, world, run in (("world 1", 1, one), (f"world {DIST_WORLD}", DIST_WORLD, ranks[0])):
        errs[name] = float((run["stream"]["fp32"]["W"].cuda().double() - W64).abs().max())
        checks[f"stream fp32 {name} within the float64 gate"] = errs[name] <= 2 * e_batch + 1e-5
        timeline = pack_schedule(fed, schedule, clients_per_wave=run["stream"]["width"])
        W8 = run["stream"]["int8"]["W"].cuda().double()
        rel8[name], retried = {}, {}
        for form in ("rank", "none") if world == 1 else ("rank", "sum", "none"):
            W64f, retried[form] = int8_psum_stream64(torch, timeline, world, C, lam, tile, form)
            rel8[name][form] = max_rel_err(W8, W64f)
        rel8[name]["guard retries"] = retried["rank"]
        rel8[name]["int8 steps apart, of entries"] = int8_step_flips(torch, ops, timeline, world,
                                                                     C, tile)
        checks[f"stream int8 {name} within DIST_INT8_REL of the float64 per-rank wire"] = \
            rel8[name]["rank"] <= DIST_INT8_REL
        checks[f"stream int8 {name}: a roundtripped sum or no wire lands beyond it"] = all(
            rel8[name][f] > DIST_INT8_REL for f in ("sum", "none") if f in rel8[name])

    # world 4, gloo on the card: every rank's bits, the launches split
    lead, c4 = ranks[0], [r["launches"] for r in ranks]
    slots4 = lead["phase 1"]["n_slots"]
    dA = max_rel_err(lead["phase 1"]["A"], sl["A"])
    db = max_rel_err(lead["phase 1"]["b"], sl["b"])
    ft_err, ft_scale = _dtheta_rel(lead["ft round"]["theta"], ft["theta1"], ft["theta0"])
    checks.update({
        "every rank's digests equal": all(r["digests"] == lead["digests"] for r in ranks),
        "phase 1 fed3r_stats summed = client slots": sum(c["phase 1"]["fed3r_stats"] for c in c4)
        == slots4,
        "phase 1 A, b within DIST_STATS_REL of [slice]'s": dA <= DIST_STATS_REL
        and db <= DIST_STATS_REL,
        "phase 1 accuracy equal": lead["phase 1"]["acc"] == sl["acc"],
        "ft round within FT_ROUND_REL of [ft]'s": ft_scale > 0 and ft_err <= FT_ROUND_REL * ft_scale,
        "ft round repeats bitwise": all(r["ft round"]["repeat_bitwise"] for r in ranks),
        "stream: fed3r_stats, chol_gram a wave a rank": all(
            c["stream fp32"]["fed3r_stats"] == T and c["stream fp32"]["chol_gram"] == T for c in c4),
        "stream int8: quant pair 2 a wave a rank": all(
            c["stream int8"]["quantize_tiles"] == 2 * T and c["stream int8"]["dequant_acc"] == 2 * T
            for c in c4),
        "accumulate within STATS_REL of merge": lead["accumulate"]["rel"] <= STATS_REL,
        "accumulate fed3r_stats summed = slots": sum(c["accumulate"]["fed3r_stats"] for c in c4)
        == lead["accumulate"]["slots"],
        "heads alpha bitwise merge, W within 1e-5": lead["heads"]["alpha_bitwise"]
        and lead["heads"]["W_err"] <= 1e-5,
        "heads: one batched_chol_gram a rank": all(c["heads"]["batched_chol_gram"] == 1 for c in c4),
        "async under a 2-tier mesh tree bitwise merge": lead["async"]["bitwise"]
        and lead["async"]["tree_axes"] == ("edge", "region"),
    })
    log(f"[dist] world 1 (NCCL, this process) in {wall1:.1f}s; world {DIST_WORLD} (gloo, "
        f"{DIST_WORLD} processes on the one card) in {wall4:.1f}s; phase 1 over {DIST_WORLD} "
        f"ranks: max|dA|/max|A| {dA:.3e}, max|db|/max|b| {db:.3e} (limit {DIST_STATS_REL:g}), "
        f"acc {lead['phase 1']['acc']:.4f} vs {sl['acc']:.4f}; FT round of {lead['ft round']['cohort']} "
        f"slots, {lead['ft round']['cohort'] // DIST_WORLD} a rank: max|d dtheta|/max|dtheta| "
        f"{ft_err / ft_scale:.4e} (limit {FT_ROUND_REL:g}); stream max|W - W_f64| {errs} "
        f"(limit {2 * e_batch + 1e-5:.3e}); world 1 fp32 vs [stream]'s merge W, L "
        f"{merge_rel:.3e} (limit {DIST_STREAM_REL:g}); int8 max|W - W64|/max|W64| against "
        f"the float64 emulation of each wire form {rel8} (limit {DIST_INT8_REL:g} for 'rank', "
        f"the psum wire; the others must exceed it); "
        f"accumulate vs merge {lead['accumulate']['rel']:.3e}; "
        f"heads max|dW| {lead['heads']['W_err']:.3e}")
    log(f"[dist] walls in s (host clock around each call, ending in torch.cuda.synchronize(); the "
        f"{DIST_WORLD} ranks share one card's SMs and a host-staged gloo wire, so world "
        f"{DIST_WORLD} is not a scale-out number) on {card()}:")
    for name in one["walls"]:
        per_rank = " ".join(f"{r['walls'][name]:.3f}" for r in ranks)
        log(f"[dist]   {name:12s} world 1 {one['walls'][name]:.3f}  world {DIST_WORLD} by rank "
            f"{per_rank}  launches world 1 {c1[name]}  rank 0 of {DIST_WORLD} {c4[0][name]}")
    log(f"[dist] peak memory a rank: world 1 {one['peak_bytes'] / 2**30:.3f} GiB (FT round "
        f"{one['ft round']['peak_bytes'] / 2**30:.3f}); world {DIST_WORLD} "
        + " ".join(f"{r['peak_bytes'] / 2**30:.3f}" for r in ranks) + " GiB (FT round "
        + " ".join(f"{r['ft round']['peak_bytes'] / 2**30:.3f}" for r in ranks) + ")")
    for name, ok in checks.items():
        log(f"[dist] {'ok  ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError(f"[dist] failed: {[n for n, ok in checks.items() if not ok]}")
    launches = {k: 0 for k in c1["phase 1"]}
    for c in [c1] + c4:
        for sub in c.values():
            for k, v in sub.items():
                launches[k] += v
    return {"launches": launches, "wall1_s": wall1, "wall4_s": wall4}


def half_way_matrix(tiles_down, tiles_across, tile, seed):
    """An fp32 matrix whose every entry but one a tile sits exactly half-way
    between two integers of its tile's quantization grid (x/s = k + 1/2, no
    rounding anywhere), so round-half-to-even decides each of them."""
    r = np.random.default_rng(seed)
    inv = np.float32(1.0 / 127.0)
    x = np.empty((tiles_down * tile, tiles_across * tile), np.float32)
    for i in range(tiles_down):
        for j in range(tiles_across):
            while True:  # an absmax whose scale has <= 15 significant bits
                a = np.float32(r.uniform(1.0, 100.0))
                s = np.float32(a * inv)
                if int(s.view(np.uint32)) & 0x1FF == 0:
                    break
            k = r.integers(-127, 127, size=(tile, tile))
            blk = ((k + 0.5) * np.float64(s)).astype(np.float32)
            blk[0, 0] = a
            x[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = blk
    return x


def quant_check(torch, ops, ref, x, acc, tile, label) -> float:
    """Both quantization kernels against their plain versions, bitwise."""
    q, s = ops.quantize_tiles(x, tile=tile)
    out = ops.dequant_accumulate(acc, q, s, tile=tile)
    torch.cuda.synchronize()
    qr, sr = ref.quantize_tiles_ref(x, tile)
    outr = ref.dequant_acc_ref(acc, q, s, tile)
    same = torch.equal(q, qr) and torch.equal(s, sr) and torch.equal(out, outr)
    zero_tiles = int((s == 1.0).sum())
    log(f"[kernel] quantize_tiles + dequant_acc {label} ({x.shape[0]}, {x.shape[1]}) tile {tile}: "
        f"q, scales and fma(q, s, acc) bitwise the plain versions: {same}  (q differs on "
        f"{int((q != qr).sum())}, out on {int((out != outr).sum())}; {zero_tiles} tiles of scale 1)")
    if not same:
        raise AssertionError(f"quantize_tiles / dequant_acc disagree with their plain versions "
                             f"at {label}")
    return float((out - outr).abs().max())


def quant_edges(torch, ref, gen) -> None:
    """quantize_tiles at QUANT_EDGES, every cluster size, x aligned and not:
    q and the scales bitwise the plain version's."""
    from repro_torch.kernels import quant as quant_mod

    for M, N, tile in QUANT_EDGES:
        x0 = torch.randn((M, N), generator=gen, device="cuda") * 10.0
        x0[:tile, :tile] = 0.0
        x0[(-(-M // tile) - 1) * tile:, (-(-N // tile) - 1) * tile:] = 0.0
        for offset in (0, 1):
            flat = torch.zeros(M * N + offset, device="cuda")
            flat[offset:] = x0.reshape(-1)
            x = flat[offset:].view(M, N)
            qr, sr = ref.quantize_tiles_ref(x, tile)
            same = []
            for cluster in quant_mod.CLUSTERS:
                q, s = quant_mod._quantize(x, tile, cluster=cluster)
                same.append(bool(torch.equal(q, qr) and torch.equal(s, sr)))
            log(f"[kernel] quantize_tiles ({M}, {N}) tile {tile}, x {4 * offset} bytes past a "
                f"16-byte boundary: bitwise the plain version at clusters "
                f"{quant_mod.CLUSTERS}: {same}")
            if not all(same):
                raise AssertionError(f"quantize_tiles disagrees with its plain version at "
                                     f"({M}, {N}) tile {tile}")


def phase_kernel_quant(torch, ops, ref, case) -> dict:
    """quantize_tiles and dequant_acc at the uplink's shapes (A 1280 x 1280
    and b 1280 x 100 at tile 128, from the [wire] path), at the RF width
    5000 x 5000, at ragged shapes, on all-zero tiles and on exact half-way
    inputs; times at the path's shapes."""
    from repro_torch.launch.timing import broadcast_addcmul, cuda_ms, device_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(60)
    err = 0.0
    for name in ("A", "b"):
        x = case[name]
        acc = torch.randn(x.shape, generator=gen, device="cuda") * float(x.abs().max())
        err = max(err, quant_check(torch, ops, ref, x, acc, 128, f"[wire] client {name}"))
    for M, N, tile in QUANT_SHAPES:
        x = torch.randn((M, N), generator=gen, device="cuda") * 10.0
        x[:tile, :tile] = 0.0  # an all-zero tile: scale 1, payload 0
        acc = torch.randn((M, N), generator=gen, device="cuda")
        err = max(err, quant_check(torch, ops, ref, x, acc, tile, "random, a zero tile"))
    hx = torch.as_tensor(half_way_matrix(2, 3, 128, seed=61), device="cuda")
    q, s = ops.quantize_tiles(hx)
    ratio = hx.double() / ref.expand_tiles(s, 128, *hx.shape).double()
    tie = (ratio - ratio.floor() - 0.5) == 0.0
    even = bool((q[tie].to(torch.int64) % 2 == 0).all())
    log(f"[kernel] quantize_tiles half-way inputs: {int(tie.sum())} exact ties of "
        f"{hx.numel()} entries, all rounded to even: {even}")
    if not even or int(tie.sum()) != hx.numel() - 6:
        raise AssertionError("quantize_tiles does not round half to even")
    err = max(err, quant_check(torch, ops, ref, hx, torch.zeros_like(hx), 128, "half-way"))
    for ulps in (-2, -1, 1, 2):  # near-ties: the kernel's product by fl(1/s) must defer
        hn = hx
        for _ in range(abs(ulps)):
            hn = torch.nextafter(hn, torch.full_like(hn, math.copysign(math.inf, ulps)))
        quant_check(torch, ops, ref, hn, torch.zeros_like(hn), 128, f"half-way {ulps:+d} ulp")
    quant_edges(torch, ref, gen)

    out = {}
    for name in ("A", "b"):
        x = case[name]
        M, N = x.shape
        tile = 128
        Mt, Nt = -(-M // tile), -(-N // tile)
        acc = torch.randn((M, N), generator=gen, device="cuda")
        q, s = ops.quantize_tiles(x)
        library = broadcast_addcmul(acc, q, s, tile)
        lib_same = bool(torch.equal(library().reshape(M, N), ops.dequant_accumulate(acc, q, s)))
        nb_q, nb_d = 4.0 * M * N + M * N + 4.0 * Mt * Nt, 4.0 * M * N * 2 + M * N + 4.0 * Mt * Nt
        ms_q, plain_q = cuda_ms(lambda: ops.quantize_tiles(x)), cuda_ms(
            lambda: ref.quantize_tiles_ref(x, tile))
        dev_q = device_ms(lambda: ops.quantize_tiles(x))
        bq = bound(6.0 * M * N, nb_q)
        log(f"[kernel] quantize_tiles [wire] {name} ({M}, {N}) tile {tile}: kernel_ms {ms_q:.4f}  "
            f"device_ms {dev_q:.4f}  plain_ms {plain_q:.4f}  library_ms none (no one PyTorch call "
            f"quantizes per tile)  "
            f"bound_ms {bq['bound_ms']:.4f} by {bq['bound_by']} ({nb_q / 1e6:.3f} MB: "
            f"{bq['t_bytes']:.4f} ms; {bq['flops'] / 1e6:.3f} M ops: {bq['t_ops']:.4f} ms) = "
            f"{100 * bq['bound_ms'] / ms_q:.1f}% of the bound")
        td = timed("dequant_acc", f"[wire] {name} ({M}, {N}) tile {tile}",
                   lambda: ops.dequant_accumulate(acc, q, s),
                   lambda: ref.dequant_acc_ref(acc, q, s, tile), library,
                   "library_ms (one torch.addcmul on the kernel's int8 q and tile scales "
                   "through broadcast views)", bound(2.0 * M * N, nb_d))
        log(f"[kernel] dequant_acc [wire] {name}: that torch.addcmul on the card bitwise the "
            f"kernel's one FMA: {lib_same}")
        if not out:
            out = {"quantize_tiles": {"ms": ms_q, "plain_ms": plain_q, "library_ms": None,
                                      "bound_ms": bq["bound_ms"], "bound_by": bq["bound_by"],
                                      "device_ms": dev_q, "library_device_ms": None},
                   "dequant_acc": td}
    M = N = 5000
    x = torch.randn((M, N), generator=gen, device="cuda")
    acc = torch.randn((M, N), generator=gen, device="cuda")
    q, s = ops.quantize_tiles(x)
    b5 = bound(6.0 * M * N, 5.0 * M * N + 4.0 * 40 * 40)
    dev_q5 = device_ms(lambda: ops.quantize_tiles(x))
    log(f"[kernel] quantize_tiles ({M}, {N}) tile 128: kernel_ms "
        f"{cuda_ms(lambda: ops.quantize_tiles(x)):.4f}  device_ms {dev_q5:.4f}  bound_ms "
        f"{b5['bound_ms']:.4f} by {b5['bound_by']} = {100 * b5['bound_ms'] / dev_q5:.1f}% of the "
        f"bound in device_ms")
    timed("dequant_acc", f"({M}, {N}) tile 128", lambda: ops.dequant_accumulate(acc, q, s),
          lambda: ref.dequant_acc_ref(acc, q, s, 128), broadcast_addcmul(acc, q, s, 128),
          "library_ms none (tile 128 does not divide 5000: no one PyTorch call computes it at "
          "this shape)", bound(2.0 * M * N, 9.0 * M * N))
    for entry in out.values():
        entry["max_abs_err"] = err
    return out


def phase_serve(torch, ops) -> dict:
    """launch/serve.py at Qwen2-7B's full width: the main configuration cold
    (the first prefill after emptying the allocator's cache) and warm, then a
    ragged prompt with weights serve draws itself."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    cfg = get_config(SERVE_ARCH)
    log(f"[serve] {SERVE_ARCH}: d_model={cfg.d_model} layers={cfg.n_layers} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype}, "
        f"fp32 weights from seed 0, random prompts")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] weights drawn in {time.perf_counter() - t0:.2f}s")
    out = {}
    for label, kw in (("cold", SERVE_FULL), ("full", SERVE_FULL), ("ragged", SERVE_RAGGED)):
        p = params if label != "ragged" else None
        if p is None:
            del params
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = serve(SERVE_ARCH, verbose=False, device="cuda", seed=0, params=p, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        toks = res.tokens
        step_ms = res.decode_s * 1e3 / (kw["gen"] - 1)
        log(f"[serve] {label} batch {kw['batch']} x prompt {kw['prompt_len']}, gen {kw['gen']}: "
            f"prefill {res.prefill_s * 1e3:.1f} ms  decode {step_ms:.2f} ms a step "
            f"({kw['gen'] - 1} steps, {res.tokens_per_s:.1f} tok/s)  peak memory "
            f"{res.peak_bytes / 2**30:.3f} GiB  wall {wall:.2f}s"
            f"{' (weights drawn inside)' if p is None else ''}  flash_attention launches: "
            f"prefill {res.prefill_launches}, decode {res.decode_launches}  (all counts {counts})")
        log(f"[serve] {label} generated[0]: {toks[0, :16].tolist()}")
        others = {k: v for k, v in counts.items() if k != "flash_attention" and v}
        if res.prefill_launches != cfg.n_layers or res.decode_launches != 0 or others:
            raise AssertionError(f"serve launched {res.prefill_launches} flash_attention kernels "
                                 f"in the prefill, {res.decode_launches} in decode, {others}")
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"flash_attention launched {counts['flash_attention']} times")
        if tuple(toks.shape) != (kw["batch"], kw["gen"]) or not (
                int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"tokens of shape {tuple(toks.shape)} outside [0, vocab)")
        out[label] = {"launches": counts["flash_attention"], "prefill_ms": res.prefill_s * 1e3,
                      "decode_step_ms": step_ms, "tok_s": res.tokens_per_s,
                      "peak_gib": res.peak_bytes / 2**30, "wall_s": wall}
        del res, toks, p
    torch.cuda.empty_cache()
    return out


def _prefill_decode(model, params, toks, S, T, drops=None):
    """Prefill toks[:, :S], then T decode steps fed toks[:, S:S + T]: the
    logits of positions S-1 .. S+T-1, (B, T + 1, V) in fp32 (an MoE
    model's prefill adds its dropped entries to ``drops``)."""
    import torch

    logits, cache = model.prefill(params, {"tokens": toks[:, :S]}, cache_capacity=S + T,
                                  drops=drops)
    got = [logits]
    for i in range(T):
        logits, cache = model.decode_step(params, cache, toks[:, S + i:S + i + 1], S + i)
        got.append(logits)
    return torch.stack(got, dim=1).float()


def _planted(real, fault, n_layers):
    """A stand-in for ops.flash_attention that gets the prefill's attention
    wrong: every query sees only itself ("window 1"), or reads the next KV
    head's keys and values, in every layer or in the middle one only."""
    calls = [0]

    def wrong(q, k, v, *, causal=True, window=None):
        layer = calls[0]
        calls[0] += 1
        if fault == "window 1":
            return real(q, k, v, causal=causal, window=1)
        if fault == "KV heads rolled" or layer == n_layers // 2:
            k, v = (x.roll(1, dims=2).contiguous() for x in (k, v))
        return real(q, k, v, causal=causal, window=window)

    return wrong


def phase_serve_consistency(torch, ops) -> dict:
    """Full width, bf16: prefill + decode against the train forward; decode
    with fp32 weights against a bf16 copy; smoke width fp32 card vs CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    B, S, T = CONSIST["B"], CONSIST["S"], CONSIST["T"]
    torch.cuda.empty_cache()
    params = model.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), generator=gen, device="cuda")
    reset_counts(ops)
    got = _prefill_decode(model, params, toks, S, T)
    ref = model.forward(params, {"tokens": toks}).logits[:, S - 1:S + T].float()
    launches = read_counts(ops)["flash_attention"]
    rel = max_rel_err(got, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    pre_rel = max_rel_err(got[:, 0], ref[:, 0])
    # an argmax can flip only where the reference's top-2 gap is under
    # twice the largest logit gap
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    near = int((gap < 2 * float((got - ref).abs().max())).sum())
    log(f"[serve-consistency] {SERVE_ARCH} bf16, B={B} S={S} T={T}: prefill + {T} decode steps vs "
        f"one train forward over {S + T} tokens (plain attention): max|dlogit|/max|logit| "
        f"{rel:.4e} (prefill position {pre_rel:.4e}; limit {CONSIST_REL:g})  equal argmax "
        f"{agree:.4f} of {got.shape[0] * got.shape[1]} (limit >= {CONSIST_ARGMAX:g}; "
        f"{near} positions with a top-2 gap under twice max|dlogit|, smallest gap "
        f"{float(gap.min()):.4f})  max|logit| {float(ref.abs().max()):.3f}  flash_attention "
        f"launches {launches}")
    if launches != cfg.n_layers:
        raise AssertionError(f"the consistency prefill launched flash_attention {launches} times")
    if not (rel <= CONSIST_REL and agree >= CONSIST_ARGMAX):
        raise AssertionError(f"prefill + decode disagree with the full forward: {rel}, {agree}")
    del got
    # the same run with a fault planted in the prefill's attention
    unseen = []
    for fault in CONSIST_FAULTS:
        real = ops.flash_attention
        ops.flash_attention = _planted(real, fault, cfg.n_layers)
        try:
            bad = _prefill_decode(model, params, toks, S, T)
        finally:
            ops.flash_attention = real
        frel = max_rel_err(bad, ref)
        fagree = float((bad.argmax(-1) == ref.argmax(-1)).float().mean())
        log(f"[serve-consistency] planted fault, prefill {fault}: max|dlogit|/max|logit| "
            f"{frel:.4e} (must exceed {CONSIST_REL:g})  equal argmax {fagree:.4f}")
        if not frel > CONSIST_REL:
            unseen.append(fault)
        del bad
    if unseen:
        raise AssertionError(f"the consistency bound cannot see these prefill faults: {unseen}")
    del ref
    for label, change, fault in CONSIST_VARIANTS:
        _consistency_variant(torch, ops, build_model(cfg.replace(**change)), params, toks, S, T,
                             label, fault)

    # decode's cost of fp32 weights cast at every product, against a bf16
    # copy of the matrices cast once (1-D norm scales and biases stay fp32):
    # the same casts, so the same bits
    Bs, Ss = SERVE_FULL["batch"], SERVE_FULL["prompt_len"]
    n = DECODE_COST_STEPS
    toks = torch.randint(0, cfg.vocab_size, (Bs, Ss + n), generator=gen, device="cuda")
    _, cache = model.prefill(params, {"tokens": toks[:, :Ss]}, cache_capacity=Ss + n)
    lowp = _cast_matrices(params, torch.bfloat16)
    times, outs = {"fp32": [], "bf16": []}, {}
    # each once to warm up, then in turns: fp32, bf16, bf16, fp32
    for label in ("fp32", "bf16", "fp32", "bf16", "bf16", "fp32"):
        p = params if label == "fp32" else lowp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = [model.decode_step(p, cache, toks[:, Ss + i:Ss + i + 1], Ss + i)[0] for i in range(n)]
        torch.cuda.synchronize()
        times[label].append((time.perf_counter() - t0) * 1e3 / n)
        outs[label] = torch.stack(lg)
    same = bool(torch.equal(outs["fp32"], outs["bf16"]))
    # a decode step never waits on the card: no host sync anywhere in it
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, cache, toks[:, Ss:Ss + 1], Ss)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    moved = 4 * model.param_count(params) / 2**30
    fp32_ms, bf16_ms = (" / ".join(f"{t:.2f}" for t in times[k][1:]) for k in ("fp32", "bf16"))
    log(f"[serve-consistency] decode at batch {Bs}, cache {Ss + n}, {n} steps a window, after "
        f"one warm-up window each: fp32 weights cast every product {fp32_ms} ms a step, bf16 "
        f"copy of the matrices {bf16_ms} ms a step; logits bitwise equal {same}  (fp32 weights "
        f"{moved:.2f} GiB); a step under sync-debug 'error': no host sync")
    if not same:
        raise AssertionError("decode with a bf16 copy of the weights changed the logits")
    del lowp, cache, params, outs
    torch.cuda.empty_cache()

    # smoke width, fp32: serve on the card (the fp32 kernel) against the CPU's
    sm = SMOKE_SERVE
    scfg = get_config(sm["arch"]).replace(dtype="float32")
    p_cpu = build_model(scfg).init(seed=0, device="cpu")
    cpu_gen = torch.Generator(device="cpu")
    cpu_gen.manual_seed(8)
    prompts = torch.randint(0, scfg.vocab_size, (sm["B"], sm["S"]), generator=cpu_gen)
    kw = dict(gen=sm["gen"], verbose=False, dtype="float32", prompts=prompts)
    reset_counts(ops)
    card = serve(sm["arch"], device="cuda", params=_to(p_cpu, "cuda"), **kw)
    launches = read_counts(ops)["flash_attention"]
    cpu = serve(sm["arch"], device="cpu", params=p_cpu, **kw)
    srel = max_rel_err(card.logits.cpu().float(), cpu.logits.float())
    same_toks = bool(torch.equal(card.tokens.cpu(), cpu.tokens))
    log(f"[serve-consistency] {sm['arch']} fp32, card vs CPU plain path, B={sm['B']} "
        f"S={sm['S']} gen={sm['gen']}: same greedy tokens {same_toks}  max|dlogit|/max|logit| "
        f"{srel:.3e} (limit {sm['rel']:g})  flash_attention launches {launches}")
    if not same_toks or srel > sm["rel"] or launches != scfg.n_layers:
        raise AssertionError("the smoke-width fp32 serving path on the card disagrees with the CPU")
    return {"rel": rel, "agree": agree, "smoke_rel": srel}


def phase_serve_moe(torch, ops) -> dict:
    """launch/serve.py at DeepSeekMoE 16B's full width and depth: the main
    configuration cold (the first prefill after emptying the allocator's
    cache) and warm, with the prefill's drop share."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    cfg = get_config(MOE_ARCH)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[serve-moe] {MOE_ARCH}: d_model={cfg.d_model} layers={cfg.n_layers} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} experts={cfg.n_experts} top_k={cfg.top_k} "
        f"shared={cfg.n_shared_experts} d_expert={cfg.d_expert} capacity_factor="
        f"{cfg.capacity_factor} vocab={cfg.vocab_size} dtype={cfg.dtype}, fp32 weights from seed "
        f"0, random prompts; {held:.3f} GiB held by earlier phases")
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = build_model(cfg).param_count(params)
    log(f"[serve-moe] {n_params:,} parameters ({4 * n_params / 2**30:.3f} GiB fp32) drawn in "
        f"{time.perf_counter() - t0:.2f}s")
    if len(params["layers"]) != 28 or cfg.d_model != 2048 or cfg.n_experts != 64:
        raise AssertionError("serve-moe is not at DeepSeekMoE 16B's full width and depth")
    out = {}
    for label in ("cold", "full"):
        if label == "cold":
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = serve(MOE_ARCH, verbose=False, device="cuda", seed=0, params=params, **MOE_SERVE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        kw = MOE_SERVE
        toks = res.tokens
        step_ms = res.decode_s * 1e3 / (kw["gen"] - 1)
        log(f"[serve-moe] {label} batch {kw['batch']} x prompt {kw['prompt_len']}, gen "
            f"{kw['gen']}: prefill {res.prefill_s * 1e3:.1f} ms  decode {step_ms:.2f} ms a step "
            f"({kw['gen'] - 1} steps, {res.tokens_per_s:.1f} tok/s)  peak memory "
            f"{res.peak_bytes / 2**30:.3f} GiB  prefill drop share {res.prefill_drop_share:.6f} "
            f"of {kw['batch'] * kw['prompt_len'] * cfg.top_k * cfg.n_layers:,} (token, choice) "
            f"entries  wall {wall:.2f}s  flash_attention launches: prefill "
            f"{res.prefill_launches}, decode {res.decode_launches}  (all counts {counts})")
        log(f"[serve-moe] {label} generated[0]: {toks[0, :16].tolist()}")
        others = {k: v for k, v in counts.items() if k != "flash_attention" and v}
        if res.prefill_launches != cfg.n_layers or res.decode_launches != 0 or others:
            raise AssertionError(f"serve-moe launched {res.prefill_launches} flash_attention "
                                 f"kernels in the prefill, {res.decode_launches} in decode, "
                                 f"{others}")
        if tuple(toks.shape) != (kw["batch"], kw["gen"]) or not (
                int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"tokens of shape {tuple(toks.shape)} outside [0, vocab)")
        if not (0.0 <= res.prefill_drop_share < 1.0) or not bool(torch.isfinite(res.logits).all()):
            raise AssertionError(f"drop share {res.prefill_drop_share}, or logits not finite")
        out[label] = {"launches": counts["flash_attention"], "prefill_ms": res.prefill_s * 1e3,
                      "decode_step_ms": step_ms, "tok_s": res.tokens_per_s,
                      "peak_gib": res.peak_bytes / 2**30, "drop_share": res.prefill_drop_share,
                      "wall_s": wall}
        del res, toks
    out["params"] = params
    return out


def _first_choice_rolled(real, n_experts):
    """A stand-in for moe.route_top_k that sends every token's first choice
    to the next expert."""
    def wrong(probs, k):
        top_p, idx = real(probs, k)
        idx = idx.clone()
        idx[:, 0] = (idx[:, 0] + 1) % n_experts
        return top_p, idx

    return wrong


def phase_serve_moe_consistency(torch, ops, params) -> dict:
    """Full width, capacity factor E / top_k, in bf16 and in fp32: prefill +
    decode against the train forward, the planted routing fault outside the
    bounds; a bf16 decode step with no host sync; then one layer's moe_apply
    in fp32 against the dense oracle."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    base = get_config(MOE_ARCH)
    cfg = base.replace(capacity_factor=base.n_experts / base.top_k)
    B, S, T = CONSIST["B"], CONSIST["S"], CONSIST["T"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), generator=gen, device="cuda")
    out = {}
    for dtype, (rel_limit, argmax_limit) in MOE_CONSIST.items():
        model = build_model(cfg.replace(dtype=dtype))
        torch.cuda.empty_cache()
        reset_counts(ops)
        drops = moe_mod.DropTally()
        got = _prefill_decode(model, params, toks, S, T, drops)
        with torch.no_grad():
            ref = model.forward(params, {"tokens": toks}, drops=drops).logits
        ref = ref[:, S - 1:S + T].float()
        launches = read_counts(ops)["flash_attention"]
        dropped = int(drops.dropped)
        rel = max_rel_err(got, ref)
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        pre_rel = max_rel_err(got[:, 0], ref[:, 0])
        # an argmax can flip only where the reference's top-2 gap is under
        # twice the largest logit gap
        top2 = ref.topk(2, dim=-1).values
        near = int((top2[..., 0] - top2[..., 1] < 2 * float((got - ref).abs().max())).sum())
        del got
        real = moe_mod.route_top_k
        moe_mod.route_top_k = _first_choice_rolled(real, cfg.n_experts)
        try:
            bad = _prefill_decode(model, params, toks, S, T)
        finally:
            moe_mod.route_top_k = real
        frel = max_rel_err(bad, ref)
        fagree = float((bad.argmax(-1) == ref.argmax(-1)).float().mean())
        del bad
        log(f"[serve-moe-consistency] {MOE_ARCH} {dtype}, capacity factor "
            f"{cfg.capacity_factor:.4f} (E/top_k), B={B} S={S} T={T}: prefill + {T} decode "
            f"steps vs one train forward over {S + T} tokens (plain attention): "
            f"max|dlogit|/max|logit| {rel:.4e} (prefill position {pre_rel:.4e}; limit "
            f"{rel_limit:g})  equal argmax {agree:.4f} of {ref.shape[0] * ref.shape[1]} (limit >= "
            f"{argmax_limit:g}; {near} positions with a top-2 gap under twice max|dlogit|)  "
            f"max|logit| {float(ref.abs().max()):.3f}  entries dropped {dropped} of "
            f"{drops.routed:,}  flash_attention launches {launches}; planted fault, every "
            f"token's first expert rolled by one: {frel:.4e} (must exceed {rel_limit:g})  equal "
            f"argmax {fagree:.4f}")
        del ref
        if launches != cfg.n_layers:
            raise AssertionError(f"the consistency prefill launched flash_attention {launches} "
                                 f"times")
        if dropped != 0:
            raise AssertionError(f"{dropped} entries dropped at capacity factor E / top_k")
        if not (rel <= rel_limit and agree >= argmax_limit):
            raise AssertionError(f"MoE prefill + decode disagree with the full forward in "
                                 f"{dtype}: {rel}, {agree}")
        if not frel > rel_limit:
            raise AssertionError(f"the {dtype} MoE consistency bound cannot see a rolled first "
                                 f"expert: {frel}")
        out[dtype] = {"rel": rel, "agree": agree, "fault_rel": frel}
    model = build_model(cfg)

    # a full-width decode step never waits on the card
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, cache_capacity=S + T)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, cache, toks[:, S:S + 1], S)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del cache
    log("[serve-moe-consistency] a full-width MoE decode step under sync-debug 'error': no host "
        "sync")

    # one layer against the dense oracle, fp32, no drops
    layer = {k: v for k, v in params["layers"][0]["moe"].items() if k != "shared"}
    ocfg = cfg.replace(dtype="float32", n_shared_experts=0)
    x = 0.3 * torch.randn((1, MOE_ORACLE_TOKENS, cfg.d_model), generator=gen, device="cuda")
    drops = moe_mod.DropTally()
    y, _ = moe_mod.moe_apply(ocfg, layer, x, drops)
    xf = x[0]
    probs = torch.softmax(xf @ layer["router"], -1)
    top_p, top_idx = moe_mod.route_top_k(probs, cfg.top_k)
    g = F.silu(torch.einsum("td,edf->tef", xf, layer["w_gate"]))
    u = torch.einsum("td,edf->tef", xf, layer["w_up"])
    all_out = torch.einsum("tef,efd->ted", g * u, layer["w_down"])
    del g, u
    want = torch.zeros_like(xf)
    rows = torch.arange(xf.shape[0], device="cuda")
    for kk in range(cfg.top_k):
        want += all_out[rows, top_idx[:, kk]] * top_p[:, kk, None]
    del all_out
    diff = (y[0] - want).abs()
    worst = float((diff - MOE_ORACLE_TOL * want.abs()).max())
    log(f"[serve-moe-consistency] layer 0 moe_apply fp32 over {MOE_ORACLE_TOKENS} tokens vs the "
        f"dense oracle (every expert on every token, weighted by the top {cfg.top_k}): "
        f"max|dy| {float(diff.max()):.3e} of max|y| {float(want.abs().max()):.3e}, "
        f"max(|dy| - rtol*|y|) {worst:.3e} (rtol = atol = {MOE_ORACLE_TOL:g})  entries dropped "
        f"{int(drops.dropped)}")
    if not worst <= MOE_ORACLE_TOL or int(drops.dropped) != 0:
        raise AssertionError("moe_apply disagrees with the dense oracle at full width")
    return out


def _int8_scales_rolled(real):
    """A stand-in for attention.dequantize_kv that reads an int8 cache with
    the next KV head's scales."""
    import torch

    def wrong(cache, name, dtype):
        if cache[name].dtype != torch.int8:
            return real(cache, name, dtype)
        return (cache[name].to(torch.float32) * cache[name + "_scale"].roll(1, dims=2)).to(dtype)

    return wrong


def _consistency_variant(torch, ops, model, params, toks, S, T, label, fault):
    """Prefill + decode of a variant of the configuration against its own
    train forward, within its bound; then with a planted fault, outside it."""
    from repro_torch.models import attention

    n_layers = model.cfg.n_layers
    bound = CONSIST_VARIANT_REL[label]
    reset_counts(ops)
    got = _prefill_decode(model, params, toks, S, T)
    launches = read_counts(ops)["flash_attention"]
    ref = model.forward(params, {"tokens": toks}).logits[:, S - 1:S + T].float()
    rel = max_rel_err(got, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    del got
    if fault == "window 1":
        real = ops.flash_attention
        ops.flash_attention = _planted(real, fault, n_layers)
        try:
            bad = _prefill_decode(model, params, toks, S, T)
        finally:
            ops.flash_attention = real
    else:
        real = attention.dequantize_kv
        attention.dequantize_kv = _int8_scales_rolled(real)
        try:
            bad = _prefill_decode(model, params, toks, S, T)
        finally:
            attention.dequantize_kv = real
    frel = max_rel_err(bad, ref)
    fagree = float((bad.argmax(-1) == ref.argmax(-1)).float().mean())
    del bad, ref
    log(f"[serve-consistency] {SERVE_ARCH}.replace({label}) bf16, B={toks.shape[0]} S={S} T={T}: "
        f"prefill + {T} decode steps vs its own train forward: max|dlogit|/max|logit| {rel:.4e} "
        f"(limit {bound:g})  equal argmax {agree:.4f}  flash_attention launches {launches}; "
        f"planted fault, {fault}: {frel:.4e} (must exceed {bound:g})  equal argmax {fagree:.4f}")
    if launches != n_layers:
        raise AssertionError(f"the {label} prefill launched flash_attention {launches} times")
    if not rel <= bound:
        raise AssertionError(f"{label}: prefill + decode disagree with the full forward: {rel}")
    if not frel > bound:
        raise AssertionError(f"{label}: the bound cannot see the planted fault {fault}: {frel}")
    return {"rel": rel, "agree": agree, "fault_rel": frel}


def _cast_matrices(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_matrices(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_matrices(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dim() >= 2 else tree


def _family_batch(torch, cfg, B, S, gen) -> dict:
    """Random tokens (B, S) and, for a VLM, 0.1·N(0, 1) patch embeddings."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")}
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = 0.1 * torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                                                  device="cuda")
    return batch


def phase_serve_family(torch, ops, family) -> dict:
    """launch/serve.py at the SSM, hybrid or VLM config's full width and
    depth: the main configuration cold (the first prefill after emptying the
    allocator's cache) and warm; then a decode step with no host sync."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    arch, kw, flash = FAMILY_SERVE[family]
    tag = f"[serve-{family}]"
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    kinds = cfg.pattern_for(cfg.n_layers)
    shape = {
        "ssm": f"d_inner={cfg.d_inner} ssm heads={cfg.ssm_nheads}x{cfg.ssm_headdim} "
               f"state={cfg.ssm_state} chunk={cfg.ssm_chunk}",
        "hybrid": f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
                  f"lru_width={cfg.lru_width} local_window={cfg.local_window}",
        "vlm": f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
               f"n_patches={cfg.n_patches} mrope={cfg.mrope_sections}",
    }[family]
    log(f"{tag} {arch}: d_model={cfg.d_model} layers={cfg.n_layers} "
        f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}) {shape} "
        f"vocab={cfg.vocab_size} dtype={cfg.dtype}, fp32 weights from seed 0, random prompts; "
        f"{held:.3f} GiB held by earlier phases")
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    log(f"{tag} {n_params:,} parameters ({4 * n_params / 2**30:.3f} GiB fp32) drawn in "
        f"{time.perf_counter() - t0:.2f}s")
    if len(params["layers"]) != cfg.n_layers or kinds.count("attn") != flash:
        raise AssertionError(f"{tag} is not at {arch}'s full depth")
    out = {}
    for label in ("cold", "full"):
        if label == "cold":
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = serve(arch, verbose=False, device="cuda", seed=0, params=params, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        toks = res.tokens
        step_ms = res.decode_s * 1e3 / (kw["gen"] - 1)
        patches = f"{cfg.n_patches} patches + " if family == "vlm" else ""
        log(f"{tag} {label} batch {kw['batch']} x prompt {patches}{kw['prompt_len']}, gen "
            f"{kw['gen']}: prefill {res.prefill_s * 1e3:.1f} ms  decode {step_ms:.2f} ms a step "
            f"({kw['gen'] - 1} steps, {res.tokens_per_s:.1f} tok/s)  peak memory "
            f"{res.peak_bytes / 2**30:.3f} GiB  wall {wall:.2f}s  flash_attention launches: "
            f"prefill {res.prefill_launches}, decode {res.decode_launches}  (all counts {counts})")
        log(f"{tag} {label} generated[0]: {toks[0, :16].tolist()}")
        others = {k: v for k, v in counts.items() if k != "flash_attention" and v}
        if (res.prefill_launches != flash or res.decode_launches != 0 or others
                or counts["flash_attention"] != flash):
            raise AssertionError(f"{tag} launched {res.prefill_launches} flash_attention kernels "
                                 f"in the prefill (not {flash}), {res.decode_launches} in "
                                 f"decode, {others}")
        if tuple(toks.shape) != (kw["batch"], kw["gen"]) or not (
                int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"tokens of shape {tuple(toks.shape)} outside [0, vocab)")
        if not bool(torch.isfinite(res.logits).all()):
            raise AssertionError(f"{tag} logits not finite")
        out[label] = {"launches": counts["flash_attention"], "prefill_ms": res.prefill_s * 1e3,
                      "decode_step_ms": step_ms, "tok_s": res.tokens_per_s,
                      "peak_gib": res.peak_bytes / 2**30, "wall_s": wall}
        del res, toks
    # a full-width decode step never waits on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    off = cfg.n_patches if family == "vlm" else 0
    batch = _family_batch(torch, cfg, kw["batch"], 64, gen)
    _, cache = model.prefill(params, batch, cache_capacity=off + 64 + 1)
    tok = batch["tokens"][:, -1:]
    no_sync(torch, model.decode_step, params, cache, tok, off + 64)
    del cache
    log(f"{tag} a full-width decode step under sync-debug 'error': no host sync")
    out["params"] = params
    return out


def _family_prefill_decode(model, params, batch, S, T, off):
    """Prefill the first S tokens (after a VLM's patches), then T decode
    steps fed tokens S .. S+T-1 at positions off + S + i: the logits of text
    positions S-1 .. S+T-1, (B, T + 1, V) in fp32."""
    import torch

    toks = batch["tokens"]
    logits, cache = model.prefill(params, dict(batch, tokens=toks[:, :S]),
                                  cache_capacity=off + S + T)
    got = [logits]
    for i in range(T):
        logits, cache = model.decode_step(params, cache, toks[:, S + i:S + i + 1], off + S + i)
        got.append(logits)
    return torch.stack(got, dim=1).float()


def _family_fault(family):
    """(module, attribute, stand-in) for the family's planted fault."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm as ssm_mod

    if family == "ssm":
        return ssm_mod, "_state_step", lambda state, dA, dBx: state.add_(dBx)
    if family == "hybrid":
        real = ops.flash_attention
        return ops, "flash_attention", lambda q, k, v, *, causal=True, window=None: real(
            q, k, v, causal=causal, window=None)
    real = model_lib.vlm_positions_3d

    def wrong(cfg, seq_idx):  # a text token's three streams at its flat index
        import torch

        return torch.where(seq_idx >= cfg.n_patches, seq_idx, real(cfg, seq_idx))

    return model_lib, "vlm_positions_3d", wrong


def phase_family_consistency(torch, ops, family, params) -> dict:
    """Full width, in bf16 and in fp32: prefill + decode against the train
    forward within the bounds, the planted fault outside them; one layer in
    fp32 against a float64 oracle."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    arch, _, flash = FAMILY_SERVE[family]
    tag = f"[{family}-consistency]"
    base = get_config(arch)
    B, S, T = (FAMILY_CONSIST[family][k] for k in ("B", "S", "T"))
    off = base.n_patches if family == "vlm" else 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    n = S + T if family != "ssm" else -(-(S + T) // base.ssm_chunk) * base.ssm_chunk
    batch = _family_batch(torch, base, B, n, gen)
    module, name, wrong = _family_fault(family)
    out = {}
    for dtype, (rel_limit, argmax_limit) in FAMILY_CONSIST_LIMITS[family].items():
        model = build_model(base.replace(dtype=dtype))
        torch.cuda.empty_cache()
        reset_counts(ops)
        # the real vocabulary: mamba2's 50,280 pad to 50,304 columns of -1e30
        V = base.vocab_size
        got = _family_prefill_decode(model, params, batch, S, T, off)[..., :V]
        launches = read_counts(ops)["flash_attention"]
        with torch.no_grad():
            ref = model.forward(params, batch).logits[:, off + S - 1:off + S + T, :V].float()
        rel = max_rel_err(got, ref)
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        pre_rel = max_rel_err(got[:, 0], ref[:, 0])
        # an argmax can flip only where the reference's top-2 gap is under
        # twice the largest logit gap
        top2 = ref.topk(2, dim=-1).values
        near = int((top2[..., 0] - top2[..., 1] < 2 * float((got - ref).abs().max())).sum())
        del got
        real = getattr(module, name)
        setattr(module, name, wrong)
        try:
            bad = _family_prefill_decode(model, params, batch, S, T, off)[..., :V]
        finally:
            setattr(module, name, real)
        frel = max_rel_err(bad, ref)
        fagree = float((bad.argmax(-1) == ref.argmax(-1)).float().mean())
        del bad
        log(f"{tag} {arch} {dtype}, B={B} S={S}{f' (after {off} patches)' if off else ''} T={T}: "
            f"prefill + {T} decode steps vs one train forward over {off + n} positions: "
            f"max|dlogit|/max|logit| {rel:.4e} (prefill position {pre_rel:.4e}; limit "
            f"{rel_limit:g})  equal argmax {agree:.4f} of {ref.shape[0] * ref.shape[1]} (limit >= "
            f"{argmax_limit:g}; {near} positions with a top-2 gap under twice max|dlogit|)  "
            f"max|logit| {float(ref.abs().max()):.3f}  flash_attention launches {launches}; "
            f"planted fault, {FAMILY_FAULTS[family]}: {frel:.4e} (must exceed {rel_limit:g})  "
            f"equal argmax {fagree:.4f}")
        del ref
        if launches != flash:
            raise AssertionError(f"the {family} consistency prefill launched flash_attention "
                                 f"{launches} times, not {flash}")
        if not (rel <= rel_limit and agree >= argmax_limit):
            raise AssertionError(f"{family} prefill + decode disagree with the full forward in "
                                 f"{dtype}: {rel}, {agree}")
        if not frel > rel_limit:
            raise AssertionError(f"the {dtype} {family} consistency bound cannot see the planted "
                                 f"fault ({FAMILY_FAULTS[family]}): {frel}")
        out[dtype] = {"rel": rel, "agree": agree, "fault_rel": frel}
    torch.cuda.empty_cache()
    out["oracle"] = family_oracle(torch, family, base, params, gen)
    return out


def family_oracle(torch, family, cfg, params, gen) -> float:
    """One layer in fp32 at full width against a float64 oracle written
    apart from the port's algorithm; raises outside FAMILY_ORACLE's limit."""
    import torch.nn.functional as F
    from repro_torch.models import attention, layers, rglru, ssm
    from repro_torch.models import model as model_lib
    from repro_torch.tree import tree_map

    n, limit = FAMILY_ORACLE[family]
    cfg = cfg.replace(dtype="float32")
    x = 0.5 * torch.randn((1, n, cfg.d_model), generator=gen, device="cuda")
    x64 = x.double()
    if family == "ssm":
        p = params["layers"][0]["ssm"]
        y, _ = ssm.ssm_apply(cfg, p, x)
        p = tree_map(lambda t: t.double(), p)
        H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        zxbcdt = x64[0] @ p["in_proj"]
        z, xBC, dtr = ssm._split_zxbcdt(cfg, zxbcdt)
        xBC = F.silu(layers.causal_conv1d_apply(p["conv"], xBC[None])[0])
        xs, Bm, Cm = ssm._split_xbc(cfg, xBC)
        dt = F.softplus(dtr + p["dt_bias"])  # (n, H)
        A = -torch.exp(p["A_log"])
        h = torch.zeros((H, P, N), dtype=torch.float64, device="cuda")
        ys = []
        for t in range(n):  # the recurrence, a step at a time (ngroups = 1)
            xt = xs[t].reshape(H, P)
            h = (h * torch.exp(dt[t] * A)[:, None, None]
                 + (dt[t][:, None] * xt)[:, :, None] * Bm[t][None, None, :])
            ys.append((h @ Cm[t]) + xt * p["D"][:, None])
        yy = torch.stack(ys).reshape(n, H * P) * F.silu(z)
        yy = yy * torch.rsqrt(yy.square().mean(-1, keepdim=True) + 1e-6) * p["norm_scale"]
        want = (yy @ p["out_proj"])[None]
        what = "layer 0's ssm_apply (the chunked SSD scan)"
    elif family == "hybrid":
        p = params["layers"][0]["rec"]
        y, _ = rglru.rglru_apply(cfg, p, x)
        p = tree_map(lambda t: t.double(), p)
        gate = F.gelu(x64[0] @ p["proj_gate"], approximate="tanh")
        m = layers.causal_conv1d_apply(p["conv"], (x64[0] @ p["proj_main"])[None])[0]
        r = torch.sigmoid(m @ p["w_a"] + p["b_a"])
        i = torch.sigmoid(m @ p["w_x"] + p["b_x"])
        a = torch.exp(-8.0 * F.softplus(p["lambda"]) * r)
        b = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * i * m
        h = torch.zeros(cfg.lru_width, dtype=torch.float64, device="cuda")
        hs = []
        for t in range(n):  # the recurrence, a step at a time
            h = a[t] * h + b[t]
            hs.append(h)
        want = ((torch.stack(hs) * gate) @ p["proj_out"])[None]
        what = "layer 0's rglru_apply (the doubling scan)"
    else:
        p = params["layers"][0]["attn"]
        seq = torch.arange(n, device="cuda")  # the patch grid, then text
        angles = model_lib._angles_for(cfg, seq)
        y, _ = attention.attn_apply(cfg, p, x, angles=angles, build_cache=True, cache_capacity=n)
        p = tree_map(lambda t: t.double(), p)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = torch.einsum("sd,dhk->shk", x64[0], p["wq"]) + p["bq"]
        k = torch.einsum("sd,dhk->shk", x64[0], p["wk"]) + p["bk"]
        v = torch.einsum("sd,dhk->shk", x64[0], p["wv"]) + p["bv"]
        # the three streams' positions, and each rotary pair's stream
        g = int(round(cfg.n_patches ** 0.5))
        img = seq < cfg.n_patches
        streams = torch.stack([torch.where(img, 0, seq - cfg.n_patches + g),
                               torch.where(img, seq // g, seq - cfg.n_patches + g),
                               torch.where(img, seq % g, seq - cfg.n_patches + g)]).double()
        owner = torch.repeat_interleave(torch.arange(3, device="cuda"),
                                        torch.tensor(cfg.mrope_sections, device="cuda"))
        inv = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device="cuda") / hd)
        ang = streams[owner].T * inv  # (n, hd/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

        def rot(t):
            t1, t2 = t[..., :hd // 2], t[..., hd // 2:]
            return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], -1)

        q, k = rot(q), rot(k)
        k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        s = torch.einsum("qhk,shk->hqs", q, k) / math.sqrt(hd)
        s = s.masked_fill(torch.ones((n, n), dtype=torch.bool, device="cuda").triu(1), -math.inf)
        o = torch.einsum("hqs,shk->qhk", torch.softmax(s, -1), v)
        want = (o.reshape(n, H * hd) @ p["wo"].reshape(H * hd, -1))[None]
        what = "layer 0's attn_apply prefill (the fp32 flash kernel, M-RoPE over the patch grid)"
    rel = float((y.double() - want).abs().max() / want.abs().max())
    log(f"[{family}-consistency] {what} over {n} tokens in fp32 vs a float64 oracle: "
        f"max|dy|/max|y| {rel:.3e} (limit {limit:g})")
    if not rel <= limit:
        raise AssertionError(f"{family}: one layer disagrees with its float64 oracle: {rel}")
    return rel


def flash_bound(B, S, H, KV, hd, window, elem_bytes, peak) -> dict:
    """4·hd FLOPs a (query, key) pair the causal (and window) mask keeps, a
    head; q, k, v read and o written once."""
    pairs = sum(min(q + 1, window) if window else q + 1 for q in range(S))
    flops = 4.0 * B * H * hd * pairs
    nbytes = elem_bytes * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return bound(flops, nbytes, peak)


def bf16_row_ulps(o, exact):
    """Each row's max|o - exact| in bf16 ulps of that row's max|exact|."""
    import torch

    top = exact.abs().amax(-1).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)  # bf16 keeps 8 significant bits
    return (o.float() - exact).abs().amax(-1) / ulp


def _attend(torch, q, k, v, q_pos, k_pos, p_dtype=None):
    """Causal softmax attention in fp32 of queries at q_pos over keys at
    k_pos (GQA); with p_dtype, p is rounded to it for the normaliser and
    the value product alike."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd ** -0.5
    s = s.masked_fill(k_pos[None, :] > q_pos[:, None], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()) / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, H, hd)


def flash_faults(torch, q, k, v, exact):
    """The bf16 ulps reading of two faults a bf16 kernel could make, each
    emulated in plain PyTorch on the kernel's inputs (causal, no window):
    key tile 0 skipped for the last query tile (a loop that starts one tile
    late), and p rounded once for both l and the value product (over the
    first 256 rows, where it weighs most)."""
    S = q.shape[1]
    dev = q.device
    q0 = (S - 1) // 64 * 64
    skip = _attend(torch, q[:, q0:], k[:, 64:], v[:, 64:], torch.arange(q0, S, device=dev),
                   torch.arange(64, S, device=dev))
    n = min(S, 256)
    pos = torch.arange(n, device=dev)
    once = _attend(torch, q[:, :n], k[:, :n], v[:, :n], pos, pos, p_dtype=q.dtype)
    return (float(bf16_row_ulps(skip.to(q.dtype), exact[:, q0:]).max()),
            float(bf16_row_ulps(once.to(q.dtype), exact[:, :n]).max()))


def flash_lse(torch, fa_mod, q, k, v, window):
    """The kernel's row log-sum-exp (through the module's private launch)
    against an fp32 logsumexp of the scaled, masked scores, and the same
    reading for p rounded to q's type before the row sum (emulated)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    lse = torch.empty((B, H, S), device=q.device)
    fa_mod._launch(q, k, v, True, window, lse)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float().reshape(B, S, KV, H // KV, hd),
                     k.float()) * hd ** -0.5
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] <= pos[:, None]
    if window:
        valid &= pos[None, :] > pos[:, None] - window
    s.masked_fill_(~valid, -1e30)
    m = s.amax(-1, keepdim=True)
    p = s.sub_(m).exp_()
    m = m.squeeze(-1)
    want = (m + torch.log(p.sum(-1))).reshape(B, H, S)
    once = (m + torch.log(p.to(q.dtype).sum(-1, dtype=torch.float32))).reshape(B, H, S)
    del s, p
    return float((lse - want).abs().max()), float((once - want).abs().max())


def flash_timed(torch, F, ops, ref, q, k, v, window, label) -> dict:
    """Kernel, plain-version and SDPA times (bf16, causal, the window) with
    the bound; SDPA takes a window as a boolean mask of the kept keys."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_label = "library_ms (F.scaled_dot_product_attention, is_causal, enable_gqa)"
    else:
        pos = torch.arange(S, device=q.device)
        keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, enable_gqa=True)
        lib_label = ("library_ms (F.scaled_dot_product_attention, the window as attn_mask, "
                     "enable_gqa)")
    return timed("flash_attention",
                 f"{label} shape {(B, S, H, KV, hd)} bf16 causal window {window}",
                 lambda: ops.flash_attention(q, k, v, window=window),
                 lambda: ref.flash_attention_ref(q, k, v, window=window), library, lib_label,
                 flash_bound(B, S, H, KV, hd, window, 2, BF16_FLOPS))


def phase_kernel_flash(torch, ops, ref) -> dict:
    """flash_attention against its plain version at every shape, window and
    type, its bf16 row log-sum-exp against fp32; kernel, plain and SDPA times
    at the shapes and windows FLASH_TIMED names (bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(50)
    abs_err, out = 0.0, {}
    for shape in FLASH_SHAPES:
        B, S, H, KV, hd = shape
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
            k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
            v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
            for window in FLASH_WINDOWS.get(shape, (None, 128)):
                o = ops.flash_attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                want = ref.flash_attention_ref(q, k, v, causal=True, window=window).float()
                diff = (o.float() - want).abs()
                tol = FLASH_TOL[dtype]
                worst = float((diff - tol * want.abs()).max())
                err = float(diff.max())
                abs_err = max(abs_err, err)
                del want, diff
                tight = ""
                if dtype == "bfloat16":
                    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                                    window=window)
                    ulps = float(bf16_row_ulps(o, exact).max())
                    tight = f"; vs the plain version in fp32 {ulps:.3f} bf16 ulps of the row's max"
                    if window is None:
                        skip, once = flash_faults(torch, q, k, v, exact)
                        tight += (f" (planted: key tile 0 skipped for the last query tile "
                                  f"{skip:.1f}, p rounded once for l and p.v {once:.3f})")
                    del exact
                    lse_err, lse_once = flash_lse(torch, fa_mod, q, k, v, window)
                    tight += (f"; row lse vs fp32 {lse_err:.3e} (limit {FLASH_LSE_LIMIT:g}; "
                              f"emulated p rounded before the row sum {lse_once:.3e})")
                log(f"[kernel] flash_attention {shape} {dtype} window {window}: "
                    f"max|do| {err:.3e}, max(|do| - tol*|o|) {worst:.3e} (tol {tol:g}){tight}  "
                    f"repeatable {bool(torch.equal(o, ops.flash_attention(q, k, v, window=window)))}")
                if not worst <= tol or not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"flash_attention disagrees with its plain version at "
                                         f"{shape} {dtype} window {window}")
                if dtype == "bfloat16" and not ulps <= FLASH_BF16_ULPS:
                    raise AssertionError(f"bf16 flash_attention {ulps} ulps from the fp32 plain "
                                         f"version at {shape} window {window}")
                if dtype == "bfloat16" and window is None and not skip > FLASH_BF16_ULPS:
                    raise AssertionError(f"the bf16 limit cannot see a skipped key tile at "
                                         f"{shape}: {skip} ulps")
                if dtype == "bfloat16" and not lse_err <= FLASH_LSE_LIMIT:
                    raise AssertionError(f"bf16 flash_attention's row lse {lse_err} from fp32 at "
                                         f"{shape} window {window}")
                if dtype == "bfloat16" and not lse_once > FLASH_LSE_LIMIT:
                    raise AssertionError(f"the lse limit cannot see p rounded before the row sum "
                                         f"at {shape} window {window}: {lse_once}")
                del o
                label = FLASH_TIMED.get((shape, window))
                if label is not None and dtype == "bfloat16":
                    out[label] = flash_timed(torch, F, ops, ref, q, k, v, window, label)
            del q, k, v
            torch.cuda.empty_cache()
    return {"max_abs_err": abs_err, **out["serve"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.simulator import RF_D
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
    ft = phase_ft(torch, ops, sim)
    rf = phase_rf(torch, ops, ref, sim)
    stream = phase_stream(torch, ops)
    packed = stream["arrival"]["packed"]
    srf = phase_stream_rf(torch, ops, ref, packed, rf["params"])
    phase_stream_slots(torch, ops, stream["arrival"]["W"])
    heads = phase_heads(torch, ops)
    wire = phase_wire(torch, ops, ref, sim)
    phase_stream_int8(torch, ops, stream["arrival"]["W"])
    phase_uplink(torch, ops, sim)
    phase_secure(torch, ops, sim)
    asy = phase_async(torch, ops)
    tiers = phase_tiers(torch, ops)
    dist = phase_dist(torch, ops, sl, ft, stream["arrival"])
    del ft
    srv = phase_serve(torch, ops)
    phase_serve_consistency(torch, ops)
    moe = phase_serve_moe(torch, ops)
    phase_serve_moe_consistency(torch, ops, moe.pop("params"))
    torch.cuda.empty_cache()
    fams = {}
    for family in FAMILY_SERVE:
        fams[family] = phase_serve_family(torch, ops, family)
        phase_family_consistency(torch, ops, family, fams[family].pop("params"))
        torch.cuda.empty_cache()
    t_phases = time.perf_counter() - t_all
    gates = phase_heads_gates(torch, heads["lru strict"])

    kern = phase_kernel(torch, ops, ref, (sl["max_n"], sl["d"], sl["C"]),
                        (sim["max_n"], sim["d"], sim["C"]), (sim["max_n"], RF_D, sim["C"]))
    z, y = wave_design(torch, packed, widest_wave(packed), STREAM["n_classes"])
    kern_rff = phase_kernel_rff(torch, ops, ref, rf["shard"], z, rf["params"].omega,
                                rf["params"].beta)
    kern_chol = phase_kernel_chol(torch, ops, ref, (stream["arrival"]["L"], z, y), srf["case"])
    kern_batched = phase_kernel_batched(torch, ops, ref, gates["state"].L, gates["packed"])
    kern_quant = phase_kernel_quant(torch, ops, ref, wire["case"])
    kern_flash = phase_kernel_flash(torch, ops, ref)
    log(f"[done] paths in {t_phases:.1f}s, all phases in {time.perf_counter() - t_all:.1f}s")

    entries = [
        {"name": "fed3r_stats", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed3r_stats.cu",
         "replaces": "src/repro/kernels/fed3r_stats.py:57",
         "launches": sl["launches"] + asy["launches"]["fed3r_stats"]
         + tiers["launches"]["fed3r_stats"] + dist["launches"]["fed3r_stats"], **kern},
        {"name": "rff", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rff.cu",
         "replaces": "src/repro/kernels/rff.py:42", "launches": rf["launches"],
         **{k: v for k, v in kern_rff.items() if k != "gemm_only_ms"}},
        {"name": "chol_gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/chol_gram.cu",
         "replaces": "src/repro/kernels/chol_update.py:86",
         "launches": stream["arrival"]["launches"] + dist["launches"]["chol_gram"],
         **kern_chol},
        {"name": "batched_chol_gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/batched_chol_gram.cu",
         "replaces": "src/repro/kernels/chol_update.py:189",
         "launches": heads["lru strict"]["launches"] + dist["launches"]["batched_chol_gram"],
         **kern_batched},
        {"name": "quantize_tiles", "route": "cuda", "source": "src/repro_torch/kernels/csrc/quant.cu",
         "replaces": "src/repro/kernels/quant.py:77",
         "launches": wire["launches"]["quantize_tiles"] + asy["launches"]["quantize_tiles"]
         + tiers["launches"]["quantize_tiles"] + dist["launches"]["quantize_tiles"],
         **kern_quant["quantize_tiles"]},
        {"name": "dequant_acc", "route": "cuda", "source": "src/repro_torch/kernels/csrc/quant.cu",
         "replaces": "src/repro/kernels/quant.py:108",
         "launches": wire["launches"]["dequant_acc"] + asy["launches"]["dequant_acc"]
         + tiers["launches"]["dequant_acc"] + dist["launches"]["dequant_acc"],
         **kern_quant["dequant_acc"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:85",
         "launches": srv["full"]["launches"] + moe["full"]["launches"]
         + sum(f["full"]["launches"] for f in fams.values()), **kern_flash},
    ]
    print(json.dumps({"kernels": entries}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
