"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of the reference's ``models/rglru.py``.  The block is:

    x ── proj_main ── causal-conv1d(4) ── RG-LRU ──┐
                                                    ⊙ ── proj_out ──> y
    x ── proj_gate ── GeLU ───────────────────────┘

with the Real-Gated LRU recurrence (elementwise over the lru_width channels):

    r_t = σ(W_a x_t + b_a)                    recurrence gate
    i_t = σ(W_x x_t + b_x)                    input gate
    log a_t = −c · softplus(Λ) · r_t          (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The reference evaluates the linear recurrence with
``jax.lax.associative_scan`` (in XLA, not Pallas).  PyTorch has no such
scan, so :func:`_linear_scan` is a log-depth doubling scan in torch ops with
the reference's combine, in fp32: ⌈log₂ S⌉ passes (12 at S = 4096), where a
loop over the steps would launch S times a layer and the closed form
through exp(−cumsum log a) overflows fp32 past a few hundred steps.  Decode
is one elementwise update, written into the cache IN PLACE; the state is
carried in fp32.

Under a ``"model"`` axis that splits ``lru_width`` (the reference's hints
put the block's activations on it, ``src/repro/models/rglru.py``) a rank
holds its columns of ``proj_main``, ``proj_gate``, the conv, ``w_a`` and
``w_x`` and its rows of ``proj_out``: the conv, the scan and the decode
update run on its channels; the gates' (W, W) products read the conv's
output gathered over ``"model"`` (an activation, never a weight); and
``proj_out``'s partial sums are all-reduced once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    causal_conv1d_apply,
    causal_conv1d_init,
    causal_conv1d_step,
    dense_init,
    gelu,
)
from repro_torch.sharding import hints

_C = 8.0  # Griffin's fixed recurrence-sharpness constant


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    dev = gen.device
    # Λ initialised so that a ∈ (0.9, 0.999) at r = 1 (Griffin appendix)
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(0.9, 0.999, generator=gen)
    return {
        "proj_main": dense_init(gen, (d, w)),
        "proj_gate": dense_init(gen, (d, w)),
        "conv": causal_conv1d_init(gen, w, 4),
        "w_a": dense_init(gen, (w, w)),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_x": dense_init(gen, (w, w)),
        "b_x": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lambda": torch.log(torch.expm1(-torch.log(u) / _C)),  # softplus⁻¹(−log(u)/c)
        "proj_out": dense_init(gen, (w, d)),
    }


def _width_split(cfg: ModelConfig) -> bool:
    """Whether the ambient mesh splits the block over ``lru_width``."""
    return (hints.model_size() > 1
            and hints.layout("rec/proj_main", (cfg.d_model, cfg.lru_width))[1] == "model")


def rank_width(cfg: ModelConfig) -> int:
    """The channels of ``lru_width`` a rank runs, and so holds the state
    and conv cache of."""
    return cfg.lru_width // hints.model_size() if _width_split(cfg) else cfg.lru_width


def _gather_width(x: torch.Tensor) -> torch.Tensor:
    """The ranks' channel blocks of ``x`` (..., w / model), in order."""
    return hints.gather_model(x, -1)


def _gates(p: dict, x: torch.Tensor, full: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., w) fp32 -> (log_a, gated input), both fp32; ``full`` is the
    input of the (W, W) products where x is a rank's channels of it."""
    xin = x if full is None else full
    r = torch.sigmoid(xin @ p["w_a"].to(x.dtype) + p["b_a"])
    i = torch.sigmoid(xin @ p["w_x"].to(x.dtype) + p["b_x"])
    log_a = -_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12))
    return log_a, beta * (i * x)


def _linear_scan(log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t-1} + b_t by a doubling (Hillis–Steele) scan.

    log_a, b: (B, S, w) fp32; h0: (B, w) or None. Returns h: (B, S, w).
    Pass k combines each step with the one 2ᵏ before it under the
    reference's combine ((la1, b1), (la2, b2)) -> (la1 + la2, exp(la2)·b1 + b2).
    """
    if h0 is not None:  # fold the initial state into the first step
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None], b[:, 1:]], dim=1)
    S = b.shape[1]
    la, h = log_a, b
    shift = 1
    while shift < S:
        la_hi, h_hi = la[:, shift:], h[:, shift:]
        h = torch.cat([h[:, :shift], torch.exp(la_hi) * h[:, :-shift] + h_hi], dim=1)
        if shift * 2 < S:  # the last pass needs no decay product
            la = torch.cat([la[:, :shift], la[:, :-shift] + la_hi], dim=1)
        shift *= 2
    return h


def rglru_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    build_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Sequence mode. x: (B, S, d) -> (y, cache if build_cache)."""
    dt = x.dtype
    gate = gelu(x @ p["proj_gate"].to(dt))
    main_raw = x @ p["proj_main"].to(dt)
    main = causal_conv1d_apply(p["conv"], main_raw)

    split = _width_split(cfg)
    m32 = main.to(torch.float32)
    log_a, b = _gates(p, m32, _gather_width(m32) if split else None)
    h = _linear_scan(log_a, b, None)  # fp32
    y = (h.to(dt) * gate) @ p["proj_out"].to(dt)
    if split:
        y = hints.reduce_model(y)

    cache = None
    if build_cache:
        w_conv = p["conv"]["kernel"].shape[0]
        S = x.shape[1]
        tail = main_raw[:, max(0, S - (w_conv - 1)):, :]
        pad = torch.zeros((x.shape[0], (w_conv - 1) - tail.shape[1], tail.shape[-1]),
                          dtype=dt, device=x.device)
        cache = {"h": h[:, -1, :].clone(),  # (B, w) fp32
                 "conv": torch.cat([pad, tail], dim=1)}
    return y, cache


def rglru_decode_step(
    cfg: ModelConfig, p: dict, x_t: torch.Tensor, cache: dict
) -> Tuple[torch.Tensor, dict]:
    """One-token update. x_t: (B, 1, d).  The cache's ``h`` and ``conv`` are
    updated in place; returns (y (B, 1, d), cache)."""
    dt = x_t.dtype
    xt = x_t[:, 0, :]
    gate = gelu(xt @ p["proj_gate"].to(dt))
    main_raw = xt @ p["proj_main"].to(dt)
    _, main = causal_conv1d_step(p["conv"], cache["conv"], main_raw)

    split = _width_split(cfg)
    m32 = main.to(torch.float32)
    log_a, b = _gates(p, m32, _gather_width(m32) if split else None)
    h = cache["h"].mul_(torch.exp(log_a)).add_(b)  # (B, w) fp32
    y = (h.to(dt) * gate) @ p["proj_out"].to(dt)
    return (hints.reduce_model(y) if split else y)[:, None, :], cache
