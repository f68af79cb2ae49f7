"""Mamba2 mixer — SSD (state-space duality) chunked scan + O(1) decode.

The port of the reference's ``models/ssm.py`` (the Mamba2 paper's
"fully recurrent <-> quadratic dual" chunked algorithm, arXiv:2405.21060):

* within a chunk of length Q, the output is an attention-like quadratic form
  Y_intra = (C Bᵀ ∘ L) (Δ·X), L the decay-weighted causal mask;
* across chunks a small recurrence carries the (H, P, N) state
  h_{c+1} = (Π decay) h_c + states_c: a Python loop over the S / Q chunks
  with an fp32 carry (the reference's ``jax.lax.scan``);
* decode is a rank-1 state update a token, written into the cache IN PLACE.

The reference computes all of it in XLA, not in a Pallas kernel, so it
ports as torch ops.  Its dtypes are kept: ``jnp.einsum`` promotes a bf16 ×
fp32 product to fp32, so the mixed products here cast to fp32 first
(``torch.einsum`` refuses mixed dtypes), and its three-operand einsums are
two steps each.
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
)


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, d_inner = cfg.d_model, cfg.d_inner
    H, N, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_ch = d_inner + 2 * g * N
    d_in_proj = 2 * d_inner + 2 * g * N + H
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, d_in_proj)),
        "conv": causal_conv1d_init(gen, conv_ch, cfg.ssm_conv),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d)),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} a[..., k].

    a: (..., Q) -> (..., Q, Q) lower-triangular (−inf above the diagonal).
    """
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # cs_i - cs_j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)  inputs already weighted by Δ
    a: torch.Tensor,  # (B, S, H)     log-decay a step (Δ·A, negative), fp32
    Bm: torch.Tensor,  # (B, S, H, N)
    Cm: torch.Tensor,  # (B, S, H, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, S, H, P) in x's dtype, the final
    state (B, H, P, N) fp32).  S must be a multiple of min(chunk, S)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    f32 = torch.float32

    xc = x.reshape(B, nc, Q, H, P)
    ac = a.reshape(B, nc, Q, H).permute(0, 1, 3, 2)  # (B, nc, H, Q)
    Bc = Bm.reshape(B, nc, Q, H, N)
    Cc = Cm.reshape(B, nc, Q, H, N)
    a_cum = torch.cumsum(ac, dim=-1)  # (B, nc, H, Q)

    # ---- intra-chunk (quadratic, attention-like) --------------------------
    # scores in the activation dtype; scores·L and its product with x in
    # fp32, as jnp.einsum promotes them
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    weighted = scores.to(f32) * torch.exp(_segsum(ac))  # (B, nc, H, Q, Q)
    del scores
    y_diag = torch.einsum("bchls,bcshp->bclhp", weighted, xc.to(f32))
    del weighted

    # ---- per-chunk states (fp32 carry for numerical stability) -------------
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, nc, H, Q)
    states = torch.einsum(
        "bclhn,bclhp->bchpn", Bc.to(f32) * decay_states.permute(0, 1, 3, 2)[..., None],
        xc.to(f32),
    )

    # ---- inter-chunk recurrence: the state entering each chunk ------------
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, nc, H)
    h = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((B, H, P, N), dtype=f32, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    # ---- contribution of the carried state to each position ---------------
    state_decay = torch.exp(a_cum).permute(0, 1, 3, 2)[..., None]  # (B, nc, Q, H, 1)
    y_off = (torch.einsum("bclhn,bchpn->bclhp", Cc.to(f32), prev_states)
             * state_decay).to(x.dtype)

    y = (y_diag.to(x.dtype) + y_off).reshape(B, S, H, P)
    return y, h


def _split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner = cfg.d_inner
    g, N = cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * g * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * g * N:]
    return z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC: torch.Tensor):
    d_inner = cfg.d_inner
    g, N = cfg.ssm_ngroups, cfg.ssm_state
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + g * N]
    Cm = xBC[..., d_inner + g * N:]
    return x, Bm, Cm


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    dt = y.dtype
    y = (y * F.silu(z)).to(torch.float32)
    ms = y.square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(ms + 1e-6) * scale).to(dt)


def ssm_apply(
    cfg: ModelConfig,
    p: dict,
    u: torch.Tensor,
    *,
    build_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Sequence-mode Mamba2 mixer. u: (B, S, d) -> (y, cache if build_cache)."""
    B, S, _ = u.shape
    H, P, N, g = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    dt_ = u.dtype

    zxbcdt = u @ p["in_proj"].to(dt_)
    z, xBC_raw, dtr = _split_zxbcdt(cfg, zxbcdt)
    xBC = F.silu(causal_conv1d_apply(p["conv"], xBC_raw))
    x, Bm, Cm = _split_xbc(cfg, xBC)

    # jax.nn.softplus has no threshold; F.softplus returns x beyond 20, where
    # x + log1p(exp(-x)) rounds to x in fp32 anyway
    dt = F.softplus(dtr.to(torch.float32) + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)

    xh = x.reshape(B, S, H, P)
    Bh = Bm.reshape(B, S, g, N).repeat_interleave(H // g, dim=2)
    Ch = Cm.reshape(B, S, g, N).repeat_interleave(H // g, dim=2)

    y, final_state = ssd_chunked(
        xh * dt[..., None].to(dt_), (dt * A).to(torch.float32), Bh, Ch, cfg.ssm_chunk,
    )
    y = y + xh * p["D"][None, None, :, None].to(dt_)
    y = _gated_rmsnorm(y.reshape(B, S, H * P), z, p["norm_scale"])
    out = y @ p["out_proj"].to(dt_)

    cache = None
    if build_cache:
        w = cfg.ssm_conv
        tail = xBC_raw[:, max(0, S - (w - 1)):, :]
        pad = torch.zeros((B, (w - 1) - tail.shape[1], tail.shape[-1]), dtype=dt_,
                          device=u.device)
        cache = {"state": final_state.to(torch.float32),
                 "conv": torch.cat([pad, tail], dim=1)}
    return out, cache


def _state_step(state: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """The decode recurrence h ← dA·h + Δ·x Bᵀ, written into ``state`` in place.
    state, dBx: (B, H, P, N) fp32; dA: (B, H)."""
    return state.mul_(dA[..., None, None]).add_(dBx)


def ssm_decode_step(
    cfg: ModelConfig, p: dict, u_t: torch.Tensor, cache: dict
) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent update, O(B·H·P·N). u_t: (B, 1, d).  The cache's
    ``state`` and ``conv`` are updated in place; returns (y (B, 1, d), cache)."""
    B = u_t.shape[0]
    H, P, N, g = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    dt_ = u_t.dtype
    f32 = torch.float32

    zxbcdt = u_t[:, 0, :] @ p["in_proj"].to(dt_)  # (B, d_in_proj)
    z, xBC, dtr = _split_zxbcdt(cfg, zxbcdt)
    _, xBC = causal_conv1d_step(p["conv"], cache["conv"], xBC)
    x, Bm, Cm = _split_xbc(cfg, F.silu(xBC))

    dt = F.softplus(dtr.to(f32) + p["dt_bias"])  # (B, H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, H)

    xh = x.reshape(B, H, P).to(f32)
    Bh = Bm.reshape(B, g, N).repeat_interleave(H // g, dim=1).to(f32)
    Ch = Cm.reshape(B, g, N).repeat_interleave(H // g, dim=1).to(f32)

    state = _state_step(cache["state"], dA, (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xh * p["D"][None, :, None]
    y = _gated_rmsnorm(y.reshape(B, H * P).to(dt_), z, p["norm_scale"])
    return (y @ p["out_proj"].to(dt_))[:, None, :], cache
