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

Under a ``"model"`` axis the mixer runs head-sharded, where the
reference's hints put the SSD (``src/repro/models/ssm.py``).  The rules
cut ``in_proj``'s z | xBC | dt columns and the conv's x | B | C channels
into contiguous blocks that line up with neither the pieces nor the
heads, so a rank runs its ``in_proj`` block (column-parallel, or
row-parallel where the columns do not divide) and gathers it, runs the
conv on its channel block and gathers that, and then runs the SSD and the
decode's state update on its heads (its ``A_log``, ``dt_bias`` and ``D``,
its state rows); the gated RMSNorm over the whole d_inner all-reduces a
partial sum of squares, and ``out_proj`` is row-parallel (one all-reduce).

Where the heads do not divide the axis the rules leave ``A_log``,
``dt_bias``, ``D`` and the state unsplit, and every rank runs the SSD on
every head (a replicated leaf is computed whole, never all-reduced): the
gated norm's sum of squares is then the whole width's, with no
all-reduce; ``norm_scale`` and ``out_proj`` may still split over d_inner
(the rank scales its block of the normed y and ``out_proj`` reduces its
product; the SSD's backward then takes the whole cotangent of y, over m,
on every rank: ``hints.mean_cotangent``), or, where d_inner does not
divide either, run whole.
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
from repro_torch.sharding import hints


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


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   d_full: Optional[int] = None, block: bool = False) -> torch.Tensor:
    """RMSNorm of y·silu(z) over its last dim, or, with ``d_full``, over the
    ranks' blocks of it together (a rank's sum of squares all-reduced);
    with ``block``, the rank's "model" block of the whole width's norm,
    times ``scale``, the rank's block of the scale (elementwise: the bits
    of the whole scaled norm's block)."""
    dt = y.dtype
    y = (y * F.silu(z)).to(torch.float32)
    if d_full is None:
        ms = y.square().mean(dim=-1, keepdim=True)
    else:
        ms = hints.reduce_model(y.square().sum(dim=-1, keepdim=True)) / d_full
    if block:
        y = hints.model_block(y, -1)
    return (y * torch.rsqrt(ms + 1e-6) * scale).to(dt)


class _Mixer:
    """How a rank runs the mixer under the ambient mesh: its in_proj block
    (``"cols"``, ``"rows"`` or ``"full"``), whether the conv's channels are
    split, its heads (``heads``: a slice, None where every rank runs every
    head) and whether ``norm_scale`` and ``out_proj`` split over d_inner
    (``inner``)."""

    def __init__(self, cfg: ModelConfig):
        d, H = cfg.d_model, cfg.ssm_nheads
        conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        self.on = hints.model_size() > 1
        self.in_proj, self.conv, self.heads, self.inner = "full", False, None, False
        if not self.on:
            return
        spec = hints.layout("ssm/in_proj", (d, conv_ch + cfg.d_inner + H))
        self.in_proj = "cols" if spec[1] == "model" else "rows" if spec[0] == "model" else "full"
        self.conv = hints.layout("ssm/conv/kernel", (cfg.ssm_conv, conv_ch))[1] == "model"
        self.inner = hints.layout("ssm/out_proj", (cfg.d_inner, d))[0] == "model"
        if hints.layout("ssm/A_log", (H,))[0] == "model":
            self.heads = _rank_heads(H)

    def project(self, u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """u @ in_proj, whole on every rank."""
        if self.in_proj == "cols":
            return hints.gather_model(u @ w.to(u.dtype), -1)
        if self.in_proj == "rows":
            return hints.reduce_model(hints.model_block(u, -1) @ w.to(u.dtype))
        return u @ w.to(u.dtype)

    def channels(self, xbc: torch.Tensor) -> torch.Tensor:
        """The conv's input channels this rank holds the kernel of."""
        return hints.model_block(xbc, -1) if self.conv else xbc

    def gather(self, xbc: torch.Tensor) -> torch.Tensor:
        """The conv's output, whole."""
        return hints.gather_model(xbc, -1) if self.conv else xbc

    def head_cols(self, t: torch.Tensor, width: int) -> torch.Tensor:
        """The rank's heads of ``t``'s last dim (``width`` entries a head)."""
        if self.heads is None:
            return t
        return t[..., self.heads.start * width:self.heads.stop * width]

    def out(self, cfg: ModelConfig, p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The gated norm of the SSD's ``y`` (the rank's heads, or every
        head) and ``out_proj``, whole on every rank: row-parallel (one
        all-reduce) where ``out_proj`` splits, else computed whole."""
        w = p["out_proj"].to(y.dtype)
        if self.heads is not None:
            return hints.reduce_model(_gated_rmsnorm(y, z, p["norm_scale"], cfg.d_inner) @ w)
        if self.inner:
            # each rank uses its block of y, but ran the SSD on every head:
            # its backward takes the whole cotangent of y over m, not the
            # rank's block of it, whose A_log and dt_bias gradients would
            # cancel against the other ranks' in the replicated sum
            y = hints.mean_cotangent(y)
            return hints.reduce_model(_gated_rmsnorm(y, z, p["norm_scale"], block=True) @ w)
        return _gated_rmsnorm(y, z, p["norm_scale"]) @ w


def cache_widths(cfg: ModelConfig) -> Tuple[int, int]:
    """(conv channels, heads) of the cache a rank holds: those its mixer runs
    on (:class:`_Mixer`)."""
    mx = _Mixer(cfg)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    heads = cfg.ssm_nheads if mx.heads is None else mx.heads.stop - mx.heads.start
    return (conv_ch // hints.model_size() if mx.conv else conv_ch), heads


def _rank_heads(H: int) -> slice:
    """The SSD heads of this model rank."""
    n = H // hints.model_size()
    return slice(hints.model_rank() * n, (hints.model_rank() + 1) * n)


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
    mx = _Mixer(cfg)

    zxbcdt = mx.project(u, p["in_proj"])
    z, xBC_raw, dtr = _split_zxbcdt(cfg, zxbcdt)
    xBC_raw = mx.channels(xBC_raw)
    xBC = mx.gather(F.silu(causal_conv1d_apply(p["conv"], xBC_raw)))
    x, Bm, Cm = _split_xbc(cfg, xBC)
    x, z, dtr = mx.head_cols(x, P), mx.head_cols(z, P), mx.head_cols(dtr, 1)
    Hl = dtr.shape[-1]

    # jax.nn.softplus has no threshold; F.softplus returns x beyond 20, where
    # x + log1p(exp(-x)) rounds to x in fp32 anyway
    dt = F.softplus(dtr.to(torch.float32) + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)

    xh = x.reshape(B, S, Hl, P)
    Bh = mx.head_cols(Bm.reshape(B, S, g, N).repeat_interleave(H // g, dim=2).flatten(2), N)
    Ch = mx.head_cols(Cm.reshape(B, S, g, N).repeat_interleave(H // g, dim=2).flatten(2), N)

    y, final_state = ssd_chunked(
        xh * dt[..., None].to(dt_), (dt * A).to(torch.float32), Bh.unflatten(2, (Hl, N)),
        Ch.unflatten(2, (Hl, N)), cfg.ssm_chunk,
    )
    y = y + xh * p["D"][None, None, :, None].to(dt_)
    out = mx.out(cfg, p, y.reshape(B, S, Hl * P), z)

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
    mx = _Mixer(cfg)

    zxbcdt = mx.project(u_t[:, 0, :], p["in_proj"])  # (B, d_in_proj)
    z, xBC, dtr = _split_zxbcdt(cfg, zxbcdt)
    _, xBC = causal_conv1d_step(p["conv"], cache["conv"], mx.channels(xBC))
    x, Bm, Cm = _split_xbc(cfg, mx.gather(F.silu(xBC)))
    x, z, dtr = mx.head_cols(x, P), mx.head_cols(z, P), mx.head_cols(dtr, 1)
    Hl = dtr.shape[-1]

    dt = F.softplus(dtr.to(f32) + p["dt_bias"])  # (B, H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, H)

    xh = x.reshape(B, Hl, P).to(f32)
    Bh = mx.head_cols(Bm.reshape(B, g, N).repeat_interleave(H // g, dim=1).flatten(1), N)
    Ch = mx.head_cols(Cm.reshape(B, g, N).repeat_interleave(H // g, dim=1).flatten(1), N)
    Bh, Ch = Bh.unflatten(1, (Hl, N)).to(f32), Ch.unflatten(1, (Hl, N)).to(f32)

    state = _state_step(cache["state"], dA, (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xh * p["D"][None, :, None]
    return mx.out(cfg, p, y.reshape(B, Hl * P).to(dt_), z)[:, None, :], cache
