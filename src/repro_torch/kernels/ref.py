"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function computes what its kernel computes, with ordinary tensor ops.
The kernel wrappers run these for CPU tensors, and ``chip_smoke.py`` holds
each kernel against its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

INT8_QMAX = 127.0  # symmetric int8 range (−127 … 127; −128 unused)


def fed3r_stats_ref(Z: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = ZᵀZ, b = ZᵀY in fp32. Z: (n, d); Y: (n, C) one-hot/targets."""
    Zf = Z.to(torch.float32)
    return Zf.T @ Zf, Zf.T @ Y.to(torch.float32)


def chol_gram_ref(
    L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G = L Lᵀ + ZᵀZ, B = ZᵀY in fp32. L: (d, d); Z: (n, d); Y: (n, C)."""
    Lf = L.to(torch.float32)
    Zf = Z.to(torch.float32)
    return Lf @ Lf.T + Zf.T @ Zf, Zf.T @ Y.to(torch.float32)


def batched_chol_gram_ref(
    L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G_k = L Lᵀ + Z_kᵀZ_k, B_k = Z_kᵀY_k in fp32 over K heads sharing one L.

    L: (d, d); Z: (K, n, d); Y: (K, n, C).  Returns ((K, d, d), (K, d, C)).
    """
    Lf = L.to(torch.float32)
    Zf = Z.to(torch.float32)
    Zt = Zf.transpose(-1, -2)
    return Lf @ Lf.T + Zt @ Zf, Zt @ Y.to(torch.float32)


def rff_ref(Z: torch.Tensor, omega: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """√(2/D)·cos(ZΩ + β) in fp32. Z: (n, d); Ω: (d, D); β: (D,)."""
    D = omega.shape[1]
    proj = Z.to(torch.float32) @ omega.to(torch.float32) + beta.to(torch.float32)
    return math.sqrt(2.0 / D) * torch.cos(proj)


def pad_to_tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """x (M, N) zero-padded up to multiples of ``tile`` in both dims."""
    p0, p1 = (-x.shape[0]) % tile, (-x.shape[1]) % tile
    return F.pad(x, (0, p1, 0, p0)) if (p0 or p1) else x


def expand_tiles(scales: torch.Tensor, tile: int, M: int, N: int) -> torch.Tensor:
    """The (⌈M/tile⌉, ⌈N/tile⌉) per-tile grid expanded to a dense (M, N) array."""
    return scales.repeat_interleave(tile, dim=0).repeat_interleave(tile, dim=1)[:M, :N]


def quantize_tiles_ref(
    x: torch.Tensor, tile: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile absmax symmetric int8 quantization: (q, scales).

    x: (M, N) → q (M, N) int8, scales (⌈M/tile⌉, ⌈N/tile⌉) fp32 with
    s = max|tile| · fl(1/127) (1.0 for an all-zero tile, so q = 0 exactly),
    then q = clip(round_half_even(x / s), ±127) with a true division.  The
    scale is a multiplication by the rounded reciprocal, not a division by
    127: that is what the reference's jitted quantizer and its Pallas kernel
    compute (XLA folds the division by a constant).  Ragged edges pad with
    zeros, which never move a tile's absmax.
    """
    M, N = x.shape
    xp = pad_to_tiles(x.to(torch.float32), tile)
    Mt, Nt = xp.shape[0] // tile, xp.shape[1] // tile
    blocks = xp.reshape(Mt, tile, Nt, tile)
    absmax = blocks.abs().amax(dim=(1, 3))
    inv = torch.tensor(1.0 / INT8_QMAX, dtype=torch.float32, device=x.device)
    scales = torch.where(absmax > 0.0, absmax * inv, torch.ones_like(absmax))
    q = torch.round(blocks / scales[:, None, :, None]).clamp_(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8).reshape(xp.shape)[:M, :N].contiguous(), scales


def dequant_acc_ref(
    acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, tile: int = 128
) -> torch.Tensor:
    """acc + q·s with ONE rounding, fma(q, s, acc): the reference's arithmetic.

    Expands the per-tile scales to a dense (M, N) array (the intermediate
    the kernel avoids).  No PyTorch op documents a fused multiply-add
    (``torch.addcmul`` happens to round once on the CPU and on the card
    with the builds tried, and its CUDA source leaves that to the
    compiler), so the sum is formed in float64, where q·s is exact
    (8 × 24 bits), its rounding error recovered exactly (TwoSum), and the
    float64 sum rounded to odd before the one rounding to fp32: rounding to
    odd in a format with ≥ 2 more bits than fp32's 24 makes the double
    rounding innocuous (Boldo & Melquiond), so the result is fma(q, s, acc)
    on any device.
    """
    M, N = acc.shape
    a = acc.to(torch.float64)
    p = q.to(torch.float64) * expand_tiles(scales, tile, M, N).to(torch.float64)
    d = a + p
    bv = d - a
    err = (a - (d - bv)) + (p - bv)  # d + err == a + p exactly
    even = (d.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    d = torch.where((err != 0) & even, torch.nextafter(d, toward), d)
    return d.to(torch.float32)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked softmax attention (fp32 softmax), GQA-aware, any S >= 1.

    q: (B, S, H, hd); k/v: (B, S, KV, hd); query head h reads KV head
    h // (H/KV).  Scores in q's dtype, scaled by hd^-0.5, then fp32, masked
    with −1e30 outside ``k <= q`` (causal) and ``k > q − window``, soft-maxed,
    and the probabilities taken back to q's dtype for the value product.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = (torch.einsum("bqkgh,bskh->bkgqs", qg, k) * hd ** -0.5).to(torch.float32)
    pos = torch.arange(S, device=q.device)
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid &= pos[None, :] <= pos[:, None]
    if window is not None:
        valid &= pos[None, :] > pos[:, None] - window
    scores = torch.where(valid, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(B, S, H, hd)
