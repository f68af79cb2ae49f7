"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function computes what its kernel computes, with ordinary tensor ops.
The kernel wrappers run these for CPU tensors, and ``chip_smoke.py`` holds
each kernel against its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


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
