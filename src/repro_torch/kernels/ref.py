"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function computes what its kernel computes, with ordinary tensor ops.
The kernel wrappers run these for CPU tensors, and ``chip_smoke.py`` holds
each kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fed3r_stats_ref(Z: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = ZᵀZ, b = ZᵀY in fp32. Z: (n, d); Y: (n, C) one-hot/targets."""
    Zf = Z.to(torch.float32)
    return Zf.T @ Zf, Zf.T @ Y.to(torch.float32)
