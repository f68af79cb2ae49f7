"""The plain reference of Fed3R-RF's random features (paper section 4.2).

psi(z) = sqrt(2/D) cos(z Omega + beta), in float64; it imports nothing of
the port.  The features themselves are the benchmark's inputs, so they pass
through as they are.  ``precision="tf32"``: the product takes TF32 operands
with fp32 sums, and the cosine is fp32.

The configuration computes in IEEE fp32, so its controls are TF32, the step
down that would tempt a later change: ``CONTROLS`` maps each to (the map's
precision, whether the statistics take TF32 operands).  Whole, the map's
product alone, the statistics alone.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.ridge import matmul_tf32

PRECISION = "fp64"
CONTROLS = {"tf32": ("tf32", True), "tf32_map": ("tf32", False),
            "tf32_stats": ("fp64", True)}
BLOCK = 8192  # samples a block


def features(config: dict, params: dict, x: torch.Tensor, precision: str = PRECISION
             ) -> torch.Tensor:
    """psi of a block of samples, x (n, d) -> (n, D)."""
    D = params["omega"].shape[1]
    if precision == "fp64":
        z = x.double() @ params["omega"].double() + params["beta"].double()
    elif precision == "tf32":
        z = matmul_tf32(x.float(), params["omega"].float()) + params["beta"].float()
    else:
        raise ValueError(f"precision fp64 or tf32, got {precision!r}")
    return math.sqrt(2.0 / D) * torch.cos(z)
