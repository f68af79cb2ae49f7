"""Random Fourier Features for FED3R-RF (paper §4.2, Rahimi & Recht 2007).

The port of the reference's ``core/random_features.py``.  Approximates the
RBF kernel k(z, ζ) = exp(−‖z−ζ‖²/2σ²) with the feature map

    ψ(z) = √(2/D) · cos(Ωᵀ z + β),    Ω_ij ~ N(0, σ⁻²),  β_j ~ U[0, 2π).

ψ is data-independent, so all clients share one (Ω, β) drawn by the server —
FED3R-RF keeps the exact-aggregation property in the D-dimensional space.
The paper uses σ = 1000 and D ∈ {5k, 10k} (App. C/F).

:func:`rff_init` draws from a ``torch.Generator``: the same distributions as
the reference's ``jax.random`` draw, from another random stream.  Tests that
compare the two packages draw (Ω, β) with the reference and carry them
across with :func:`rff_params_from_jax`.  :func:`rff_map` runs the fused
kernel on the card (:func:`repro_torch.kernels.ops.rff_transform`) and its
plain version on the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.federated.dist import resolve_device
from repro_torch.kernels.ops import rff_transform


class RFFParams(NamedTuple):
    omega: torch.Tensor  # (d, D) fp32
    beta: torch.Tensor  # (D,) fp32
    sigma: torch.Tensor  # () fp32 (kept for bookkeeping)


def rff_init(
    gen: torch.Generator, d: int, n_features: int, sigma: float
) -> RFFParams:
    """Draw (Ω, β) on the generator's device (a CUDA generator draws on the card)."""
    dev = gen.device
    omega = torch.randn((d, n_features), generator=gen, device=dev) / sigma
    beta = torch.rand((n_features,), generator=gen, device=dev) * (2.0 * math.pi)
    return RFFParams(
        omega=omega, beta=beta,
        sigma=torch.tensor(sigma, dtype=torch.float32, device=dev),
    )


def rff_params_from_jax(
    omega, beta, sigma, device: Union[str, torch.device] = "cuda"
) -> RFFParams:
    """(Ω, β, σ) drawn elsewhere (the reference's ``rff_init``, as numpy
    arrays) as the port's :class:`RFFParams` on ``device``."""
    dev = resolve_device(device)

    def f32(x) -> torch.Tensor:
        return torch.tensor(np.array(x, dtype=np.float32), device=dev)

    return RFFParams(omega=f32(omega), beta=f32(beta), sigma=f32(sigma))


def rff_map(params: RFFParams, z: torch.Tensor) -> torch.Tensor:
    """ψ(z): (n, d) -> (n, D), fp32."""
    return rff_transform(z.to(torch.float32).contiguous(), params.omega, params.beta)


def rbf_kernel(z1: torch.Tensor, z2: torch.Tensor, sigma: float) -> torch.Tensor:
    """Exact RBF kernel matrix (for validating the RFF approximation)."""
    z1 = z1.to(torch.float32)
    z2 = z2.to(torch.float32)
    sq = (
        torch.sum(z1**2, -1)[:, None]
        - 2.0 * z1 @ z2.T
        + torch.sum(z2**2, -1)[None, :]
    )
    return torch.exp(-sq / (2.0 * sigma**2))
