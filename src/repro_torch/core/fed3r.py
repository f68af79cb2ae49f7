"""FED3R — Federated Recursive Ridge Regression (paper §4), in PyTorch.

The port of the reference's ``core/fed3r.py``: plain functions over a small
``Fed3RStats`` tuple of tensors.  The simulator drivers and the datacenter
path both reach these through the accumulation engine
(:mod:`repro_torch.federated.engine`).

Statistics (Eq. 5/6):
    A = Σ_k Σ_{(x,y)∈D_k} φ(x)φ(x)ᵀ          (d×d, fp32)
    b = Σ_k Σ_{(x,y)∈D_k} φ(x) e_yᵀ           (d×C, fp32)
Solve (Eq. 4):  W* = (A + λI)⁻¹ b, then per-class column normalization.

The streaming (factored), personalized and deprecated Woodbury forms of the
reference module are later slices of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.federated.dist import resolve_device


class Fed3RStats(NamedTuple):
    """Sufficient statistics of the ridge-regression classifier."""

    A: torch.Tensor  # (d, d) fp32 feature second moment
    b: torch.Tensor  # (d, C) fp32 class-conditional feature sums
    n: torch.Tensor  # () fp32 sample count (diagnostics / NCM reuse)


def init_stats(
    d: int, n_classes: int, device: Union[str, torch.device] = "cuda"
) -> Fed3RStats:
    dev = resolve_device(device)
    return Fed3RStats(
        A=torch.zeros((d, d), dtype=torch.float32, device=dev),
        b=torch.zeros((d, n_classes), dtype=torch.float32, device=dev),
        n=torch.zeros((), dtype=torch.float32, device=dev),
    )


def masked_design(
    features: torch.Tensor,  # (n, d) — φ(x), any float dtype
    labels: torch.Tensor,  # (n,) int
    n_classes: int,
    mask: Optional[torch.Tensor] = None,  # (n,) 1.0 = real sample, 0.0 = padding
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked fp32 design matrices (Z, Y) and exact sample count n.

    The single source of truth for the masking semantics of Eq. 5/6: every
    statistics backend (the plain GEMMs here, the CUDA kernel in the
    engine) consumes these, so padded rows contribute exactly nothing to A,
    b, or n.
    """
    z = features.to(torch.float32)
    y = F.one_hot(labels.long(), n_classes).to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)[:, None]
        z = z * m
        y = y * m
        n = m.sum()
    else:
        n = torch.tensor(float(features.shape[0]), dtype=torch.float32, device=z.device)
    return z, y, n


def client_stats(
    features: torch.Tensor,
    labels: torch.Tensor,
    n_classes: int,
    mask: Optional[torch.Tensor] = None,
) -> Fed3RStats:
    """Local statistics A_k, b_k of one client (Algorithm 1, client side).

    The plain-GEMM form; the engine computes the same through the
    ``fed3r_stats`` kernel.
    """
    z, y, n = masked_design(features, labels, n_classes, mask)
    return Fed3RStats(A=z.T @ z, b=z.T @ y, n=n)


def merge(*stats: Fed3RStats) -> Fed3RStats:
    """Server aggregation: a left fold of client statistics, in argument order.

    Invariance to the client split and sampling order (paper §4.3) is the
    reassociation freedom of this sum; the engine fixes the order, which
    makes the sum bitwise reproducible.
    """
    return Fed3RStats(
        A=sum(s.A for s in stats),
        b=sum(s.b for s in stats),
        n=sum(s.n for s in stats),
    )


def normalize_columns(W: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-class column normalization W_c ← W_c / max(‖W_c‖, 1e-12)."""
    norms = torch.linalg.vector_norm(W, dim=axis, keepdim=True)
    return W / torch.clamp_min(norms, 1e-12)


def solve(
    stats: Fed3RStats,
    ridge_lambda: float,
    normalize: bool = True,
) -> torch.Tensor:
    """Closed-form classifier W* = (A + λI)⁻¹ b (Eq. 4) via Cholesky.

    A + λI ≻ 0 for λ > 0, so the lower-triangular factor always exists (the
    reference's ``cho_factor(lower=True)`` / ``cho_solve``).  Optional
    per-class column normalization (paper, after Eq. 6).
    """
    d = stats.A.shape[0]
    A_reg = stats.A + ridge_lambda * torch.eye(d, dtype=torch.float32, device=stats.A.device)
    L = torch.linalg.cholesky(A_reg)
    W = torch.cholesky_solve(stats.b, L, upper=False)
    if normalize:
        W = normalize_columns(W)
    return W


def predict(W: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """One-vs-rest scores f(x) = Wᵀφ(x): (n, C)."""
    return features.to(torch.float32) @ W


def accuracy(W: torch.Tensor, features: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    hits = torch.argmax(predict(W, features), dim=-1) == labels.to(W.device).long()
    return hits.to(torch.float32).mean()
