"""The plain reference of Fed3R's statistics and solve, and the comparison.

Float64 throughout; it imports nothing of the port.  The statistics
(Eq. 5/6): A = sum phi phi^T, b = sum phi e_y^T, n, and the class counts.
The solve (Eq. 4, then the per-class column normalisation) is judged by its
normwise backward error against the statistics it was solved from.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def new_stats(d: int, C: int, device, dtype=F64) -> dict:
    return {"A": torch.zeros((d, d), dtype=dtype, device=device),
            "b": torch.zeros((d, C), dtype=dtype, device=device),
            "n": 0, "counts": torch.zeros((C,), dtype=F64, device=device)}


def fold(stats: dict, feats: torch.Tensor, labels: torch.Tensor, tf32: bool = False) -> None:
    """Add a block of samples' features (n, d) and labels (n,) to ``stats``,
    summed in the statistics' own dtype; with ``tf32`` the features are
    rounded as a TF32 tensor core reads them (a control)."""
    z = (round_tf32(feats) if tf32 else feats).to(stats["A"].dtype)
    y = labels.long()
    stats["A"] += z.T @ z
    stats["b"].T.index_add_(0, y, z)
    stats["n"] += z.shape[0]
    stats["counts"] += torch.bincount(y, minlength=stats["counts"].shape[0]).to(F64)


def rel_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest entry gap, over the reference's widest entry."""
    ref = reference.to(F64)
    return float((program.to(F64) - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def solve_residual(A: torch.Tensor, b: torch.Tensor, W: torch.Tensor, lam: float) -> float:
    """The normwise backward error of a normalised ridge solution W (d, C):
    for each class c with b_c != 0, ||M W_c - a_c b_c|| / (||M||_F ||W_c||)
    with M = A + lam I and a_c the least-squares scale (normalisation drops
    1/||W_c||); a class with b_c = 0 must have W_c = 0.  The worst class."""
    A, b, W = A.to(F64), b.to(F64), W.to(F64)
    M = A + lam * torch.eye(A.shape[0], dtype=F64, device=A.device)
    MW = M @ W
    bb = (b * b).sum(0)
    live = bb > 0
    if bool((W[:, ~live] != 0).any()):
        return float("inf")
    if not bool(live.any()):
        return 0.0
    MW, b, W, bb = MW[:, live], b[:, live], W[:, live], bb[live]
    wn = torch.linalg.vector_norm(W, dim=0)
    if bool((wn == 0).any()) or not bool(torch.isfinite(W).all()):
        return float("inf")
    scale = (MW * b).sum(0) / bb
    res = torch.linalg.vector_norm(MW - scale * b, dim=0)
    return float((res / (torch.linalg.vector_norm(M) * wn)).max())


def solve(A: torch.Tensor, b: torch.Tensor, lam: float) -> torch.Tensor:
    """W = (A + lam I)^-1 b, columns normalised, in the dtype of A."""
    M = A + lam * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    W = torch.cholesky_solve(b, torch.linalg.cholesky(M))
    return W / torch.linalg.vector_norm(W, dim=0, keepdim=True).clamp_min(1e-12)


# --- the controls' precisions: values rounded as the lower precision holds them


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest, ties away),
    as a tensor core reads them."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def matmul_tf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as a TF32 tensor core computes it: inputs rounded, fp32 sums."""
    return round_tf32(x) @ round_tf32(w)
