"""FED3R — Federated Recursive Ridge Regression (paper §4), in PyTorch.

The port of the reference's ``core/fed3r.py``: plain functions over a small
``Fed3RStats`` tuple of tensors.  The simulator drivers and the datacenter
path both reach these through the accumulation engine
(:mod:`repro_torch.federated.engine`).

Statistics (Eq. 5/6):
    A = Σ_k Σ_{(x,y)∈D_k} φ(x)φ(x)ᵀ          (d×d, fp32)
    b = Σ_k Σ_{(x,y)∈D_k} φ(x) e_yᵀ           (d×C, fp32)
Solve (Eq. 4):  W* = (A + λI)⁻¹ b, then per-class column normalization.

Recursive form (Eq. 3): the factored state L Lᵀ = A + λI that the streaming
engine carries (:class:`Fed3RFactored`), and the deprecated subtractive
Woodbury state (:class:`Fed3ROnline`), kept only as the numerical foil of
:class:`repro_torch.federated.streaming_engine.ReferenceArrivalLoop`.

Distributed aggregation: :func:`aggregate_mesh`, the rank partials summed
over a ``DeviceMesh`` (:mod:`repro_torch.federated.dist`).

Personalized heads: :func:`personalized_solution` and
:func:`batched_personalized_solution`, W_k = (A + α_k·A_k + λI)⁻¹(b + α_k·b_k)
over the shared factored state.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.federated.dist import resolve_device, two_stage_psum
from repro_torch.kernels.ops import chol_gram


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
        # a fill on the device: no host-to-device copy
        n = torch.full((), float(features.shape[0]), dtype=torch.float32, device=z.device)
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


def aggregate_mesh(stats: Fed3RStats, axis_names: Sequence[str], mesh: Any) -> Fed3RStats:
    """Distributed aggregation: every rank's local statistics summed over
    the mesh axes (one all-reduce an axis, innermost first), the same sum
    on every rank."""
    return two_stage_psum(stats, mesh, axis_names)


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


# ---------------------------------------------------------------------------
# Recursive (online) formulation — factored rank-n updates
# ---------------------------------------------------------------------------


class Fed3RFactored(NamedTuple):
    """Online RR state in Cholesky-factored form: L Lᵀ = A + λI.

    Every arrival performs the ADDITIVE rank-n update L ← chol(L Lᵀ + ZᵀZ)
    (no subtraction, hence no fp32 cancellation — contrast
    :class:`Fed3ROnline`), and W = (A + λI)⁻¹ b is two triangular solves
    against L.  ``L`` is lower-triangular (its upper triangle is zero);
    ``b`` is a plain running sum, like :class:`Fed3RStats`.
    """

    L: torch.Tensor  # (d, d) fp32 lower Cholesky factor of A + λI
    b: torch.Tensor  # (d, C) fp32


def init_factored(
    d: int, n_classes: int, ridge_lambda: float, device: Union[str, torch.device] = "cuda"
) -> Fed3RFactored:
    dev = resolve_device(device)
    sqrt_lam = float(torch.tensor(ridge_lambda, dtype=torch.float32).sqrt())  # in fp32, as the reference
    return Fed3RFactored(
        L=sqrt_lam * torch.eye(d, dtype=torch.float32, device=dev),
        b=torch.zeros((d, n_classes), dtype=torch.float32, device=dev),
    )


def psd_cholesky(
    G: torch.Tensor, bound: Optional[Union[torch.Tensor, float]] = None
) -> torch.Tensor:
    """Lower Cholesky factor of a nominally positive definite fp32 Gram G.

    G is (d, d) or a batch (..., d, d), each matrix factored on its own.
    The fp32 Gram L Lᵀ + ZᵀZ is itself rounded: each entry is off by about
    eps·max diag(G), and a d×d perturbation of that size has a spectral norm
    near √d·eps·max diag(G).  While the absorbed samples are fewer than d,
    G's smallest eigenvalues are the ridge λ, and that rounding can push
    them below zero: at d = 1280, λ = 1e-2 and the streaming driver's data
    the reference's ``jnp.linalg.cholesky`` fails on the first wave and the
    stream stays NaN.  So, as the reference's ``compress.psd_cholesky`` does
    for quantization noise: the plain factorization first (bit-identical
    where it succeeds), and only where it fails, retries with a diagonal
    jitter τ ∈ {1, 4, 16}·√d·eps·max diag(G), the bound taken per matrix.
    ``bound`` replaces that rounding bound with the caller's (a scalar, or
    one per matrix of the batch): the compressed uplink passes its
    quantization-noise bound (:func:`repro_torch.federated.compress.
    quant_spectral_bound`), as the reference's ``compress.psd_cholesky``
    takes it.  Where every retry fails, the factor is NaN on and below the
    diagonal (zero above), the reference's failure pattern.

    Branch-free: ``cholesky_ex`` without its host-side check and ``where``
    chains, so a wave makes no host sync (``torch.linalg.cholesky`` would
    sync to raise).  The factor comes back row-major (``cholesky_ex`` writes
    it column-major), as the ``chol_gram`` kernels read it.
    """
    d = G.shape[-1]
    L, info = torch.linalg.cholesky_ex(G, check_errors=False)
    if bound is None:
        bound = math.sqrt(d) * torch.finfo(torch.float32).eps * G.diagonal(dim1=-2, dim2=-1).amax(-1)
    else:
        bound = torch.as_tensor(bound, dtype=G.dtype, device=G.device)
    eye = torch.eye(d, dtype=G.dtype, device=G.device)
    for mult in (1.0, 4.0, 16.0):
        retry, retry_info = torch.linalg.cholesky_ex(
            G + (mult * bound)[..., None, None] * eye, check_errors=False
        )
        take = (info != 0) & (retry_info == 0)
        L = torch.where(take[..., None, None], retry, L)
        info = torch.where(take, retry_info, info)
    failed = torch.full_like(L, float("nan")).tril()
    return torch.where((info == 0)[..., None, None], L, failed).contiguous()


def factored_update(
    state: Fed3RFactored,
    features: torch.Tensor,  # (n, d)
    labels: torch.Tensor,  # (n,) int
    mask: Optional[torch.Tensor] = None,  # (n,) 1.0 real / 0.0 padding
) -> Fed3RFactored:
    """Stable rank-n update with a new arrival batch Z (n, d):

    L ← chol(L Lᵀ + ZᵀZ),  b ← b + ZᵀY.

    The two GEMMs are one launch of the fused ``chol_gram`` kernel on the
    card (its plain version on the CPU); the factorization is
    :func:`psd_cholesky`.
    """
    z, y, _ = masked_design(features, labels, state.b.shape[1], mask)
    G, dB = chol_gram(state.L, z, y)
    return Fed3RFactored(L=psd_cholesky(G), b=state.b + dB)


def factored_solution(state: Fed3RFactored, normalize: bool = True) -> torch.Tensor:
    """W = (A + λI)⁻¹ b by two triangular solves against the carried factor."""
    W = torch.cholesky_solve(state.b, state.L, upper=False)
    if normalize:
        W = normalize_columns(W)
    return W


# ---------------------------------------------------------------------------
# Personalized heads — per-client closed forms over the shared factored state
# ---------------------------------------------------------------------------


def personalized_solution(
    state: Fed3RFactored,
    client: Fed3RStats,
    alpha: Union[float, torch.Tensor],
    normalize: bool = True,
) -> torch.Tensor:
    """Per-client closed-form head W_k = (A + α·A_k + λI)⁻¹ (b + α·b_k).

    Client k's own statistics (A_k, b_k) are re-weighted by α ≥ 0 on top of
    the global sums, so the head interpolates from the global classifier
    (α = 0) toward a local-emphasis one: one d×d refactorization
    G = L Lᵀ + α·A_k (through :func:`psd_cholesky`) and two triangular
    solves.

    α = 0 reproduces :func:`factored_solution` BITWISE: the carried factor L
    and right-hand side b are selected unchanged, never refactored through
    chol(L Lᵀ) (whose rounding differs, and at d = 1280 can fail).  α is
    read on the host.  The batched form over a packed cohort is
    :class:`repro_torch.federated.personalization.PersonalizationEngine`.
    """
    a = float(alpha)
    if a == 0.0:
        return factored_solution(state, normalize)
    L_pers = psd_cholesky(state.L @ state.L.T + a * client.A)
    W = torch.cholesky_solve(state.b + a * client.b, L_pers, upper=False)
    if normalize:
        W = normalize_columns(W)
    return W


def batched_personalized_solution(
    state: Fed3RFactored,
    A_k: torch.Tensor,  # (K, d, d) per-client second moments
    b_k: torch.Tensor,  # (K, d, C) per-client class-conditional sums
    alphas: torch.Tensor,  # (K,) per-client interpolation weights
    normalize: bool = True,
) -> torch.Tensor:
    """K personalized heads (K, d, C) in one batch of factorizations and solves.

    Semantics per head follow :func:`personalized_solution`: α = 0 rows
    select the global (L, b) operands unchanged, but the solve itself is
    BATCHED, and a batched triangular solve may round differently from the
    unbatched one — so α = 0 here agrees with ``factored_solution`` to the
    last ulp of the solver, NOT bitwise.  Where the exact-bitwise α = 0
    fallback matters (serving), use the engine
    (:class:`repro_torch.federated.personalization.PersonalizationEngine`),
    which substitutes an unbatched global solve for those rows.
    """
    a = torch.as_tensor(alphas, dtype=torch.float32, device=state.L.device)[:, None, None]
    L_pers = psd_cholesky(state.L @ state.L.T + a * A_k)
    L_use = torch.where(a == 0.0, state.L, L_pers)
    rhs = torch.where(a == 0.0, state.b, state.b + a * b_k)
    W = torch.cholesky_solve(rhs, L_use, upper=False)
    if normalize:
        W = normalize_columns(W, axis=1)
    return W


# ---------------------------------------------------------------------------
# Deprecated: subtractive Sherman–Morrison–Woodbury compat path
# ---------------------------------------------------------------------------


class Fed3ROnline(NamedTuple):
    """DEPRECATED online RR state carrying A⁻¹ directly.

    With λ ≪ tr(A)/d the initial A⁻¹ = I/λ is orders of magnitude larger
    than the converged inverse, so the subtractive Woodbury update suffers
    catastrophic cancellation in fp32.  Kept only as the numerical foil of
    the streaming engine; use ``init_factored``/``factored_update``.
    """

    Ainv: torch.Tensor  # (d, d) fp32 — (A + λI)⁻¹
    b: torch.Tensor  # (d, C)


# fp32 cancellation becomes visible once 1/λ dwarfs the converged inverse;
# below this λ the legacy path is known-bad even at modest sample counts
_SMALL_LAMBDA = 0.1


def _warn_legacy_woodbury(ridge_lambda: Optional[float] = None) -> None:
    hazard = (
        " At small ridge_lambda the subtractive update CANCELS"
        " catastrophically in fp32 — expect a visibly wrong W."
        if ridge_lambda is not None and ridge_lambda < _SMALL_LAMBDA
        else ""
    )
    warnings.warn(
        "Fed3ROnline/woodbury_update is deprecated: the subtractive Woodbury"
        " update is numerically unstable in fp32. Use the factored state"
        " (init_factored/factored_update/factored_solution) or the streaming"
        " engine (repro_torch.federated.streaming_engine)." + hazard,
        DeprecationWarning,
        stacklevel=3,
    )


def init_online(
    d: int, n_classes: int, ridge_lambda: float, device: Union[str, torch.device] = "cuda"
) -> Fed3ROnline:
    _warn_legacy_woodbury(ridge_lambda)
    dev = resolve_device(device)
    return Fed3ROnline(
        Ainv=torch.eye(d, dtype=torch.float32, device=dev) / ridge_lambda,
        b=torch.zeros((d, n_classes), dtype=torch.float32, device=dev),
    )


def woodbury_update(
    state: Fed3ROnline, features: torch.Tensor, labels: torch.Tensor
) -> Fed3ROnline:
    """DEPRECATED rank-n update with a new client's batch Z (n, d):

    (A + ZᵀZ)⁻¹ = A⁻¹ − A⁻¹Zᵀ (I + Z A⁻¹ Zᵀ)⁻¹ Z A⁻¹

    The subtraction is the fp32 hazard; prefer :func:`factored_update`.
    """
    Z = features.to(torch.float32)
    n = Z.shape[0]
    C = state.b.shape[1]
    AiZt = state.Ainv @ Z.T  # (d, n)
    K = torch.eye(n, dtype=torch.float32, device=Z.device) + Z @ AiZt  # (n, n)
    Lk = torch.linalg.cholesky(K)
    Ainv = state.Ainv - AiZt @ torch.cholesky_solve(AiZt.T, Lk, upper=False)
    b = state.b + Z.T @ F.one_hot(labels.long(), C).to(torch.float32)
    return Fed3ROnline(Ainv=Ainv, b=b)


def online_solution(
    state: Union[Fed3RFactored, Fed3ROnline], normalize: bool = True
) -> torch.Tensor:
    """Solution of either online state; routes through the factored path.

    Given a :class:`Fed3RFactored` this IS :func:`factored_solution`.  The
    legacy :class:`Fed3ROnline` branch warns: its W inherits the
    accumulated cancellation error of the carried A⁻¹.
    """
    if isinstance(state, Fed3RFactored):
        return factored_solution(state, normalize)
    _warn_legacy_woodbury()
    W = state.Ainv @ state.b
    if normalize:
        W = normalize_columns(W)
    return W
