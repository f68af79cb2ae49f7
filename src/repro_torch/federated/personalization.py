"""Multi-tenant personalization engine — batched closed-form per-client heads.

The port of the reference's ``federated/personalization.py``.  The global
ridge head is immune to heterogeneity because it ignores per-client
structure, but cross-device serving wants PER-USER heads, and the closed
form makes them nearly free:

    W_k = (A + α_k·A_k + λI)⁻¹ (b + α_k·b_k)

is a rank-n_k Cholesky update away from the shared factored state
(:class:`repro_torch.core.fed3r.Fed3RFactored` carries L with
L Lᵀ = A + λI), so K personalized heads solve in ONE engine call:

* the cohort arrives as a :class:`repro_torch.data.pipeline.PackedPersonalCohort`
  (padded ``(K, max_n, ...)`` arrays with masks + a per-client holdout
  split, canonical id order — bit-invariant to request order);
* per-client α_k is selected by a closed-form held-out score swept over a
  static α grid (grid × clients batched): each candidate head is solved
  from the client's train split and scored on its holdout split — 0/1
  error of the served head by default, or the raw ridge residual.  The
  sweep's Grams are plain ``torch`` products, as the reference leaves them
  to XLA;
* the winning α_k refits on the client's full data: the K rank-n updates
  G_k = L Lᵀ + α_k·Z_kᵀZ_k, B_k = α_k·Z_kᵀY_k are ONE launch of the
  ``batched_chol_gram`` kernel (:func:`repro_torch.kernels.ops.batched_chol_gram`;
  its plain version on the CPU), with α_k folded in by √α_k pre-scaling;
* every factorization, the sweep's (|grid|, K, d, d) batch and the
  refit's (K, d, d) batch, goes through
  :func:`repro_torch.core.fed3r.psd_cholesky`: α = 0 rows and padded rows
  refactor the rounded fp32 L Lᵀ, which at d = 1280 can be indefinite by
  more than λ (the reference's plain Cholesky then gives NaN);
* α = 0 reproduces the global :func:`repro_torch.core.fed3r.factored_solution`
  BITWISE — those rows take ONE unbatched global solve (a batched
  triangular solve may round differently), selected with ``where``.

:class:`ReferencePersonalizedLoop` keeps the per-client shape — one global
solve plus one re-solve per client (K+1 dispatches for a K-head cohort) —
as the dispatch baseline and the parity oracle.  The serving layers are
:mod:`repro_torch.launch.serve_heads` and
:mod:`repro_torch.launch.serving_engine`.

Scale-out (:mod:`repro_torch.federated.dist`): under ``DistConfig(
aggregation="psum", mesh=...)`` every rank takes the same call on the same
packed cohort (pack with ``pack_personal_cohort(..., mesh=mesh)`` so the
cohort divides) and solves only its block of the heads against the shared
(L, b) — one ``batched_chol_gram`` launch over its K/N heads — then the
heads are gathered back, a broadcast of each rank's block: heads are per
tenant, so the cohort's reduction is a gather, not a sum.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fed3r
from repro_torch.core.fed3r import Fed3RFactored, Fed3RStats
from repro_torch.data.pipeline import PackedPersonalCohort
from repro_torch.federated.dist import (
    DistConfig,
    DistContext,
    DistDispatchMixin,
    resolve_device,
)
from repro_torch.kernels.ops import batched_chol_gram


@dataclass(frozen=True)
class PersonalizeConfig:
    """Static personalization-engine configuration.

    ``alpha_grid`` is the candidate set the held-out sweep selects from;
    clients whose holdout split is empty (single-sample clients, or
    ``holdout_frac=0`` at pack time) fall back to ``alpha_grid[0]``, so
    put the conservative default (typically ``0.0`` = global head) first.
    ``dist`` under ``"psum"`` with a mesh splits the cohort over the ranks.
    """

    n_classes: int
    alpha_grid: Tuple[float, ...] = (0.0, 0.25, 1.0, 4.0)
    normalize: bool = True  # per-class column normalization of served heads
    selection: str = "error"  # α score: "error" (0/1 held-out) | "sse" (ridge)
    dist: DistConfig = field(default_factory=DistConfig)

    def __post_init__(self):
        if not self.alpha_grid:
            raise ValueError("alpha_grid must be non-empty")
        if any(a < 0.0 for a in self.alpha_grid):
            raise ValueError(f"alpha_grid must be >= 0, got {self.alpha_grid}")
        if self.selection not in ("error", "sse"):
            raise ValueError(f"unknown selection score: {self.selection!r}")


class PersonalizedHeads(NamedTuple):
    """The batched solve's output: K per-tenant heads + selection trace."""

    W: torch.Tensor  # (K, d, C) personalized classifiers (cohort order)
    alpha: torch.Tensor  # (K,) selected per-client interpolation weight
    score: torch.Tensor  # (K,) held-out score at the selected α (0 if no sweep)
    client_ids: torch.Tensor  # (K,) int32 tenant ids, -1 = padded slot


class PersonalizationEngine(DistDispatchMixin):
    """K personalized heads over a shared factored state in ONE engine call.

    ``solve_heads`` sweeps the α grid per client and refits; ``solve_at``
    skips the sweep and solves at caller-provided α_k.  Each call is one
    dispatch and one ``batched_chol_gram`` launch (the refit).
    """

    def __init__(self, cfg: PersonalizeConfig, *, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dist = DistContext(cfg.dist, engine="personalization")
        # the α grid on the engine's device, copied once here rather than
        # on every sweep (a host-to-device copy blocks the host)
        self._alpha_grid = torch.tensor(cfg.alpha_grid, dtype=torch.float32, device=self.device)

    # ---- pure core --------------------------------------------------------

    def _design(self, x, y, m):
        """Masked per-client designs: (K, N, d) features, (K, N, C) targets."""
        z = x.to(torch.float32) * m[..., None]
        yh = F.one_hot(y.long(), self.cfg.n_classes).to(torch.float32)
        return z, yh * m[..., None]

    def _batched_solve(self, L_use, rhs):
        """Batched triangular solves, optionally normalized — the head refresh."""
        W = torch.cholesky_solve(rhs, L_use, upper=False)
        if self.cfg.normalize:
            W = fed3r.normalize_columns(W, axis=-2)
        return W

    def _refit(self, L, b, z, yh, alphas):
        """Batched rank-n refit at the selected α_k over full client data.

        α_k folds into the Gram bilinearly via √α_k pre-scaling, so the
        kernel stays scale-free.  α_k = 0 rows select a global head computed
        by :func:`repro_torch.core.fed3r.factored_solution`'s exact ops (ONE
        unbatched solve, which the batched solve would not reproduce
        bitwise).
        """
        s = torch.sqrt(alphas)[:, None, None]
        G, B = batched_chol_gram(L, (z * s).contiguous(), (yh * s).contiguous())
        Wp = self._batched_solve(fed3r.psd_cholesky(G), b[None] + B)
        Wg = fed3r.factored_solution(Fed3RFactored(L=L, b=b), self.cfg.normalize)
        return torch.where(alphas[:, None, None] == 0.0, Wg[None], Wp)

    def _sweep(self, L, b, z_tr, yh_tr, z_ho, yh_ho, y, ho):
        """Closed-form α selection: grid × clients, one batched solve each.

        Candidate heads are solved from the TRAIN split only and scored on
        the HOLDOUT split (masks are already folded into the designs, so
        padded/train rows contribute exactly nothing):

        * ``"error"`` (default) — held-out misclassification count of the
          candidate head AS SERVED (normalized per config).  Ties pick the
          FIRST grid entry (``torch.argmin`` returns the first minimum), so
          an ascending grid starting at 0 degrades to the global head.
        * ``"sse"`` — the raw held-out ridge residual Σ_ho ‖Wᵀφ(x) − e_y‖².
        """
        grid = self._alpha_grid
        z_trT = z_tr.transpose(-1, -2)
        S = z_trT @ z_tr  # (K, d, d)
        Bt = z_trT @ yh_tr  # (K, d, C)
        g = grid[:, None, None, None]
        Lg = fed3r.psd_cholesky(L @ L.T + g * S[None])  # (G, K, d, d)
        W = torch.cholesky_solve(b + g * Bt[None], Lg, upper=False)  # (G, K, d, C)
        if self.cfg.selection == "error":
            if self.cfg.normalize:
                W = fed3r.normalize_columns(W, axis=2)
            pick = torch.argmax(z_ho @ W, dim=-1)  # (G, K, N)
            score = torch.sum(ho[None] * (pick != y[None].long()).to(torch.float32), dim=2)
        else:
            resid = z_ho @ W - yh_ho[None]
            score = torch.sum(resid**2, dim=(2, 3))  # (G, K)
        idx = torch.argmin(score, dim=0)  # (K,) ties → first grid entry
        return grid[idx], torch.gather(score, 0, idx[None, :])[0]

    def _heads_impl(self, L, b, x, y, m, ho) -> Tuple[torch.Tensor, ...]:
        z, yh = self._design(x, y, m)
        if len(self.cfg.alpha_grid) == 1:  # no sweep: α is pinned
            K = y.shape[0]
            alphas = torch.full((K,), self.cfg.alpha_grid[0], dtype=torch.float32, device=L.device)
            score = torch.zeros((K,), dtype=torch.float32, device=L.device)
        else:
            tr = (1.0 - ho)[..., None]  # holdout ⊆ mask, so z·tr is the train design
            hm = ho[..., None]
            alphas, score = self._sweep(L, b, z * tr, yh * tr, z * hm, yh * hm, y, ho)
        return self._refit(L, b, z, yh, alphas), alphas, score

    def _cohort(self, packed: PackedPersonalCohort, *fields: str):
        """The fields on the engine's device: this rank's block of the cohort."""
        return [torch.as_tensor(self.dist.local_block(getattr(packed, f)), device=self.device)
                for f in fields]

    # ---- host API ---------------------------------------------------------

    @torch.no_grad()
    def solve_heads(
        self, state: Fed3RFactored, packed: PackedPersonalCohort
    ) -> PersonalizedHeads:
        """Sweep α and solve K personalized heads in ONE engine call."""
        with self.dist.telemetry.span("solve_heads", engine="personalization"):
            self.dist.dispatch()
            x, y, m, ho = self._cohort(packed, "inputs", "labels", "mask", "holdout")
            W, alphas, score = self.dist.gather_blocks(
                self._heads_impl(state.L, state.b, x, y, m, ho))
            return PersonalizedHeads(
                W=W, alpha=alphas, score=score,
                client_ids=torch.as_tensor(packed.client_ids, device=self.device),
            )

    @torch.no_grad()
    def solve_at(
        self,
        state: Fed3RFactored,
        packed: PackedPersonalCohort,
        alphas: Union[np.ndarray, torch.Tensor],  # (K,) per-client weights, no sweep
    ) -> PersonalizedHeads:
        """Solve K heads at fixed per-client α_k in ONE engine call."""
        with self.dist.telemetry.span("solve_at", engine="personalization"):
            self.dist.dispatch()
            a = torch.as_tensor(alphas, dtype=torch.float32, device=self.device)
            x, y, m = self._cohort(packed, "inputs", "labels", "mask")
            z, yh = self._design(x, y, m)
            (W,) = self.dist.gather_blocks(
                [self._refit(state.L, state.b, z, yh, self.dist.local_block(a))])
            return PersonalizedHeads(
                W=W, alpha=a, score=torch.zeros_like(a),
                client_ids=torch.as_tensor(packed.client_ids, device=self.device),
            )


class ReferencePersonalizedLoop:
    """The per-client shape: K+1 dispatches for a K-head cohort.

    One global ``factored_solution`` (what a non-personalized server would
    serve) plus one per-client re-solve each — client statistics and the
    d×d refactorization re-run per tenant.  Kept as the dispatch baseline
    and the numerical parity oracle of the batched engine.
    """

    def __init__(self, cfg: PersonalizeConfig, *, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dispatches = 0

    @torch.no_grad()
    def solve_at(
        self,
        state: Fed3RFactored,
        packed: PackedPersonalCohort,
        alphas: Union[np.ndarray, torch.Tensor],  # (K,)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (global W, stacked per-client heads (K, d, C))."""
        W_g = fed3r.factored_solution(state, self.cfg.normalize)
        self.dispatches += 1
        a = torch.as_tensor(alphas, dtype=torch.float32).cpu()
        heads = []
        for k in range(packed.cohort):
            stats = fed3r.client_stats(
                torch.as_tensor(packed.inputs[k], device=self.device),
                torch.as_tensor(packed.labels[k], device=self.device),
                self.cfg.n_classes,
                torch.as_tensor(packed.mask[k], device=self.device),
            )
            heads.append(fed3r.personalized_solution(state, stats, a[k], self.cfg.normalize))
            self.dispatches += 1
        return W_g, torch.stack(heads)


def cohort_stats(
    packed: PackedPersonalCohort, n_classes: int, device: Union[str, torch.device] = "cuda"
) -> Fed3RStats:
    """Fold the whole cohort's masked statistics.

    The sum of per-client (A_k, b_k, n_k) over the packed cohort: what the
    server's aggregate must equal, and a convenient parity anchor for tests.
    """
    dev = resolve_device(device)
    K, N = packed.labels.shape
    feats = torch.as_tensor(packed.inputs, device=dev).reshape((K * N,) + packed.inputs.shape[2:])
    return fed3r.client_stats(
        feats,
        torch.as_tensor(packed.labels, device=dev).reshape(-1),
        n_classes,
        torch.as_tensor(packed.mask, device=dev).reshape(-1),
    )
