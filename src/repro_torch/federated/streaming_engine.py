"""Streaming FED3R arrival engine — factored rank-n updates + live serving.

The port of the reference's ``federated/streaming_engine.py``: the paper's
recursive-least-squares formulation (Eq. 3) and its §6 future work, clients
arriving over time with new data, as an arrival-driven runtime:

* the timeline arrives as a :class:`repro_torch.data.pipeline.PackedArrivals`
  (padded ``(n_waves, clients_per_wave, max_n, ...)`` arrays with masks);
* the carried state is the numerically stable FACTORED form
  (:class:`repro_torch.core.fed3r.Fed3RFactored` semantics): the lower
  Cholesky factor L of A + λI, advanced per wave by the additive rank-n
  update L ← chol(L Lᵀ + ZᵀZ) — no subtraction, no fp32 cancellation;
* each wave is one Python step where the reference scans: ``feature_fn``
  (if any) → the random-features map (``rff_params``, one launch of the
  ``rff`` kernel) → the masked design → ONE launch of the fused
  ``chol_gram`` kernel (:func:`repro_torch.kernels.ops.chol_gram`; its
  plain version on the CPU) → the guarded factorization
  (:func:`repro_torch.core.fed3r.psd_cholesky`) → the refresh policy;
* live serving is a refresh POLICY: ``refresh_every=1`` re-solves W on
  every wave, ``k > 1`` on every k-th wave, and the :class:`WaveTrace`
  reports the staleness (waves and samples absorbed since the served W was
  last solved).  The host keeps the wave clock, so the policy is a host
  branch (the reference's ``lax.cond`` on a device scalar), and a wave
  makes no host sync.

One deliberate difference from the reference: its fp32 stream factors the
rounded Gram with a plain Cholesky, which fails — and leaves the stream NaN
— when the first waves hold fewer samples than d and the ridge drowns in
fp32 rounding (d = 1280, λ = 1e-2 on its own driver's data).  The port
factors through ``psd_cholesky``: bit-identical where the plain
factorization succeeds, a jitter of a few rounding steps only where it
fails.

With a compressed wire format (``StreamConfig(wire=WireFormat(kind="int8" |
"fp8" | "sketch"))``) each wave's rank-n statistics (S, ΔB) cross the wire
compressed before they touch the carried factor: S and ΔB by one
``fed3r_stats`` launch, the Gram L Lᵀ by a ``chol_gram`` launch with no
sample rows (exactly symmetric), the upload folded in by
:func:`repro_torch.federated.compress.roundtrip_add`, then the guarded
factorization with the quantization-noise bound of the wire
(:func:`repro_torch.federated.compress.quant_spectral_bound`) for int8 and
fp8.  The fused ``chol_gram`` of the fp32 path is bypassed because the wire
sits between the sample GEMMs and the factor reconstruction.

Exactness: each wave's clients are canonically packed (sorted by id) and the
kernels sum without atomics, so the folded state — and the final W — is
bitwise invariant to the presentation order of concurrent arrivals; across
waves the stream order IS the semantics.  :class:`ReferenceArrivalLoop`
keeps the subtractive Woodbury update as the numerical foil.

:meth:`StreamingEngine.tiered_absorber` folds segments of edge payloads
through a host-tier aggregation tree (:mod:`repro_torch.federated.tiers`).

Scale-out (:mod:`repro_torch.federated.dist`): under ``DistConfig(
aggregation="psum", mesh=...)`` every rank absorbs the same timeline and
takes its block of each wave's WIDTH (the arrival clock is not split; pack
with ``pack_arrival_waves(..., mesh=mesh)``).  A wave is then one
``fed3r_stats`` launch on the rank's rows, one all-reduce of (S, ΔB, n)
(each rank's partial through the wire first, under a compressed wire),
and the replicated Gram L Lᵀ + S — the ``chol_gram`` launch with no sample
rows — before the same guarded factorization on every rank.  The fused
``chol_gram`` is not used there: every rank would add L Lᵀ.  The all-reduce
sits on the critical path (wave t+1's factor needs wave t's sum).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fed3r
from repro_torch.core.fed3r import Fed3RFactored
from repro_torch.core.random_features import RFFParams, rff_map
from repro_torch.data.pipeline import PackedArrivals
from repro_torch.federated import compress
from repro_torch.federated.compress import WireFormat
from repro_torch.federated.dist import (
    DistConfig,
    DistContext,
    DistDispatchMixin,
    resolve_device,
)
from repro_torch.federated.telemetry import Telemetry
from repro_torch.kernels.ops import chol_gram, fed3r_stats


@dataclass(frozen=True)
class StreamConfig:
    """Static streaming-engine configuration."""

    n_classes: int
    ridge_lambda: float
    refresh_every: int = 1  # 1 = refresh-on-arrival; k > 1 = every k-th wave
    normalize: bool = True  # per-class column normalization of the served W
    dist: DistConfig = field(default_factory=DistConfig)  # backend/mesh
    # statistics wire format (repro_torch.federated.compress): each wave's
    # rank-n (S, ΔB) upload crosses the wire in this format before it
    # touches the carried factor; fp32 is bitwise the uncompressed stream
    wire: WireFormat = field(default_factory=WireFormat)


class StreamState(NamedTuple):
    """Factored statistics + the live-served classifier.

    ``wave`` and ``stale_waves`` are host integers: the host keeps the
    arrival clock and decides each refresh from it.
    """

    L: torch.Tensor  # (d, d) fp32 lower Cholesky factor of A + λI
    b: torch.Tensor  # (d, C) fp32 class-conditional feature sums
    n: torch.Tensor  # () fp32 samples absorbed
    W: torch.Tensor  # (d, C) fp32 currently SERVED classifier
    wave: int  # waves absorbed (the arrival clock)
    stale_waves: int  # waves since W was last solved
    stale_samples: torch.Tensor  # () fp32 samples absorbed since W was last solved

    @property
    def factored(self) -> Fed3RFactored:
        """The core factored-state view (for factored_solution etc.)."""
        return Fed3RFactored(L=self.L, b=self.b)


class WaveTrace(NamedTuple):
    """Per-wave outputs, stacked over the absorbed timeline.

    ``refreshed`` and ``stale_waves`` come from the host's clock and are CPU
    tensors; ``n_seen`` and ``stale_samples`` stay on the engine's device.
    """

    n_seen: torch.Tensor  # (T,) fp32 cumulative samples after each wave
    refreshed: torch.Tensor  # (T,) bool — did this wave re-solve W?
    stale_waves: torch.Tensor  # (T,) int32 staleness of the served W, in waves
    stale_samples: torch.Tensor  # (T,) fp32 staleness of the served W, in samples


def stream_state_from_jax(state: Any, device: Union[str, torch.device] = "cuda") -> StreamState:
    """A stream state from elsewhere (the reference's ``StreamState``, or
    any object with its seven fields as arrays) as the port's, on ``device``,
    so a stream can continue in the port where it stopped."""
    dev = resolve_device(device)

    def f32(x) -> torch.Tensor:
        return torch.tensor(np.array(x, dtype=np.float32), device=dev)

    return StreamState(
        L=f32(state.L), b=f32(state.b), n=f32(state.n), W=f32(state.W),
        wave=int(np.asarray(state.wave)), stale_waves=int(np.asarray(state.stale_waves)),
        stale_samples=f32(state.stale_samples),
    )


def factored_from_jax(L: Any, b: Any, device: Union[str, torch.device] = "cuda") -> Fed3RFactored:
    """A factored state from elsewhere (the reference's ``Fed3RFactored``
    arrays, or any (L, b) arrays) as the port's, on ``device``, so both
    packages can serve heads from the same global state."""
    dev = resolve_device(device)
    return Fed3RFactored(
        L=torch.tensor(np.array(L, dtype=np.float32), device=dev),
        b=torch.tensor(np.array(b, dtype=np.float32), device=dev),
    )


class StreamingEngine(DistDispatchMixin):
    """Streaming FED3R over packed arrival timelines, on ``device``.

    ``feature_fn(params, flat_inputs) -> (n, d)`` maps each wave's packed
    raw inputs (flattened to ``(clients_per_wave·max_n, ...)``) to φ
    features; ``None`` means the inputs already are features.
    ``rff_params`` maps them through the FED3R-RF random features, as
    :class:`repro_torch.federated.engine.AccumulationEngine` does.
    """

    def __init__(
        self,
        cfg: StreamConfig,
        *,
        feature_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
        rff_params: Optional[RFFParams] = None,
        device: Union[str, torch.device] = "cuda",
        telemetry: Optional[Telemetry] = None,
    ):
        if cfg.refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1, got {cfg.refresh_every}")
        if rff_params is not None and not isinstance(rff_params, RFFParams):
            raise TypeError(f"rff_params must be RFFParams, got {type(rff_params).__name__}")
        self.cfg = cfg
        self.feature_fn = feature_fn
        self.rff_params = rff_params
        self.device = resolve_device(device)
        self.wire = cfg.wire.resolved()  # fp8 → int8 only where torch lacks fp8
        self.dist = DistContext(cfg.dist, engine="streaming", telemetry=telemetry)

    def init(self, d: int) -> StreamState:
        fac = fed3r.init_factored(d, self.cfg.n_classes, self.cfg.ridge_lambda, self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return StreamState(
            L=fac.L, b=fac.b, n=zero,
            W=torch.zeros((d, self.cfg.n_classes), dtype=torch.float32, device=self.device),
            wave=0, stale_waves=0, stale_samples=zero,
        )

    def _solve(self, L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Two triangular solves against the carried factor (the refresh)."""
        return fed3r.factored_solution(Fed3RFactored(L=L, b=b), self.cfg.normalize)

    def _wave(
        self, state: StreamState, x: torch.Tensor, y: torch.Tensor, m: torch.Tensor, params: Any
    ) -> Tuple[StreamState, bool]:
        """Fold one wave (P, N, ...) into the state; returns (state, refreshed)."""
        flat = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
        feats = flat if self.feature_fn is None else self.feature_fn(params, flat)
        if self.rff_params is not None:
            feats = rff_map(self.rff_params, feats)
        # ψ(0) ≠ 0: the mask applies after the map, here
        z, yh, nw = fed3r.masked_design(feats, y.reshape(-1), self.cfg.n_classes, m.reshape(-1))
        if self.cfg.dist.aggregation == "psum":
            # this rank's rows; the Gram of the carried factor once, after
            # the sum (the fused kernel would add L Lᵀ on every rank)
            S, dB = fed3r_stats(z, yh)
            S, dB, nw = self.dist.all_reduce((S, dB, nw),
                                             wire_fn=compress.psum_wire_fn(self.wire))
            G, b = self._gram(state) + S, state.b + dB
            L = self._lossy_cholesky(G, S)
        elif self.wire.kind == "fp32":
            G, dB = chol_gram(state.L, z, yh)
            L = fed3r.psd_cholesky(G)
            b = state.b + dB
        else:
            S, dB = fed3r_stats(z, yh)
            G, b = compress.roundtrip_add(self._gram(state), state.b, S, dB, self.wire)
            L = self._lossy_cholesky(G, S)
        t = state.wave + 1
        refresh = t % self.cfg.refresh_every == 0
        if refresh:
            W, stale_w, stale_n = self._solve(L, b), 0, torch.zeros_like(nw)
        else:
            W, stale_w, stale_n = state.W, state.stale_waves + 1, state.stale_samples + nw
        return StreamState(
            L=L, b=b, n=state.n + nw, W=W, wave=t, stale_waves=stale_w, stale_samples=stale_n
        ), refresh

    def _gram(self, state: StreamState) -> torch.Tensor:
        """L Lᵀ of the carried factor: a ``chol_gram`` launch with no sample
        rows, exactly symmetric."""
        d, C = state.b.shape
        G, _ = chol_gram(state.L, state.L.new_zeros((0, d)), state.b.new_zeros((0, C)))
        return G

    def _lossy_cholesky(self, G: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        """The guarded factorization of a Gram that received statistics S
        through the wire: int8 and fp8 (the engine's wire, else a lossy tier
        of a routed tree) size the jitter by their quantization noise;
        sketch and fp32 add none, so the fp32 rounding bound guards.  Under
        psum S is the reduced sum, so every rank takes the same guard."""
        lossy = self.wire if self.wire.kind in ("int8", "fp8") else self.cfg.dist.lossy_tier_wire
        if lossy is not None:
            return fed3r.psd_cholesky(G, bound=compress.quant_spectral_bound(S, lossy))
        return fed3r.psd_cholesky(G)

    @torch.no_grad()
    def absorb(
        self, state: StreamState, packed: PackedArrivals, params: Any = None
    ) -> Tuple[StreamState, WaveTrace]:
        """Absorb T arrival waves in order.

        Returns the advanced state (the served classifier is ``state.W``)
        and the per-wave :class:`WaveTrace`.  With the timeline already on
        the engine's device (``packed.to(device)``) nothing here waits for
        the card.
        """
        with self.dist.telemetry.span("absorb", engine="streaming"):
            self.dist.dispatch()
            inputs, labels, mask = (  # psum: this rank's block of the wave width
                torch.as_tensor(self.dist.local_block(a, axis=1), device=self.device)
                for a in (packed.inputs, packed.labels, packed.mask)
            )
            n_seen, refreshed, stale_w, stale_n = [], [], [], []
            for x, y, m in zip(inputs, labels, mask):
                state, refresh = self._wave(state, x, y, m, params)
                n_seen.append(state.n)
                refreshed.append(refresh)
                stale_w.append(state.stale_waves)
                stale_n.append(state.stale_samples)
            dev = self.device
            trace = WaveTrace(
                n_seen=torch.stack(n_seen) if n_seen else torch.zeros((0,), device=dev),
                refreshed=torch.tensor(refreshed, dtype=torch.bool),
                stale_waves=torch.tensor(stale_w, dtype=torch.int32),
                stale_samples=torch.stack(stale_n) if stale_n else torch.zeros((0,), device=dev),
            )
            return state, trace

    @torch.no_grad()
    def absorb_stats(
        self, state: StreamState, A: torch.Tensor, b: torch.Tensor, n: torch.Tensor
    ) -> StreamState:
        """Fold one round's already-reduced (ΣA_k, Σb_k, Σn_k) and refresh W.

        The integration point for round-granular producers: the statistics
        land in the carried factor through the Gram reconstruction L Lᵀ (a
        ``chol_gram`` launch with no sample rows) and W re-solves.  Under the
        ``merge`` backend the already-reduced statistics do not cross the
        wire again, but a lossy wire's noise bound still sizes the guard.
        Under a dist-owned mesh the statistics would be counted once a rank,
        so it is refused there: use :meth:`absorb`.
        """
        if self.cfg.dist.mesh is not None:
            raise ValueError(
                "absorb_stats takes pre-reduced statistics; under a "
                "dist-owned mesh use absorb()"
            )
        with self.dist.telemetry.span("absorb_stats", engine="streaming"):
            self.dist.dispatch()
            A = torch.as_tensor(A, dtype=torch.float32, device=self.device)
            b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
            n = torch.as_tensor(n, dtype=torch.float32, device=self.device)
            L = self._lossy_cholesky(self._gram(state) + A, A)
            b_new = state.b + b
            return StreamState(
                L=L, b=b_new, n=state.n + n, W=self._solve(L, b_new), wave=state.wave + 1,
                stale_waves=0, stale_samples=torch.zeros_like(state.stale_samples),
            )

    def tiered_absorber(self, tree, **kwargs):
        """The N-tier fold entry point: an overlapped
        :class:`repro_torch.federated.tiers.TieredAbsorber` pipeline over
        this engine (host-level tree; upper-tier reductions of segment t
        overlap the lower folds of segment t+1).  Lazy import — tiers
        builds on this module."""
        from repro_torch.federated.tiers import TieredAbsorber

        return TieredAbsorber(self, tree, **kwargs)

    @torch.no_grad()
    def refresh(self, state: StreamState) -> StreamState:
        """Force a classifier re-solve now (e.g. before a query burst)."""
        with self.dist.telemetry.span("refresh", engine="streaming"):
            self.dist.dispatch()
            return state._replace(
                W=self._solve(state.L, state.b), stale_waves=0,
                stale_samples=torch.zeros_like(state.stale_samples),
            )

    def classifier(self, state: StreamState) -> torch.Tensor:
        """The currently SERVED classifier (possibly stale, by policy)."""
        return state.W


class ReferenceArrivalLoop:
    """The per-arrival subtractive Woodbury path, one update per wave.

    Kept as the numerical foil: at small λ its carried A⁻¹ cancels
    catastrophically in fp32.  Padding rows are zero in the packed arrays,
    hence exact no-ops in the Woodbury algebra too.
    """

    def __init__(self, cfg: StreamConfig, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dispatches = 0

    def init(self, d: int) -> fed3r.Fed3ROnline:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return fed3r.init_online(d, self.cfg.n_classes, self.cfg.ridge_lambda, self.device)

    @torch.no_grad()
    def absorb(self, state: fed3r.Fed3ROnline, packed: PackedArrivals) -> fed3r.Fed3ROnline:
        for t in range(packed.n_waves):
            x = torch.as_tensor(packed.inputs[t], device=self.device)
            flat = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
            labels = torch.as_tensor(packed.labels[t], device=self.device).reshape(-1)
            state = fed3r.woodbury_update(state, flat, labels)
            self.dispatches += 1
        return state

    def classifier(self, state: fed3r.Fed3ROnline) -> torch.Tensor:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return fed3r.online_solution(state, self.cfg.normalize)


@torch.no_grad()
def batch_equivalent(
    packed: PackedArrivals, cfg: StreamConfig, device: Union[str, torch.device] = "cuda"
) -> Tuple[torch.Tensor, fed3r.Fed3RStats]:
    """The batch re-solve over the whole timeline — the parity oracle.

    Folds every wave's masked statistics with the batch path
    (client_stats/solve) and returns (W, stats); the streaming engine's
    final refreshed W must match this to fp32 tolerance.
    """
    dev = resolve_device(device)
    T, P, N = packed.mask.shape
    feats = torch.as_tensor(packed.inputs, device=dev)
    feats = feats.reshape((T * P * N,) + tuple(feats.shape[3:]))
    stats = fed3r.client_stats(
        feats,
        torch.as_tensor(packed.labels, device=dev).reshape(-1),
        cfg.n_classes,
        torch.as_tensor(packed.mask, device=dev).reshape(-1),
    )
    return fed3r.solve(stats, cfg.ridge_lambda, cfg.normalize), stats
