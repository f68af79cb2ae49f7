"""Asynchronous straggler-resilient FED3R round engine (merge-on-arrival).

The port of the reference's ``federated/async_engine.py`` on the merge
backend.  The synchronous engines assume every packed client of a wave or
cohort shows up: one straggler stalls the whole dispatch.  Fed3R's
statistics sum does not depend on the order in which clients arrive (paper
§4.3), so a late client's contribution can merge WHENEVER it arrives
without biasing W.  This engine exploits exactly that:

* **Merge-on-arrival.**  Each round owns K cohort *slots* inside a ring of
  ``staleness_rounds + 1`` device buffers; a client's statistics are written
  into its (canonically ordered) slot the moment the upload lands.  When a
  round *retires*, the slot axis reduces as a strict left fold in slot order
  and folds into the carried factored state via the additive update
  L ← chol(L Lᵀ + ΣA).  Slot contents do not depend on arrival order
  (exactly-once per client) and the folds run in round order, so the final W
  is **bitwise identical** to the synchronous barrier engine whenever the
  same uploads are delivered — under reordering, delay, duplication
  (deduped) and drop-with-retransmit.

* **Staleness bound.**  Round r accepts late uploads until round
  ``r + staleness_rounds`` closes; beyond that the upload is rejected
  (counted, never folded).

* **Adaptive per-client timeout/dropout.**  :class:`ClientHealth` demotes a
  client after ``demote_after`` missed round deadlines; demoted clients are
  not sampled for ``cooldown`` rounds, then re-admitted on probation and
  fully restored by one on-time delivery.

* **Timeout-tolerant secure aggregation.**  In ``secure=True`` mode the
  slots hold mod-2³² masked integer payloads
  (:func:`repro_torch.federated.compress.cohort_quantize_int8` +
  :func:`repro_torch.federated.secure_agg.mask_quantized_payload`); at
  retire the orphaned pairwise masks of clients that never arrived are
  re-derived and cancelled
  (:func:`repro_torch.federated.secure_agg.dropout_mask_correction_quantized`),
  so the recovered aggregate equals the unmasked survivor sum bit for bit.

Where the reference donates the slot ring to each jitted program, the port
writes it IN PLACE: a functional copy of ``A_slots`` (S × K × d² fp32) on
every upload would copy tens of MB a client at d = 1280.  So ``deliver``,
``close_round`` and ``drain`` CONSUME the state passed in (its slot buffers
are updated in place and belong to the returned state); a caller that
needs the old state clones it first.  Ring and slot indices are Python
ints, and the fold's factorization is the branch-free guarded Cholesky
(:func:`repro_torch.core.fed3r.psd_cholesky`, bit-identical where the
plain factorization succeeds), so neither ``deliver`` nor ``close_round``
waits for the card.

Distribution (:mod:`repro_torch.federated.dist`): under ``DistConfig(
aggregation="psum", mesh=...)`` every rank runs the same control plane on
the same events, and the slot ring's K axis is split over the ranks: rank
s holds the contiguous block of K/N slots filled with its round-robin
:func:`repro_torch.federated.dist.shard_cohort` share (shard-major slot
layout), writes only the uploads of the clients it owns and leaves every
other slot an exact zero.  A retire and the live classifier all-reduce the
ranks' partial cohort sums (through an N-tier tree with ``tree=``) before
the same fold on every rank.  Secure mode and psum are exclusive, as in the
reference.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fed3r
from repro_torch.core.fed3r import Fed3RFactored, Fed3RStats
from repro_torch.federated import compress, secure_agg
from repro_torch.federated.arrivals import ChaosSpec, UploadEvent, chaos_round_events
from repro_torch.federated.compress import IntPayload, WireFormat
from repro_torch.federated.dist import (
    DistConfig,
    DistContext,
    DistDispatchMixin,
    resolve_device,
    shard_cohort,
)
from repro_torch.federated.engine import shard_stats
from repro_torch.federated.telemetry import Telemetry, get_telemetry


@dataclass(frozen=True)
class AsyncConfig:
    """Static configuration of the asynchronous round engine.

    ``cohort`` is the slot count K per round (rounds may carry fewer
    clients; empty slots are exact no-ops).  ``deadline`` is the sim-time
    round close; ``staleness_rounds`` bounds how many subsequent closes a
    late upload may trail before it is rejected.  ``synchronous=True`` is
    the barrier baseline: rounds close only when every cohort client has
    delivered (the engine the async path is held bitwise against).
    ``early_close`` lets an async round close as soon as its cohort is
    complete (before the deadline).  ``secure=True`` switches the slots to
    mod-2³² masked integer payloads with dropout mask recovery at retire.
    """

    n_classes: int
    ridge_lambda: float
    cohort: int
    deadline: float = 1.0
    staleness_rounds: int = 1
    demote_after: int = 2
    cooldown: int = 2
    synchronous: bool = False
    early_close: bool = True
    normalize: bool = True
    dist: DistConfig = field(default_factory=DistConfig)  # backend/mesh
    wire: WireFormat = field(default_factory=WireFormat)
    secure: bool = False
    secure_seed: int = 0
    secure_tile: int = 128

    def __post_init__(self):
        if self.cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {self.cohort}")
        if self.deadline <= 0.0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")
        if self.staleness_rounds < 0:
            raise ValueError(
                f"staleness_rounds must be >= 0, got {self.staleness_rounds}"
            )
        if self.demote_after < 1:
            raise ValueError(f"demote_after must be >= 1, got {self.demote_after}")
        if self.secure and self.wire.kind != "fp32":
            raise ValueError(
                "secure mode owns its quantization (shared-scale int8 payloads); "
                "configure secure_tile instead of wire"
            )


class ClientHealth:
    """Adaptive per-client timeout/dropout bookkeeping (host control plane).

    A client accrues one *miss* per round deadline it blows; at
    ``demote_after`` consecutive misses it is demoted — excluded from
    cohort sampling for ``cooldown`` rounds, then re-admitted on probation.
    One on-time delivery fully restores it (misses reset, demotion
    cleared).

    Every transition lands in the telemetry flight recorder
    (``client_demoted`` with the probation round, ``client_readmitted``).
    """

    def __init__(
        self,
        demote_after: int = 2,
        cooldown: int = 2,
        telemetry: Optional[Telemetry] = None,
    ):
        self.demote_after = demote_after
        self.cooldown = cooldown
        self.misses: Dict[int, int] = {}
        self.demoted_at: Dict[int, int] = {}
        self.telemetry = get_telemetry() if telemetry is None else telemetry

    def on_time(self, client: int) -> None:
        """An on-time delivery: full recovery (re-admission on probation)."""
        self.misses[client] = 0
        if self.demoted_at.pop(client, None) is not None:
            self.telemetry.event("client_readmitted", client=int(client))

    def missed(self, client: int, round_id: int) -> None:
        """A blown round deadline; demote at the configured miss count."""
        self.misses[client] = self.misses.get(client, 0) + 1
        if self.misses[client] >= self.demote_after:
            if client not in self.demoted_at:
                self.telemetry.event(
                    "client_demoted",
                    client=int(client),
                    round=int(round_id),
                    misses=int(self.misses[client]),
                    probation_round=int(round_id) + self.cooldown,
                )
            self.demoted_at[client] = round_id

    def is_eligible(self, client: int, round_id: int) -> bool:
        """Sampled into cohorts?  Demoted clients sit out ``cooldown``
        rounds, then return on probation."""
        at = self.demoted_at.get(client)
        return at is None or round_id >= at + self.cooldown

    @property
    def demoted(self) -> Set[int]:
        return set(self.demoted_at)


class AsyncState(NamedTuple):
    """Device state: retired-global factored sums + the slot ring.

    ``A_slots``/``b_slots`` are ``(S, K, ...)`` with S =
    ``staleness_rounds + 1`` concurrently-open rounds (ring-indexed by
    ``round % S``) and K cohort slots each — fp32 statistics normally,
    mod-2³² masked int32 payloads in secure mode.  The engine writes the
    slot buffers in place.
    """

    L: torch.Tensor  # (d, d) fp32 Cholesky factor of retired A + λI
    b: torch.Tensor  # (d, C) fp32 retired class-conditional sums
    n: torch.Tensor  # () fp32 retired sample count
    W: torch.Tensor  # (d, C) fp32 classifier solved at the last retire
    A_slots: torch.Tensor  # (S, K, d, d) fp32 | int32 (secure)
    b_slots: torch.Tensor  # (S, K, d, C) fp32 | int32 (secure)
    n_slots: torch.Tensor  # (S, K) fp32


@dataclass
class _RoundMeta:
    """Host-side per-round control record."""

    cohort: List[int]
    slot_of: Dict[int, int]
    start_t: float
    closed: bool = False
    close_t: Optional[float] = None
    arrived: Set[int] = field(default_factory=set)
    on_time: Set[int] = field(default_factory=set)
    scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # secure (sA, sb)


def _left_fold(xs: torch.Tensor) -> torch.Tensor:
    """Σ over the leading axis as a strict left fold in index order — the
    same operand sequence on every device and at every K."""
    acc = xs[0].clone()
    for i in range(1, xs.shape[0]):
        acc.add_(xs[i])
    return acc


class AsyncRoundEngine(DistDispatchMixin):
    """Merge-on-arrival FED3R rounds with staleness, dropout, and chaos
    tolerance, on ``device`` (the card by default).

    The device state passes through every method (and is consumed by it:
    see the module docstring); round, cohort and health bookkeeping is the
    host control plane, as in the slot-serving engine.
    """

    def __init__(self, cfg: AsyncConfig, *, device: Union[str, torch.device] = "cuda"):
        if cfg.secure and cfg.dist.aggregation == "psum":
            raise ValueError("secure mode and psum aggregation are exclusive")
        if cfg.dist.mesh is not None and cfg.cohort % cfg.dist.data_shards != 0:
            raise ValueError(
                f"dist-owned mesh shards the K={cfg.cohort} slot axis over "
                f"{cfg.dist.data_shards} data shards: K must divide evenly"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.wire = cfg.wire.resolved()
        self.dist = DistContext(cfg.dist, engine="async")
        self.telemetry = self.dist.telemetry
        self.health = ClientHealth(
            cfg.demote_after, cfg.cooldown, telemetry=self.telemetry
        )
        self._rounds: Dict[int, _RoundMeta] = {}
        self._next_begin = 0
        self._next_retire = 0
        # fault/robustness counters (the chaos report) — homed in the
        # telemetry registry, one labeled cell per engine instance
        inst = self.telemetry.next_instance("async")
        self._fault_counters = {
            k: self.telemetry.counter(f"async_{k}_total", inst=inst)
            for k in (
                "folded",
                "duplicates",
                "stale_rejected",
                "late_folds",
                "dropped_uploads",
            )
        }

    # fault/robustness counters proxied onto their telemetry cells (the
    # ``+=`` call sites and the chaos report read them as ints)
    def _fault_count(name: str):  # noqa: N805 — descriptor factory, not a method
        def _get(self) -> int:
            return int(self._fault_counters[name].value)

        def _set(self, value: int) -> None:
            self._fault_counters[name].set(int(value))

        return property(_get, _set)

    folded = _fault_count("folded")
    duplicates = _fault_count("duplicates")
    stale_rejected = _fault_count("stale_rejected")
    late_folds = _fault_count("late_folds")
    dropped_uploads = _fault_count("dropped_uploads")
    del _fault_count

    # ---- device programs ---------------------------------------------------

    @property
    def ring_size(self) -> int:
        return self.cfg.staleness_rounds + 1

    @property
    def local_slots(self) -> int:
        """Slots of a round this rank holds (K, or K/N under a mesh)."""
        return self.cfg.cohort // self.cfg.dist.data_shards

    def init(self, d: int) -> AsyncState:
        S, K, C = self.ring_size, self.local_slots, self.cfg.n_classes
        fac = fed3r.init_factored(d, C, self.cfg.ridge_lambda, self.device)
        slot_dtype = torch.int32 if self.cfg.secure else torch.float32
        dev = self.device
        return AsyncState(
            L=fac.L,
            b=fac.b,
            n=torch.zeros((), dtype=torch.float32, device=dev),
            W=torch.zeros((d, C), dtype=torch.float32, device=dev),
            A_slots=torch.zeros((S, K, d, d), dtype=slot_dtype, device=dev),
            b_slots=torch.zeros((S, K, d, C), dtype=slot_dtype, device=dev),
            n_slots=torch.zeros((S, K), dtype=torch.float32, device=dev),
        )

    def _scatter(self, state: AsyncState, ring: int, slot: int, A, b, n) -> AsyncState:
        """Write one client's payload into its round slot, in place
        (exactly-once: dedupe happens on the host before).  The wire format
        applies here — the upload lands as the aggregator received it; fp32
        is the bitwise identity.  Under a mesh ``slot`` is a global slot:
        only its owner writes, into its local block."""
        slot -= self.dist.shard_index * self.local_slots
        if not 0 <= slot < self.local_slots:
            return state  # another rank's client: this block stays zero
        if not self.cfg.secure:
            A, b = compress.wire_roundtrip(A, b, self.wire)
        state.A_slots[ring, slot].copy_(A)
        state.b_slots[ring, slot].copy_(b)
        if n is None:
            state.n_slots[ring, slot].zero_()
        else:
            state.n_slots[ring, slot].copy_(n)
        return state

    def retire_fold(self, L, b, n, S_A, S_b, S_n):
        """Fold one round's reduced statistics into the factored state.

        Under int8, fp8 and secure payloads the factorization is guarded by
        the quantization-noise bound (:func:`compress.psd_cholesky`);
        otherwise by the fp32 rounding bound, bit-identical to the plain
        factorization where that succeeds.  Under psum the ranks' partial
        cohort sums all-reduce here (the identity under merge).
        """
        S_A, S_b, S_n = self.dist.all_reduce((S_A, S_b, S_n))
        G = L @ L.T + S_A
        if self.cfg.secure:
            # shared-scale int8-valued payloads: same error model as int8
            Lp = compress.psd_cholesky(
                G, compress.quant_spectral_bound(S_A, WireFormat(kind="int8"))
            )
        elif self.wire.kind in ("int8", "fp8"):
            Lp = compress.psd_cholesky(G, compress.quant_spectral_bound(S_A, self.wire))
        else:
            Lp = fed3r.psd_cholesky(G)
        bp = b + S_b
        W = fed3r.factored_solution(Fed3RFactored(L=Lp, b=bp), self.cfg.normalize)
        return Lp, bp, n + S_n, W

    def _free(self, state: AsyncState, ring: int) -> None:
        state.A_slots[ring].zero_()
        state.b_slots[ring].zero_()
        state.n_slots[ring].zero_()

    def _retire(self, state: AsyncState, ring: int) -> AsyncState:
        """Slot-order reduction + fold + ring free."""
        S_A = _left_fold(state.A_slots[ring])
        S_b = _left_fold(state.b_slots[ring])
        S_n = _left_fold(state.n_slots[ring])
        L, b, n, W = self.retire_fold(state.L, state.b, state.n, S_A, S_b, S_n)
        self._free(state, ring)
        return state._replace(L=L, b=b, n=n, W=W)

    def _retire_secure(self, state, ring, corrA, corrb, sA, sb) -> AsyncState:
        """Secure retire: mod-2³² slot sum, orphan-mask cancellation for the
        clients that never arrived (bit-exact in the ring), shared-scale
        dequantization, then the same factored fold."""
        qA, qb = state.A_slots[ring], state.b_slots[ring]
        S_qA, S_qb = qA[0], qb[0]
        for k in range(1, qA.shape[0]):
            S_qA = secure_agg.ring_add(S_qA, qA[k])
            S_qb = secure_agg.ring_add(S_qb, qb[k])
        S_qA = secure_agg.ring_sub(S_qA, corrA)  # wraps mod 2³²
        S_qb = secure_agg.ring_sub(S_qb, corrb)
        S_A, S_b = compress.dequantize_int_sum(
            IntPayload(qA=S_qA, qb=S_qb), sA, sb, self.cfg.secure_tile
        )
        S_n = _left_fold(state.n_slots[ring])
        L, b, n, W = self.retire_fold(state.L, state.b, state.n, S_A, S_b, S_n)
        self._free(state, ring)
        return state._replace(L=L, b=b, n=n, W=W)

    def _live(self, state: AsyncState) -> torch.Tensor:
        """The live classifier: retired state + every OPEN partial cohort,
        solved without disturbing the carried factor."""
        S, K = state.n_slots.shape
        S_A = _left_fold(state.A_slots.reshape((S * K,) + tuple(state.A_slots.shape[2:])))
        S_b = _left_fold(state.b_slots.reshape((S * K,) + tuple(state.b_slots.shape[2:])))
        S_A, S_b = self.dist.all_reduce((S_A, S_b))
        G = state.L @ state.L.T + S_A
        if self.wire.kind in ("int8", "fp8"):
            L = compress.psd_cholesky(G, compress.quant_spectral_bound(S_A, self.wire))
        else:
            L = fed3r.psd_cholesky(G)
        return fed3r.factored_solution(
            Fed3RFactored(L=L, b=state.b + S_b), self.cfg.normalize
        )

    # ---- host control plane ------------------------------------------------

    def begin_round(
        self,
        round_id: int,
        cohort: Sequence[int],
        start_t: float,
        scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> None:
        """Open round ``round_id`` over ``cohort`` (canonical slot order =
        sorted client ids).  Rounds must begin contiguously and the ring
        slot must have retired (``deadline <= cadence`` guarantees it)."""
        if round_id != self._next_begin:
            raise ValueError(
                f"rounds begin contiguously: expected {self._next_begin}, "
                f"got {round_id}"
            )
        if round_id - self._next_retire >= self.ring_size:
            raise RuntimeError(
                f"ring overflow: round {round_id} needs the slot of round "
                f"{self._next_retire} which has not retired (raise "
                "staleness_rounds or the round cadence)"
            )
        ids = sorted(int(c) for c in cohort)
        if len(set(ids)) != len(ids):
            raise ValueError("cohort has duplicate client ids")
        if len(ids) > self.cfg.cohort:
            raise ValueError(
                f"cohort of {len(ids)} exceeds K={self.cfg.cohort} slots"
            )
        if self.cfg.secure and scales is None:
            raise ValueError("secure rounds need the shared (sA, sb) scales")
        if self.cfg.dist.mesh is not None:
            # shard-major slot layout: rank s owns the slots [s·K/N, (s+1)·K/N),
            # filled with its round-robin shard_cohort share
            n, k = self.cfg.dist.data_shards, self.local_slots
            slot_of = {c: s * k + j for s in range(n) for j, c in enumerate(shard_cohort(ids, s, n))}
        else:
            slot_of = {c: i for i, c in enumerate(ids)}
        self._rounds[round_id] = _RoundMeta(
            cohort=ids,
            slot_of=slot_of,
            start_t=start_t,
            scales=scales,
        )
        self._next_begin = round_id + 1

    def round_full(self, round_id: int) -> bool:
        meta = self._rounds.get(round_id)
        return meta is not None and len(meta.arrived) == len(meta.cohort)

    @torch.no_grad()
    def deliver(
        self, state: AsyncState, ev: UploadEvent, payload, now: Optional[float] = None
    ) -> Tuple[AsyncState, str]:
        """Fold one upload the moment it lands.  Returns the advanced state
        (``state`` itself, its slot written in place) and a status:
        ``folded`` (on time), ``late`` (after close, inside the staleness
        bound), ``duplicate`` (deduped, not re-folded), or ``stale`` (round
        already retired — rejected)."""
        r, c = ev.round_id, ev.client
        if r < self._next_retire:
            self.stale_rejected += 1
            self.telemetry.event("staleness_drop", client=int(c), round=int(r))
            return state, "stale"
        meta = self._rounds.get(r)
        if meta is None:
            raise ValueError(f"deliver for round {r} before begin_round")
        if c not in meta.slot_of:
            raise ValueError(f"client {c} is not in round {r}'s cohort")
        if c in meta.arrived:
            self.duplicates += 1
            return state, "duplicate"
        meta.arrived.add(c)
        ring = r % self.ring_size
        slot = meta.slot_of[c]
        if self.cfg.secure:
            A, b, n = payload.qA, payload.qb, getattr(payload, "n", None)
        else:
            A, b, n = payload.A, payload.b, payload.n
        with self.telemetry.span("fold", engine="async"):
            self.dist.dispatch()
            state = self._scatter(state, ring, slot, A, b, n)
        if meta.closed:
            self.late_folds += 1
            return state, "late"
        meta.on_time.add(c)
        self.health.on_time(c)
        self.folded += 1
        return state, "folded"

    @torch.no_grad()
    def close_round(
        self, state: AsyncState, round_id: int, now: Optional[float] = None
    ) -> AsyncState:
        """Close a round (its deadline passed, or its cohort completed):
        record deadline misses, then retire every round whose staleness
        window has fully elapsed."""
        meta = self._rounds[round_id]
        if meta.closed:
            return state
        meta.closed = True
        meta.close_t = now
        for c in meta.cohort:
            if c not in meta.arrived:
                self.health.missed(c, round_id)
        return self._maybe_retire(state)

    def _maybe_retire(self, state: AsyncState) -> AsyncState:
        while self._next_retire < self._next_begin:
            r = self._next_retire
            watcher = self._rounds.get(r + self.cfg.staleness_rounds)
            if watcher is None or not watcher.closed:
                break  # staleness window still open; drain() forces it
            state = self._retire_round(state, r)
        return state

    def _retire_round(self, state: AsyncState, r: int) -> AsyncState:
        with self.telemetry.span("retire", engine="async"):
            meta = self._rounds[r]
            missing = [c for c in meta.cohort if c not in meta.arrived]
            self.dropped_uploads += len(missing)
            if missing:
                self.telemetry.event(
                    "upload_dropped", round=int(r), clients=[int(c) for c in missing]
                )
            ring = r % self.ring_size
            self.dist.dispatch()
            if self.cfg.secure:
                like = IntPayload(
                    qA=torch.zeros(state.A_slots.shape[2:], dtype=torch.int32,
                                   device=state.A_slots.device),
                    qb=torch.zeros(state.b_slots.shape[2:], dtype=torch.int32,
                                   device=state.b_slots.device),
                )
                survivors = sorted(meta.arrived)
                if missing:
                    corr = secure_agg.dropout_mask_correction_quantized(
                        survivors, missing, self.cfg.secure_seed + r, like
                    )
                    self.telemetry.event(
                        "secure_mask_recovery",
                        round=int(r),
                        missing=len(missing),
                        survivors=len(survivors),
                    )
                else:
                    corr = like
                sA, sb = meta.scales
                state = self._retire_secure(state, ring, corr.qA, corr.qb, sA, sb)
            else:
                state = self._retire(state, ring)
            self._next_retire = r + 1
            return state

    @torch.no_grad()
    def drain(self, state: AsyncState) -> AsyncState:
        """Close every open round (in order) and retire everything."""
        for r in range(self._next_retire, self._next_begin):
            if not self._rounds[r].closed:
                state = self.close_round(state, r)
        while self._next_retire < self._next_begin:
            state = self._retire_round(state, self._next_retire)
        return state

    @torch.no_grad()
    def live_classifier(self, state: AsyncState) -> torch.Tensor:
        """Serve NOW: retired sums + all open partial cohorts.  Secure mode
        serves the last retired W — open slots are masked and unreadable by
        design."""
        if self.cfg.secure:
            return state.W
        self.dist.dispatch()
        return self._live(state)

    def classifier(self, state: AsyncState) -> torch.Tensor:
        """The classifier as of the last retire."""
        return state.W

    def report(self) -> dict:
        """The chaos/robustness counters plus per-round completion times."""
        completions = {
            r: (None if m.close_t is None else m.close_t - m.start_t)
            for r, m in sorted(self._rounds.items())
        }
        return {
            "folded": self.folded,
            "duplicates": self.duplicates,
            "late_folds": self.late_folds,
            "stale_rejected": self.stale_rejected,
            "dropped_uploads": self.dropped_uploads,
            "demoted": sorted(self.health.demoted),
            "completion": completions,
            "dispatches": self.dispatches,
        }


# ---------------------------------------------------------------------------
# Drivers — timeline execution under the async cadence vs the sync barrier
# ---------------------------------------------------------------------------


def run_chaos_timeline(
    engine: AsyncRoundEngine,
    state: AsyncState,
    cohorts: Sequence[Sequence[int]],
    events: Sequence[UploadEvent],
    payload_for: Callable[[int, int], object],
    *,
    interval: Optional[float] = None,
    scales_for: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[AsyncState, dict]:
    """Execute a (chaos-injected) upload timeline end to end.

    ``payload_for(client, round_id)`` supplies the upload the server
    receives (a :class:`~repro_torch.core.fed3r.Fed3RStats`, or the masked
    :class:`~repro_torch.federated.compress.IntPayload` in secure mode, with
    ``scales_for(round_id)`` providing the round's shared scales).

    Async engines run rounds on a fixed cadence (``interval``, default the
    deadline): round r begins at r·interval, closes at its deadline (or as
    soon as its cohort completes, if ``early_close``), and late uploads
    keep folding until the staleness bound retires the round.  The
    synchronous baseline (``cfg.synchronous``) instead BARRIERS: each
    round's completion is the straggler's arrival, and the next round
    starts only then.
    """
    cfg = engine.cfg
    interval = cfg.deadline if interval is None else interval
    if interval < cfg.deadline:
        raise ValueError("round cadence must be >= the deadline")
    per_round: Dict[int, List[UploadEvent]] = {}
    for ev in events:
        per_round.setdefault(ev.round_id, []).append(ev)

    def scales(r):
        return scales_for(r) if scales_for is not None else None

    if cfg.synchronous:
        t = 0.0
        completion: List[float] = []
        for r, cohort in enumerate(cohorts):
            engine.begin_round(r, cohort, t, scales=scales(r))
            evs = sorted(per_round.get(r, []), key=lambda e: (e.t, e.client, e.attempt))
            first: Dict[int, float] = {}
            for ev in evs:
                state, _ = engine.deliver(state, ev, payload_for(ev.client, r), now=t + ev.t)
                first.setdefault(ev.client, ev.t)
            comp = max(first.values(), default=0.0)
            state = engine.close_round(state, r, now=t + comp)
            completion.append(comp)
            t += comp
        state = engine.drain(state)
        rep = engine.report()
        rep["makespan"] = t
        rep["completion"] = completion
        return state, rep

    # at equal timestamps: deliveries first (a t == deadline upload is on
    # time), then closes (whose retires free ring slots), then begins
    counter = itertools.count()
    agenda: List[Tuple[float, int, int, str, object]] = []
    for r in range(len(cohorts)):
        start = r * interval
        heapq.heappush(agenda, (start, 2, next(counter), "begin", r))
        heapq.heappush(agenda, (start + cfg.deadline, 1, next(counter), "close", r))
        for ev in per_round.get(r, []):
            heapq.heappush(agenda, (start + ev.t, 0, next(counter), "ev", ev))
    completion_by_round: Dict[int, float] = {}
    while agenda:
        t, _, _, kind, x = heapq.heappop(agenda)
        if kind == "begin":
            engine.begin_round(x, cohorts[x], t, scales=scales(x))
        elif kind == "ev":
            state, status = engine.deliver(state, x, payload_for(x.client, x.round_id), now=t)
            r = x.round_id
            if (
                status == "folded"
                and cfg.early_close
                and engine.round_full(r)
                and not engine._rounds[r].closed
            ):
                state = engine.close_round(state, r, now=t)
                completion_by_round[r] = t - engine._rounds[r].start_t
        else:  # close (deadline)
            if not engine._rounds[x].closed:
                state = engine.close_round(state, x, now=t)
                completion_by_round[x] = cfg.deadline
    state = engine.drain(state)
    rep = engine.report()
    completion = [completion_by_round.get(r, cfg.deadline) for r in range(len(cohorts))]
    rep["completion"] = completion
    # the async makespan: the cadence carries R rounds, plus the final
    # round's close lag — stragglers never extend it
    rep["makespan"] = (len(cohorts) - 1) * interval + (
        completion[-1] if completion else 0.0
    )
    return state, rep


def run_adaptive_rounds(
    engine: AsyncRoundEngine,
    state: AsyncState,
    n_clients: int,
    per_round: int,
    n_rounds: int,
    latency: np.ndarray,
    spec: ChaosSpec,
    payload_for: Callable[[int, int], object],
    *,
    seed: int = 0,
    interval: Optional[float] = None,
) -> Tuple[AsyncState, dict]:
    """Adaptive-dropout rounds: cohorts are sampled per round from the
    clients the health tracker currently admits, so persistent stragglers
    stop being waited on after ``demote_after`` blown deadlines and
    re-enter on probation after ``cooldown``.  Fault events are generated
    per round with :func:`repro_torch.federated.arrivals.chaos_round_events`,
    so a replay with the same seed is byte-identical.
    """
    cfg = engine.cfg
    if cfg.synchronous:
        raise ValueError("adaptive rounds are the async path; the sync "
                         "baseline replays fixed cohorts via run_chaos_timeline")
    interval = cfg.deadline if interval is None else interval
    counter = itertools.count()
    agenda: List[Tuple[float, int, int, str, object]] = []
    completion_by_round: Dict[int, float] = {}
    cohorts: List[List[int]] = []

    def flush(state, upto: float):
        while agenda and agenda[0][0] <= upto:
            t, _, _, kind, x = heapq.heappop(agenda)
            if kind == "ev":
                state, status = engine.deliver(
                    state, x, payload_for(x.client, x.round_id), now=t
                )
                r = x.round_id
                if (
                    status == "folded"
                    and cfg.early_close
                    and engine.round_full(r)
                    and not engine._rounds[r].closed
                ):
                    state = engine.close_round(state, r, now=t)
                    completion_by_round[r] = t - engine._rounds[r].start_t
            else:
                if not engine._rounds[x].closed:
                    state = engine.close_round(state, x, now=t)
                    completion_by_round[x] = cfg.deadline
        return state

    for r in range(n_rounds):
        start = r * interval
        state = flush(state, start)
        eligible = [c for c in range(n_clients) if engine.health.is_eligible(c, r)]
        rng = np.random.default_rng((seed, r, 0xADAF))
        take = min(per_round, len(eligible))
        cohort = sorted(
            int(eligible[i])
            for i in rng.choice(len(eligible), size=take, replace=False)
        )
        cohorts.append(cohort)
        engine.begin_round(r, cohort, start)
        heapq.heappush(agenda, (start + cfg.deadline, 1, next(counter), "close", r))
        for ev in chaos_round_events(cohort, latency, spec, r):
            heapq.heappush(agenda, (start + ev.t, 0, next(counter), "ev", ev))
    state = flush(state, float("inf"))
    state = engine.drain(state)
    rep = engine.report()
    completion = [completion_by_round.get(r, cfg.deadline) for r in range(n_rounds)]
    rep["completion"] = completion
    rep["cohorts"] = cohorts
    rep["makespan"] = (n_rounds - 1) * interval + (completion[-1] if completion else 0.0)
    return state, rep


@torch.no_grad()
def client_payloads(
    dataset, n_classes: int, device: Union[str, torch.device] = "cuda"
) -> Dict[int, Fed3RStats]:
    """Every client's (A_k, b_k, n_k) once, on ``device`` — the upload the
    chaos timeline then delivers and re-delivers: one ``fed3r_stats``
    launch a client (:func:`repro_torch.federated.engine.shard_stats`)."""
    dev = resolve_device(device)
    out: Dict[int, Fed3RStats] = {}
    for k in range(dataset.n_clients):
        cd = dataset.client(k)
        out[k] = shard_stats(
            torch.as_tensor(cd.features, dtype=torch.float32, device=dev),
            torch.as_tensor(cd.labels, device=dev),
            n_classes,
        )
    return out
