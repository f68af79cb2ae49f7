"""Continuous-batching slot-based head-serving engine (absorb/solve/serve).

The port of the reference's ``launch/serving_engine.py``.  Where
``launch/serve_heads`` answers each query burst synchronously per tenant —
solve-on-miss inside the request path, whole-cache invalidation on every
absorb — this engine runs the JetStream/MaxText-decode shape
(prefill/insert/generate ≅ absorb/solve/serve) over S fixed
device-resident head slots (:class:`repro_torch.federated.slots.SlotTable`):

* **absorb** — fold an arrival segment into the global factored state via
  the streaming engine (ONE dispatch per segment, one ``chol_gram`` launch
  a wave), bump the global stream
  version and the per-tenant versions of the clients whose OWN statistics
  arrived (version-segmented invalidation; ``invalidation="strict"``
  restores the dirty-sweep-everything policy for parity with the
  synchronous path);
* **solve** — fill-empty-slots: ALL pending cache-miss tenants of a tick
  (stale residents re-solve in place; new tenants claim free slots, then
  evict the coldest by recency/popularity) batch-solve in ONE dispatch —
  the personalization engine's core (one ``batched_chol_gram`` launch)
  plus a scatter into the ``(S, d, C)`` slot table, updated in place, and
  a refresh of the pinned global slot.  Padded cohort rows have no slot:
  the host drops them before the scatter (the reference scatters them to
  an out-of-range index that JAX drops; on the card an out-of-range index
  is a device-side assert);
* **serve** — ONE dispatch answers every in-flight query against the
  resident table: a gather of per-query slot rows + one batched matmul.
  No per-tenant Python loop, no per-burst head stacking/transfer —
  dispatches per batch are O(1) in the tenant count by construction.

Around the stages: an admission-controlled request queue (bounded depth —
overflow is shed at enqueue; ``deadline_ticks`` sheds requests that waited
through too many ticks, the adaptive-dropout analogue for serving), and
in-flight batching of queries across tenants between solve ticks
(``max_batch`` caps a tick's serve width so traffic bursts spread over
ticks instead of unbounded batches).  Stage wall-times and dispatch
counters are tracked per stage, decode-microbenchmark style.  Each stage
ends in ``torch.cuda.synchronize()`` on the card (where the reference
blocks until its arrays are ready), so the stage times and latencies
include the device's work.

Observability (:mod:`repro_torch.federated.telemetry`): every stage runs under
a span (``span_seconds{engine=serving, stage=tick/solve, ...}``), the
stage dispatch counters and hit/miss/shed tallies are homed in the
registry (``engine_dispatches_total{engine=serving, stage=...}``,
``serving_cache_*_total``, ``serving_shed_total{reason=...}``) behind
back-compat attributes, per-request latency feeds the log-bucketed
``serving_latency_seconds`` histogram, and overflow/deadline sheds land
in the flight recorder.  All timing is on the monotonic
``time.perf_counter`` clock — the wall clock steps backwards under NTP,
which can make p99 and deadline accounting go negative.

``launch/serve_heads``/``launch/serve_stream`` expose this engine behind
``--engine slots`` as thin compatibility drivers with unchanged reports.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fed3r
from repro_torch.core.fed3r import Fed3RFactored
from repro_torch.data.pipeline import pack_personal_cohort
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.personalization import (
    PersonalizationEngine,
    PersonalizeConfig,
)
from repro_torch.federated.slots import SlotTable
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
from repro_torch.federated.telemetry import Telemetry, get_telemetry


@dataclass(frozen=True)
class ServingConfig:
    """Static serving-engine configuration.

    ``n_slots`` sizes the device-resident head table (slot 0 is pinned to
    the global head, so ``n_slots - 1`` tenants can be resident).
    ``queue_depth`` bounds the admission queue — enqueues beyond it are
    SHED, not buffered.  ``deadline_ticks`` (optional) sheds a queued
    request once it has waited through more than that many full ticks
    unserved; ``max_batch`` (optional) caps how many requests one tick
    serves, which is what makes waiting — and therefore deadlines —
    possible.  ``solve_bucket``/``serve_bucket`` round the solve-cohort
    and serve-batch widths up to fixed buckets (the reference's jit-trace
    reuse; here they keep the solve's shapes those of ``serve_heads``'
    ``cohort_round_to`` cohorts).  ``invalidation`` picks the staleness policy:
    ``"segmented"`` re-solves only tenants whose OWN statistics changed
    (resident heads tolerate global-state staleness until their tenant is
    touched; the pinned global slot refreshes every tick it is stale),
    ``"strict"`` dirty-marks every resident head on any absorb — the
    synchronous ``serve_heads`` semantics, kept for answer parity.
    """

    n_classes: int
    ridge_lambda: float = 1e-2
    n_slots: int = 64
    queue_depth: int = 4096
    deadline_ticks: Optional[int] = None
    max_batch: Optional[int] = None
    solve_bucket: int = 8
    serve_bucket: int = 32
    invalidation: str = "segmented"  # "segmented" | "strict"
    alpha_grid: Tuple[float, ...] = (0.0, 0.5, 1.0, 2.0, 4.0)
    normalize: bool = True
    selection: str = "error"

    def __post_init__(self):
        if self.invalidation not in ("segmented", "strict"):
            raise ValueError(f"unknown invalidation policy: {self.invalidation!r}")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.deadline_ticks is not None and self.deadline_ticks < 0:
            raise ValueError(
                f"deadline_ticks must be >= 0, got {self.deadline_ticks}"
            )
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.solve_bucket < 1 or self.serve_bucket < 1:
            raise ValueError("solve_bucket and serve_bucket must be >= 1")


class Request(NamedTuple):
    """One admitted query: tenant id, feature row, and its arrival stamps."""

    tenant: int
    x: np.ndarray  # (d,)
    tick: int  # ticks completed when the request was admitted
    t_enq: float  # monotonic perf_counter at admission (latency accounting)


class ServingEngine:
    """S-slot continuous-batching server over the streaming + personalization
    engines.

    ``dataset`` is the per-tenant statistics store (anything with the
    ``n_clients``/``client``/``client_sizes`` surface, e.g. a
    :class:`repro_torch.data.pipeline.FederatedDataset` or a
    :class:`repro_torch.federated.slots.TenantUniverse`); tenants outside
    ``range(dataset.n_clients)`` are served the pinned global head.
    Everything runs on ``device`` (the card by default).
    """

    def __init__(
        self, cfg: ServingConfig, dataset, *, telemetry: Optional[Telemetry] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.telemetry = get_telemetry() if telemetry is None else telemetry
        self.stream = StreamingEngine(StreamConfig(
            n_classes=cfg.n_classes, ridge_lambda=cfg.ridge_lambda,
            normalize=cfg.normalize,
        ), device=self.device)
        self.pers = PersonalizationEngine(PersonalizeConfig(
            n_classes=cfg.n_classes, alpha_grid=cfg.alpha_grid,
            normalize=cfg.normalize, selection=cfg.selection,
        ), device=self.device)
        # every tick's cohort pads to the dataset-global sample capacity, as
        # serve_heads' cohorts do
        self.max_n = int(dataset.client_sizes().max())
        self.state = None  # StreamState, set by init()
        self.table: Optional[SlotTable] = None
        self.queue: Deque[Request] = deque()
        self.ticks = 0
        self.global_version = 0
        self.tenant_versions: Dict[int, int] = {}
        # stage dispatch counters + wall-times (decode-microbenchmark style),
        # homed in the telemetry registry behind back-compat properties;
        # one labeled cell per engine instance keeps N servers independent
        t, inst = self.telemetry, self.telemetry.next_instance("serving")
        self._cells = {
            "absorb_dispatches": t.counter(
                "engine_dispatches_total", engine="serving", stage="absorb", inst=inst
            ),
            "solve_dispatches": t.counter(
                "engine_dispatches_total", engine="serving", stage="solve", inst=inst
            ),
            "serve_dispatches": t.counter(
                "engine_dispatches_total", engine="serving", stage="serve", inst=inst
            ),
            "hits": t.counter("serving_cache_hits_total", inst=inst),
            "misses": t.counter("serving_cache_misses_total", inst=inst),
            "shed_overflow": t.counter(
                "serving_shed_total", reason="overflow", inst=inst
            ),
            "shed_deadline": t.counter(
                "serving_shed_total", reason="deadline", inst=inst
            ),
            "slot_overflow": t.counter("serving_slot_overflow_total", inst=inst),
        }
        self._latency_hist = t.histogram("serving_latency_seconds", inst=inst)
        self.stage_s = {"absorb": 0.0, "solve": 0.0, "serve": 0.0}

    # counters proxied onto their telemetry cells — `self.hits += 1` and the
    # reset-to-zero idiom keep working unchanged
    def _cell(name: str):  # noqa: N805 — descriptor factory, not a method
        def _get(self) -> int:
            return int(self._cells[name].value)

        def _set(self, value: int) -> None:
            self._cells[name].set(int(value))

        return property(_get, _set)

    absorb_dispatches = _cell("absorb_dispatches")
    solve_dispatches = _cell("solve_dispatches")
    serve_dispatches = _cell("serve_dispatches")
    hits = _cell("hits")  # fresh-resident tenant lookups
    misses = _cell("misses")  # tenant lookups that needed a solve
    shed_overflow = _cell("shed_overflow")
    shed_deadline = _cell("shed_deadline")
    slot_overflow = _cell("slot_overflow")  # tenants served global, no slot
    del _cell

    # ---- device stages ----------------------------------------------------

    def _sync(self) -> None:
        """Wait for the card's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve_impl(self, heads, L, b, x, y, m, ho, rows, slots):
        """ONE dispatch: batch-solve the miss cohort (the personalization
        engine's α sweep and refit), write cohort rows ``rows`` into table
        slots ``slots`` (padded rows are not in ``rows``: the host left them
        out), and refresh the pinned global slot — all in place."""
        W_k, _, _ = self.pers._heads_impl(L, b, x, y, m, ho)
        self._refresh_global_impl(heads, L, b)
        heads[slots] = W_k[rows]

    def _refresh_global_impl(self, heads, L, b):
        """The no-miss tick's solve stage: refresh only the global slot."""
        heads[SlotTable.GLOBAL_SLOT] = fed3r.factored_solution(
            Fed3RFactored(L=L, b=b), self.cfg.normalize
        )

    def _serve_impl(self, heads, slot_idx, xs):
        """ONE dispatch answers the whole in-flight batch: gather each
        query's resident head row and contract — O(1) dispatches in the
        tenant count."""
        return torch.einsum("qd,qdc->qc", xs, heads[slot_idx])

    # ---- host API ---------------------------------------------------------

    def init(self, d: int) -> None:
        self.state = self.stream.init(d)
        self.table = SlotTable(self.cfg.n_slots, d, self.cfg.n_classes, self.device)

    def absorb(self, packed, params=None):
        """Absorb stage: fold an arrival segment (one dispatch), advance the
        global version, and bump the per-tenant versions of the clients
        whose own statistics arrived."""
        t0 = time.perf_counter()
        with self.telemetry.span("absorb", engine="serving"):
            self.state, trace = self.stream.absorb(self.state, packed, params)
            self._sync()
        self.stage_s["absorb"] += time.perf_counter() - t0
        self.absorb_dispatches += 1
        self.global_version += 1
        touched = np.unique(np.asarray(packed.client_ids))
        for t in touched[touched >= 0]:
            t = int(t)
            self.tenant_versions[t] = self.tenant_versions.get(t, 0) + 1
        return trace

    def _has_data(self, tenant: int) -> bool:
        return 0 <= tenant < self.dataset.n_clients

    def _fresh(self, slot: int) -> bool:
        """Is the resident head current under the invalidation policy?"""
        if self.cfg.invalidation == "strict":
            return int(self.table.global_version[slot]) == self.global_version
        tenant = int(self.table.tenant[slot])
        return int(self.table.tenant_version[slot]) == self.tenant_versions.get(
            tenant, 0
        )

    def enqueue(self, tenant_ids: Sequence[int], xs: np.ndarray) -> Tuple[int, int]:
        """Admission control: append to the bounded queue; overflow is shed.

        Returns ``(admitted, shed)``.
        """
        now = time.perf_counter()
        xs = np.asarray(xs)
        admitted = shed = 0
        for cid, x in zip(tenant_ids, xs):
            if len(self.queue) >= self.cfg.queue_depth:
                shed += 1
            else:
                self.queue.append(Request(int(cid), x, self.ticks, now))
                admitted += 1
        self.shed_overflow += shed
        if shed:
            self.telemetry.event(
                "request_shed", reason="overflow", shed=shed, tick=self.ticks
            )
        return admitted, shed

    def _dequeue(self) -> Tuple[List[Request], int]:
        """Take this tick's in-flight batch: deadline-shed the expired, then
        up to ``max_batch`` requests in arrival order."""
        batch: List[Request] = []
        shed = 0
        cap = self.cfg.max_batch or len(self.queue)
        while self.queue and len(batch) < cap:
            r = self.queue.popleft()
            waited = self.ticks - r.tick  # full ticks waited through
            if (
                self.cfg.deadline_ticks is not None
                and waited > self.cfg.deadline_ticks
            ):
                shed += 1
                continue
            batch.append(r)
        self.shed_deadline += shed
        if shed:
            self.telemetry.event(
                "request_shed", reason="deadline", shed=shed, tick=self.ticks
            )
        return batch, shed

    @torch.no_grad()
    def tick(self) -> Tuple[Optional[torch.Tensor], dict]:
        """One solve+serve tick over the in-flight batch.

        Returns ``(scores, report)``: ``scores`` is ``(Q, C)`` aligned with
        ``report["tenants"]`` (the served requests in arrival order), or
        ``None`` when the tick served nothing.  The report carries the
        shed/eviction/mode accounting — the serving analogue of the
        staleness trace.
        """
        self.ticks += 1
        batch, shed = self._dequeue()
        report = {
            "queries": len(batch),
            "per_tenant": 0,
            "global": 0,
            "solved_now": 0,
            "shed": shed,
            "slot_overflow": 0,
            "evictions": self.table.evictions,
            "modes": [],
            "tenants": [r.tenant for r in batch],
            "latency_s": [],
        }
        if not batch:
            return None, report

        # -- solve stage: batch every pending miss into free slots ----------
        uniq: List[int] = []
        seen = set()
        for r in batch:
            if self._has_data(r.tenant) and r.tenant not in seen:
                seen.add(r.tenant)
                uniq.append(r.tenant)
        in_place: List[Tuple[int, int]] = []  # (tenant, its stale slot)
        need_slot: List[int] = []
        protect: List[int] = []
        for t in uniq:
            s = self.table.slot_of(t)
            if s is None:
                need_slot.append(t)
                self.misses += 1
            elif self._fresh(s):
                protect.append(s)
                self.hits += 1
            else:
                in_place.append((t, s))
                protect.append(s)
                self.misses += 1
        taken = self.table.take_slots(len(need_slot), protect=protect)
        placed = list(zip(need_slot, taken))
        overflow = need_slot[len(taken):]  # no slot: served global this tick
        self.slot_overflow += len(overflow)
        solved = in_place + placed

        t0 = time.perf_counter()
        span = self.telemetry.span("solve", engine="serving")
        span.__enter__()
        if solved:
            slot_map = {t: s for t, s in solved}
            clients = []
            for t, _ in solved:
                cd = self.dataset.client(t)
                clients.append((np.asarray(cd.features), np.asarray(cd.labels)))
            pad = self.cfg.solve_bucket
            packed = pack_personal_cohort(
                clients,
                client_ids=[t for t, _ in solved],
                cohort_size=-(-len(solved) // pad) * pad,
                max_n=self.max_n,
            )
            # cohort rows are canonically sorted; padded rows have no slot and
            # are left out here, on the host, before the device scatter
            rows = [i for i, c in enumerate(packed.client_ids) if int(c) in slot_map]
            slots = [slot_map[int(packed.client_ids[i])] for i in rows]
            dev = self.device
            self._solve_impl(
                self.table.heads,
                self.state.L,
                self.state.b,
                torch.as_tensor(packed.inputs, device=dev),
                torch.as_tensor(packed.labels, device=dev),
                torch.as_tensor(packed.mask, device=dev),
                torch.as_tensor(packed.holdout, device=dev),
                torch.as_tensor(rows, dtype=torch.long, device=dev),
                torch.as_tensor(slots, dtype=torch.long, device=dev),
            )
            self.solve_dispatches += 1
            self.table.assign(
                [s for _, s in solved],
                [t for t, _ in solved],
                [self.tenant_versions.get(t, 0) for t, _ in solved],
                self.global_version,
                self.ticks,
            )
        elif self.table.global_slot_version != self.global_version:
            self._refresh_global_impl(self.table.heads, self.state.L, self.state.b)
            self.solve_dispatches += 1
            self.table.global_slot_version = self.global_version
        self._sync()
        span.__exit__(None, None, None)
        self.stage_s["solve"] += time.perf_counter() - t0
        report["solved_now"] = len(solved)
        report["slot_overflow"] = len(overflow)

        # -- serve stage: one gather + batched matmul for the whole batch ---
        global_now = set(overflow)
        slot_idx = np.zeros((len(batch),), np.int32)
        for i, r in enumerate(batch):
            s = (
                self.table.slot_of(r.tenant)
                if self._has_data(r.tenant) and r.tenant not in global_now
                else None
            )
            if s is None:
                slot_idx[i] = SlotTable.GLOBAL_SLOT
                report["modes"].append("global")
            else:
                slot_idx[i] = s
                report["modes"].append("per-tenant")
        report["per_tenant"] = report["modes"].count("per-tenant")
        report["global"] = report["modes"].count("global")

        xs = np.stack([r.x for r in batch]).astype(np.float32)
        q = len(batch)
        bucket = -(-q // self.cfg.serve_bucket) * self.cfg.serve_bucket
        xs_pad = np.zeros((bucket,) + xs.shape[1:], np.float32)
        xs_pad[:q] = xs
        idx_pad = np.zeros((bucket,), np.int32)
        idx_pad[:q] = slot_idx
        t0 = time.perf_counter()
        with self.telemetry.span("serve", engine="serving"):
            scores = self._serve_impl(
                self.table.heads,
                torch.as_tensor(idx_pad, dtype=torch.long, device=self.device),
                torch.as_tensor(xs_pad, device=self.device),
            )[:q]
            self._sync()
        done = time.perf_counter()
        self.stage_s["serve"] += done - t0
        self.serve_dispatches += 1
        served_slots, counts = np.unique(slot_idx, return_counts=True)
        self.table.touch(served_slots.tolist(), counts.tolist(), self.ticks)
        report["latency_s"] = [done - r.t_enq for r in batch]
        if self.telemetry.enabled:
            observe = self._latency_hist.observe
            for lat in report["latency_s"]:
                observe(lat)
        report["evictions"] = self.table.evictions
        return scores, report

    def query(
        self, tenant_ids: Sequence[int], xs: np.ndarray
    ) -> Tuple[torch.Tensor, dict]:
        """Synchronous convenience: admit a burst and tick until it drains.

        The compatibility surface for the ``serve_heads``/``serve_stream``
        drivers (no ``max_batch``/deadline pressure ⇒ one tick).  Raises if
        admission control shed part of the burst — callers that want
        shedding semantics drive :meth:`enqueue`/:meth:`tick` directly.
        """
        admitted, shed = self.enqueue(tenant_ids, xs)
        if shed:
            raise RuntimeError(
                f"query burst overflowed the admission queue ({shed} shed); "
                f"use enqueue()/tick() for load-shedding traffic"
            )
        chunks, reports = [], []
        while admitted > 0:
            scores, rep = self.tick()
            if scores is None and not rep["shed"]:
                break
            if scores is not None:
                chunks.append(scores)
            admitted -= rep["queries"] + rep["shed"]
            reports.append(rep)
        scores = torch.cat(chunks) if chunks else None
        if len(reports) == 1:
            return scores, reports[0]
        merged = {
            "queries": sum(r["queries"] for r in reports),
            "per_tenant": sum(r["per_tenant"] for r in reports),
            "global": sum(r["global"] for r in reports),
            "solved_now": sum(r["solved_now"] for r in reports),
            "shed": sum(r["shed"] for r in reports),
            "slot_overflow": sum(r["slot_overflow"] for r in reports),
            "evictions": reports[-1]["evictions"] if reports else 0,
            "modes": [m for r in reports for m in r["modes"]],
            "tenants": [t for r in reports for t in r["tenants"]],
            "latency_s": [s for r in reports for s in r["latency_s"]],
        }
        return scores, merged

    def classifier(self) -> torch.Tensor:
        """The streaming engine's served global classifier (driver compat)."""
        return self.stream.classifier(self.state)
