"""Arrival-process simulator for streaming FED3R (§6 future work).

A copy of the framework-free schedule code of the reference's
``federated/arrivals.py`` (the reference module imports its JAX package at
import time, so the port keeps its own copy; ``tests/test_torch_streaming.py``
holds every function equal to the reference's output).

Generates the TIMELINE the streaming engine consumes: which clients arrive
at which wave.  Every schedule is a plain ``List[List[int]]`` (wave t →
client ids arriving at t; empty waves are legal and meaningful — the
serving clock still ticks), so schedules compose with any packer or
driver.  Three generators:

* :func:`poisson_schedule` — Poisson(rate) arrivals per wave from the
  not-yet-arrived pool (cross-device churn: each client arrives once);
* :func:`trace_schedule` — trace-driven: an explicit per-client arrival
  wave (replay of a production arrival log);
* :func:`skewed_schedule` — non-IID per-wave label skew: clients arrive
  roughly ordered by their dominant label (``skew`` interpolates between
  an IID shuffle and a strict label sort).

:func:`pack_schedule` materializes a schedule against a
:class:`repro_torch.data.pipeline.FederatedDataset` into the engine's
:class:`repro_torch.data.pipeline.PackedArrivals`.  :func:`zipf_traffic`
draws seeded, replayable tenant-attributed query traces under bounded-Zipf
popularity skew.

The chaos half (:class:`UploadEvent` … :func:`timeline_from_json`) is the
upload side of the process: seeded, replayable fault schedules (drop with
retransmit, duplicate, reorder, delay) that the asynchronous round engine
(:mod:`repro_torch.federated.async_engine`) consumes.  It is numpy only and
draws exactly the reference's events for the same seed; a JSON timeline
written by either package loads in the other.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.data.pipeline import (
    FederatedDataset,
    PackedArrivals,
    pack_arrival_waves,
)
from repro_torch.federated.telemetry import get_telemetry

Schedule = List[List[int]]


def poisson_schedule(
    n_clients: int,
    n_waves: int,
    rate: float,
    *,
    seed: int = 0,
    drain: bool = True,
) -> Schedule:
    """Poisson(rate) client arrivals per wave, each client arriving once.

    Waves draw ``Poisson(rate)`` clients (capped by the remaining pool)
    from a seeded shuffle of the federation.  With ``drain`` the final
    wave absorbs any clients the process did not reach — the schedule is
    then a partition of ``range(n_clients)``; without it, stragglers
    simply never arrive (partial-participation streaming).
    """
    if n_waves < 1:
        raise ValueError(f"n_waves must be >= 1, got {n_waves}")
    rng = np.random.default_rng(seed)
    pool = rng.permutation(n_clients)
    waves: Schedule = []
    at = 0
    for _ in range(n_waves):
        k = min(int(rng.poisson(rate)), n_clients - at)
        waves.append([int(c) for c in pool[at : at + k]])
        at += k
    if drain and at < n_clients:
        waves[-1].extend(int(c) for c in pool[at:])
    return waves


def trace_schedule(
    arrival_wave: Sequence[int], n_waves: Optional[int] = None
) -> Schedule:
    """Trace-driven schedule: ``arrival_wave[k]`` is client k's wave index."""
    arr = np.asarray(arrival_wave, np.int64)
    if arr.size and arr.min() < 0:
        raise ValueError("arrival waves must be >= 0")
    T = int(arr.max()) + 1 if arr.size else 0
    if n_waves is not None:
        if T > n_waves:
            raise ValueError(f"trace spans {T} waves > n_waves={n_waves}")
        T = n_waves
    waves: Schedule = [[] for _ in range(T)]
    for k, t in enumerate(arr):
        waves[int(t)].append(k)
    return waves


def dominant_labels(dataset: FederatedDataset) -> np.ndarray:
    """Per-client dominant class — the skew key for label-skewed arrivals."""
    out = np.zeros((dataset.n_clients,), np.int64)
    for k in range(dataset.n_clients):
        labels = dataset.client(k).labels
        out[k] = (
            np.bincount(labels, minlength=dataset.n_classes).argmax()
            if len(labels) else 0
        )
    return out


def skewed_schedule(
    dominant: Sequence[int],
    n_waves: int,
    *,
    skew: float = 1.0,
    seed: int = 0,
) -> Schedule:
    """Label-skewed arrival order: clients stream in ≈ dominant-label order.

    ``skew=0`` is an IID shuffle, ``skew=1`` a strict sort by dominant
    label (each wave sees a narrow class slice); in between, each client's
    arrival key interpolates between uniform noise and its normalized
    label rank.  Clients are then chunked evenly into ``n_waves`` waves.
    """
    if not 0.0 <= skew <= 1.0:
        raise ValueError(f"skew must be in [0, 1], got {skew}")
    dom = np.asarray(dominant, np.float64)
    n = len(dom)
    rng = np.random.default_rng(seed)
    rank = dom / max(float(dom.max()), 1.0)
    key = (1.0 - skew) * rng.uniform(size=n) + skew * rank
    order = np.argsort(key, kind="stable")
    chunks = np.array_split(order, n_waves)
    return [[int(c) for c in chunk] for chunk in chunks]


def zipf_traffic(
    n_tenants: int,
    n_queries: int,
    *,
    exponent: float = 1.1,
    seed: int = 0,
    permute: bool = True,
) -> np.ndarray:
    """Seeded, replayable Zipf-skewed query traffic: ``(n_queries,)`` tenant ids.

    Tenant popularity follows a BOUNDED Zipf law over the ``n_tenants``
    universe — rank r drawn with probability ∝ r^(-exponent) — sampled by
    inverse-CDF so one call materializes the whole trace (no per-draw
    rejection, exact at any universe size).  With ``permute`` the
    popularity ranks are scattered over tenant ids by a seeded
    permutation, so "hot" tenants are not simply the low ids; without it
    tenant 0 is the hottest (convenient for assertions).  Same
    ``(n_tenants, n_queries, exponent, seed)`` ⇒ the identical trace, so
    benchmark runs replay byte-identical traffic.

    ``exponent`` ≈ 1.0–1.3 matches production cross-device skew: at 1.1
    over 1M tenants the top ~1% of tenants draw roughly half the queries.
    """
    if n_tenants < 1:
        raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
    if n_queries < 0:
        raise ValueError(f"n_queries must be >= 0, got {n_queries}")
    if exponent <= 0.0:
        raise ValueError(f"exponent must be > 0, got {exponent}")
    rng = np.random.default_rng(seed)
    weights = np.arange(1, n_tenants + 1, dtype=np.float64) ** -exponent
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.uniform(size=n_queries), side="right")
    if permute:
        ranks = rng.permutation(n_tenants)[ranks]
    return ranks.astype(np.int64)


# ---------------------------------------------------------------------------
# Chaos-mode fault injection — the UPLOAD side of the arrival process
# ---------------------------------------------------------------------------
#
# The generators above decide WHEN clients have data; the chaos injector
# decides what the network does to the resulting statistics uploads: seeded,
# replayable schedules that DROP uploads (forcing retransmits), DUPLICATE
# deliveries, REORDER concurrent arrivals, and DELAY stragglers, while the
# asynchronous engine's folded classifier stays bitwise the synchronous
# barrier's.


class UploadEvent(NamedTuple):
    """One statistics-upload delivery, as the server observes it.

    ``t`` is the delivery time as an OFFSET from the round's start (so the
    same timeline replays under both the async cadence and the synchronous
    barrier's shifted round starts).  ``attempt`` counts the retransmits
    that preceded this copy (0 = the first send got through); duplicated
    deliveries share the attempt number of the copy they clone.
    """

    t: float
    round_id: int
    client: int
    attempt: int


@dataclass(frozen=True)
class ChaosSpec:
    """Seeded fault-injection knobs of one chaos schedule.

    Every probability is per-upload: ``drop`` loses the send (the client
    retransmits after ``rto``, re-flipping the coin, with the LAST of
    ``max_attempts`` always delivering — chaos perturbs timing, never the
    delivered set, so exact-once final states stay comparable);
    ``duplicate`` delivers a second identical copy within ``rto``;
    ``reorder`` jitters the delivery by up to ±``rto`` (swapping concurrent
    arrivals); ``delay`` multiplies the client's latency by
    ``delay_factor`` (the transient-straggler fault, distinct from the
    persistent per-client latency profile).
    """

    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    delay_factor: float = 8.0
    rto: float = 0.5
    max_attempts: int = 8
    seed: int = 0

    def __post_init__(self):
        for name in ("drop", "duplicate", "reorder", "delay"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")


def latency_profile(
    n_clients: int,
    straggler_frac: float,
    *,
    straggler_factor: float = 8.0,
    base: float = 0.3,
    jitter: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Per-client upload latencies with a persistent straggler tail.

    A seeded ``straggler_frac`` of the federation is ``straggler_factor``×
    slower than the ``base``-latency body (uniform ±``jitter`` spread) —
    the population the adaptive dropout policy demotes.
    """
    if not 0.0 <= straggler_frac <= 1.0:
        raise ValueError(f"straggler_frac must be in [0, 1], got {straggler_frac}")
    rng = np.random.default_rng((seed, 0x51))
    lat = base * (1.0 + jitter * rng.uniform(-1.0, 1.0, size=n_clients))
    n_slow = int(round(straggler_frac * n_clients))
    slow = rng.choice(n_clients, size=n_slow, replace=False)
    lat[slow] *= straggler_factor
    return lat.astype(np.float64)


def chaos_round_events(
    cohort: Sequence[int],
    latency: np.ndarray,
    spec: ChaosSpec,
    round_id: int,
) -> List[UploadEvent]:
    """The fault-injected delivery events of ONE round's cohort.

    Deterministic in ``(spec.seed, round_id, client)``: re-generating a
    round replays byte-identical faults, so an offending schedule can be
    persisted and replayed.  Each injected fault (delay, drop+retransmit,
    reorder, duplicate) is also recorded as a ``chaos_fault`` event in the
    telemetry flight recorder.
    """
    telemetry = get_telemetry()

    def fault(kind: str, c: int, **fields) -> None:
        telemetry.event(
            "chaos_fault", fault=kind, client=int(c), round=int(round_id), **fields
        )

    events: List[UploadEvent] = []
    for c in cohort:
        rng = np.random.default_rng((spec.seed, round_id, int(c), 0xC4A0))
        base = float(latency[int(c)])
        if rng.random() < spec.delay:
            base *= spec.delay_factor
            fault("delay", c, factor=spec.delay_factor)
        attempt = 0
        while attempt < spec.max_attempts - 1 and rng.random() < spec.drop:
            attempt += 1  # this copy was lost; retransmit after rto
        if attempt:
            fault("drop", c, retransmits=attempt)
        t = base + attempt * spec.rto
        if rng.random() < spec.reorder:
            t = max(1e-6, t + rng.uniform(-spec.rto, spec.rto))
            fault("reorder", c)
        events.append(UploadEvent(t=t, round_id=round_id, client=int(c), attempt=attempt))
        if rng.random() < spec.duplicate:
            fault("duplicate", c)
            events.append(
                UploadEvent(
                    t=t + rng.uniform(1e-6, spec.rto),
                    round_id=round_id,
                    client=int(c),
                    attempt=attempt,
                )
            )
    events.sort(key=lambda e: (e.t, e.client, e.attempt))
    return events


def chaos_timeline(
    cohorts: Sequence[Sequence[int]],
    latency: np.ndarray,
    spec: ChaosSpec,
) -> List[UploadEvent]:
    """The full fault-injected timeline over a pre-drawn cohort sequence."""
    out: List[UploadEvent] = []
    for r, cohort in enumerate(cohorts):
        out.extend(chaos_round_events(cohort, latency, spec, r))
    return out


def timeline_to_json(
    cohorts: Sequence[Sequence[int]],
    latency: np.ndarray,
    spec: ChaosSpec,
    events: Sequence[UploadEvent],
) -> str:
    """Serialize a chaos schedule for artifact upload / offline replay."""
    return json.dumps(
        {
            "spec": asdict(spec),
            "cohorts": [[int(c) for c in cohort] for cohort in cohorts],
            "latency": [float(x) for x in np.asarray(latency)],
            "events": [[float(e.t), e.round_id, e.client, e.attempt] for e in events],
        },
        indent=2,
    )


def timeline_from_json(blob: str) -> Dict[str, object]:
    """Rehydrate a chaos schedule persisted by :func:`timeline_to_json`."""
    obj = json.loads(blob)
    return {
        "spec": ChaosSpec(**obj["spec"]),
        "cohorts": [[int(c) for c in cohort] for cohort in obj["cohorts"]],
        "latency": np.asarray(obj["latency"], np.float64),
        "events": [
            UploadEvent(t=float(t), round_id=int(r), client=int(c), attempt=int(a))
            for t, r, c, a in obj["events"]
        ],
    }


def pack_schedule(
    dataset: FederatedDataset,
    schedule: Schedule,
    *,
    extractor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    clients_per_wave: Optional[int] = None,
    max_n: Optional[int] = None,
    round_to: int = 8,
) -> PackedArrivals:
    """Materialize a schedule into the engine's :class:`PackedArrivals`.

    ``extractor`` optionally maps raw client inputs to features on the
    host (pass ``feature_fn`` to the engine instead to fuse a backbone
    into the scan).  ``max_n`` defaults to the DATASET-global maximum
    client size so repeated streams over the same federation share one
    jit trace.
    """
    if max_n is None:
        max_n = int(max(dataset.client_sizes(), default=1))
    waves = []
    ids = []
    for wave in schedule:
        packed_wave = []
        for k in wave:
            cd = dataset.client(k)
            x = np.asarray(extractor(cd.features)) if extractor else cd.features
            packed_wave.append((x, cd.labels))
        waves.append(packed_wave)
        ids.append(list(wave))
    return pack_arrival_waves(
        waves,
        client_ids=ids,
        clients_per_wave=clients_per_wave,
        max_n=max_n,
        round_to=round_to,
    )
