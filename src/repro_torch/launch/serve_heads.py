"""Multi-tenant head serving: per-client closed-form heads over a live stream.

The port of the reference's ``launch/serve_heads.py``: the serving-side
driver of the personalization engine
(:mod:`repro_torch.federated.personalization`), composed with the streaming
arrival engine, in two interchangeable execution modes (``--engine``):

* ``lru`` — the synchronous per-burst path: a :class:`HeadCache` (LRU,
  keyed by client id) holds solved heads; a query burst is grouped by
  tenant, cache misses are packed into ONE
  :class:`repro_torch.data.pipeline.PackedPersonalCohort` and solved in ONE
  batched dispatch (one ``batched_chol_gram`` launch), and tenants the server holds no data for are served
  the GLOBAL head (α = 0 ≡ ``factored_solution``).  Invalidation is a
  policy: ``strict`` dirty-marks the whole cache on every absorb (every
  head's global operands moved), ``segmented`` invalidates only tenants
  whose OWN statistics arrived — partial re-personalization: the next
  burst re-solves exactly those heads, resident heads tolerate global
  staleness until their tenant is touched.
* ``slots`` — the continuous-batching slot engine
  (:class:`repro_torch.launch.serving_engine.ServingEngine`): S fixed
  device-resident head slots, absorb/solve/serve decomposed into one
  dispatch each, admission control and in-flight batching around them.
  This driver is then a thin compatibility shim producing the same
  report/log shape.

Query traffic is Zipf popularity-skewed by default
(:func:`repro_torch.federated.arrivals.zipf_traffic` — the production
cross-device regime); ``--traffic uniform`` restores the flat draw.
Everything runs on ``--device`` (the card by default).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_heads --device cuda \
      --waves 24 --segment 6 --queries 48 --cache 32 --engine slots
"""
from __future__ import annotations

import argparse
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fed3r
from repro_torch.data.pipeline import FederatedDataset, pack_personal_cohort
from repro_torch.federated.arrivals import pack_schedule, zipf_traffic
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.personalization import (
    PersonalizationEngine,
    PersonalizeConfig,
)
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
from repro_torch.federated.telemetry import get_telemetry
from repro_torch.launch.serve_stream import stream_setup


class HeadCache:
    """LRU cache of per-tenant heads, versioned against the global stream.

    Two invalidation policies:

    * strict (``segmented=False``, the default): :meth:`advance` bumps the
      cache-wide version, dirty-marking EVERY live entry at once — any
      absorb moved the global (L, b) under every cached head.  O(1), but a
      single cold arrival invalidates the whole hot working set.
    * version-segmented (``segmented=True``): each entry is additionally
      stamped with its tenant's OWN statistics version, and
      ``advance(touched=[...])`` bumps only the touched tenants — an
      entry is stale iff its own tenant's stats changed since it was
      solved, so an absorb invalidates exactly the tenants it carried and
      the next burst re-solves ONLY those heads (partial
      re-personalization).  Untouched entries keep serving heads solved
      against the slightly older global state — the staleness the
      streaming engine's refresh policy already trades on.

    Eviction is least-recently-USED either way: every hit refreshes
    recency, so hot tenants survive cold sweeps.  Staleness is checked on
    access and stale entries are dropped then (lazy, never eager).
    """

    def __init__(self, capacity: int, *, segmented: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.segmented = segmented
        self.version = 0  # the global stream clock this cache is valid for
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0
        self.lru_evictions = 0
        # cid -> (W, global_version_at_solve, tenant_version_at_solve)
        self._entries: "OrderedDict[int, Tuple[torch.Tensor, int, int]]" = (
            OrderedDict()
        )
        self._tenant_versions: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def tenant_version(self, client_id: int) -> int:
        """The current stats version of one tenant (0 until first touched)."""
        return self._tenant_versions.get(int(client_id), 0)

    def advance(self, touched: Optional[Iterable[int]] = None) -> None:
        """The global state absorbed arrivals: bump the stream version and —
        under the segmented policy — the stats versions of the ``touched``
        tenants.  ``touched=None`` means the arrival set is unknown, which
        degrades to whole-cache invalidation in either policy."""
        self.version += 1
        if not self.segmented:
            return
        if touched is None:  # unknown arrivals: invalidate every live entry
            for cid in self._entries:
                self._tenant_versions[cid] = self.tenant_version(cid) + 1
        else:
            for cid in touched:
                cid = int(cid)
                self._tenant_versions[cid] = self.tenant_version(cid) + 1

    def _stale(self, client_id: int, entry: Tuple[torch.Tensor, int, int]) -> bool:
        _, global_v, tenant_v = entry
        if self.segmented:
            return tenant_v != self.tenant_version(client_id)
        return global_v != self.version

    def get(self, client_id: int) -> Optional[torch.Tensor]:
        entry = self._entries.get(client_id)
        if entry is None:
            self.misses += 1
            return None
        if self._stale(client_id, entry):
            del self._entries[client_id]  # lazily drop the dirty entry
            self.stale_evictions += 1
            self.misses += 1
            return None
        self._entries.move_to_end(client_id)
        self.hits += 1
        return entry[0]

    def put(self, client_id: int, W: torch.Tensor) -> None:
        self._entries[client_id] = (
            W, self.version, self.tenant_version(client_id)
        )
        self._entries.move_to_end(client_id)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.lru_evictions += 1


class HeadServer:
    """Streaming global state + LRU-cached personalized heads per tenant.

    ``dataset`` is the server's per-tenant data store (the statistics a
    tenant's head is personalized with); tenants outside it fall back to
    the global head.  ``cohort_round_to`` buckets the per-burst miss count
    so the batched solve retraces only per bucket, not per distinct count.
    ``invalidation`` selects the :class:`HeadCache` policy (``"strict"``
    dirty-sweeps everything per absorb; ``"segmented"`` invalidates only
    tenants whose own statistics arrived).
    """

    def __init__(
        self,
        stream: StreamingEngine,
        pers: PersonalizationEngine,
        dataset: FederatedDataset,
        *,
        cache_capacity: int = 256,
        cohort_round_to: int = 8,
        invalidation: str = "strict",
    ):
        if invalidation not in ("strict", "segmented"):
            raise ValueError(f"unknown invalidation policy: {invalidation!r}")
        self.stream = stream
        self.pers = pers
        self.dataset = dataset
        self.cache = HeadCache(
            cache_capacity, segmented=(invalidation == "segmented")
        )
        self.cohort_round_to = cohort_round_to
        # dataset-global sample capacity: every burst's cohort pads to the
        # same width, so the batched solve traces once per cohort bucket
        # (see pack_client_shards' max_n contract), not per miss set
        self.max_n = int(dataset.client_sizes().max())
        self.state = None  # StreamState, set by init()/absorb()
        self.global_queries = 0
        self.personalized_queries = 0

    def init(self, d: int) -> None:
        self.state = self.stream.init(d)

    @torch.no_grad()
    def absorb(self, packed) -> None:
        """Fold an arrival segment (one dispatch) and dirty-mark the cache —
        every entry under the strict policy, only the arrived tenants
        under the segmented one."""
        self.state, _ = self.stream.absorb(self.state, packed)
        touched = np.unique(np.asarray(packed.client_ids))
        self.cache.advance(touched=touched[touched >= 0])

    def _solve_missing(self, missing: List[int]) -> Dict[int, torch.Tensor]:
        """Solve all cache misses of one burst in ONE batched dispatch."""
        clients = []
        for cid in missing:
            cd = self.dataset.client(cid)
            clients.append((np.asarray(cd.features), np.asarray(cd.labels)))
        pad = self.cohort_round_to
        cohort = -(-len(missing) // pad) * pad
        packed = pack_personal_cohort(
            clients, client_ids=missing, cohort_size=cohort, max_n=self.max_n
        )
        heads = self.pers.solve_heads(self.state.factored, packed)
        ids = heads.client_ids.tolist()
        out: Dict[int, torch.Tensor] = {}
        for slot, cid in enumerate(ids):
            if int(cid) >= 0:
                out[int(cid)] = heads.W[slot]
        return out

    @torch.no_grad()
    def query(
        self,
        client_ids: Sequence[int],
        xs: np.ndarray,  # (Q, d) feature rows, one per query
    ) -> Tuple[torch.Tensor, dict]:
        """Answer a batched heterogeneous query burst with per-tenant heads.

        Returns (scores (Q, C), report).  Per burst: each unique tenant
        probes the cache ONCE, ALL misses with server-side data solve in
        one batched dispatch, unknown tenants get the global head, and the
        whole burst is answered by one batched matmul over the per-query
        heads.  Freshly solved heads serve this burst directly (LRU
        eviction of a just-inserted head cannot downgrade an in-flight
        query to the global mode).  The report counts per-mode traffic —
        the serving analogue of the staleness trace.
        """
        resolved: Dict[int, torch.Tensor] = {}
        wanted: List[int] = []
        for cid in client_ids:
            cid = int(cid)
            known = 0 <= cid < self.dataset.n_clients
            if not known or cid in resolved or cid in wanted:
                continue
            W = self.cache.get(cid)  # the burst's ONE probe of this tenant
            if W is None:
                wanted.append(cid)
            else:
                resolved[cid] = W
        fresh = self._solve_missing(wanted) if wanted else {}
        for cid, W in fresh.items():
            self.cache.put(cid, W)  # for future bursts; this burst serves
        resolved.update(fresh)  # from `resolved` even if LRU evicted it

        # stack each distinct head ONCE (row 0 = global) and gather per
        # query device-side: a burst repeating hot tenants moves U unique
        # heads, not Q copies, and the whole burst scores in one matmul
        rows: Dict[int, int] = {}
        uniq = [self.stream.classifier(self.state)]
        idx, modes = [], []
        for cid in client_ids:
            W = resolved.get(int(cid))
            if W is None:
                idx.append(0)
                modes.append("global")
                self.global_queries += 1
            else:
                row = rows.setdefault(int(cid), len(uniq))
                if row == len(uniq):
                    uniq.append(W)
                idx.append(row)
                modes.append("per-tenant")
                self.personalized_queries += 1
        dev = self.stream.device
        scores = torch.einsum(
            "qd,qdc->qc",
            torch.as_tensor(np.asarray(xs, np.float32), device=dev),
            torch.stack(uniq)[torch.as_tensor(idx, dtype=torch.long, device=dev)],
        )
        report = {
            "queries": len(modes),
            "per_tenant": modes.count("per-tenant"),
            "global": modes.count("global"),
            "solved_now": len(fresh),
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_version": self.cache.version,
            "modes": modes,
        }
        return scores, report


def _make_traffic(
    traffic: str,
    n_tenants: int,
    n_queries: int,
    zipf_exponent: float,
    seed: int,
) -> np.ndarray:
    """The demo's replayable query-traffic trace: tenant id per query."""
    if traffic == "zipf":
        return zipf_traffic(
            n_tenants, n_queries, exponent=zipf_exponent, seed=seed
        )
    if traffic == "uniform":
        rng = np.random.default_rng(seed)
        return rng.integers(0, n_tenants, size=n_queries).astype(np.int64)
    raise ValueError(f"unknown traffic model: {traffic!r}")


def serve_heads(
    n_waves: int = 24,
    segment: int = 6,
    rate: float = 4.0,
    queries_per_burst: int = 48,
    bursts_per_segment: int = 2,  # >1 ⇒ the cache can actually hit between absorbs
    cache_capacity: int = 32,
    n_clients: int = 64,
    d: int = 64,
    n_classes: int = 10,
    ridge_lambda: float = 1e-2,
    alpha_grid: Tuple[float, ...] = (0.0, 0.5, 1.0, 2.0, 4.0),
    engine: str = "lru",
    invalidation: str = "strict",
    traffic: str = "zipf",
    zipf_exponent: float = 1.1,
    seed: int = 0,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Arrival stream + per-tenant query bursts; returns the serving log.

    ``engine="lru"`` runs the synchronous per-burst :class:`HeadServer`;
    ``engine="slots"`` runs the continuous-batching slot engine behind the
    same loop and log shape (``cache_capacity`` then sizes the tenant
    slots; the pinned global slot is extra).

    The log has the reference's keys, plus ``scores`` and ``modes`` (each
    burst's served scores and per-query modes), ``server`` (the server at
    the end of the run) and ``packed`` (the host timeline absorbed); the
    slot engine's log adds ``latency_p50_s`` and ``latency_p99_s`` from
    its latency histogram.
    """
    if engine not in ("lru", "slots"):
        raise ValueError(f"unknown serving engine: {engine!r}")
    dev = resolve_device(device)
    fed, test, schedule = stream_setup(n_waves, rate, 0.0, n_clients, d, n_classes, seed, dev)
    packed = pack_schedule(fed, schedule)

    if engine == "slots":
        from repro_torch.launch.serving_engine import ServingConfig, ServingEngine

        server = ServingEngine(
            ServingConfig(
                n_classes=n_classes, ridge_lambda=ridge_lambda,
                n_slots=cache_capacity + 1,  # + the pinned global slot
                invalidation=(
                    "segmented" if invalidation == "segmented" else "strict"
                ),
                alpha_grid=alpha_grid,
            ),
            fed,
            device=dev,
        )
    else:
        server = HeadServer(
            StreamingEngine(StreamConfig(
                n_classes=n_classes, ridge_lambda=ridge_lambda,
            ), device=dev),
            PersonalizationEngine(PersonalizeConfig(
                n_classes=n_classes, alpha_grid=alpha_grid,
            ), device=dev),
            fed,
            cache_capacity=cache_capacity,
            invalidation=invalidation,
        )
    server.init(d)

    n_bursts = -(-packed.n_waves // segment) * bursts_per_segment
    trace = _make_traffic(
        traffic, fed.n_clients, n_bursts * queries_per_burst,
        zipf_exponent, seed + 17,
    )
    rng = np.random.default_rng(seed + 17)
    log: dict = {
        "wave": [], "per_tenant": [], "global": [], "solved_now": [],
        "hit_rate": [], "acc_personal": [], "scores": [], "modes": [],
    }
    t0 = time.perf_counter()
    if verbose:
        print(f"engine={engine} invalidation={invalidation} traffic={traffic} "
              f"tenants={fed.n_clients} cache={cache_capacity} "
              f"waves={packed.n_waves} segment={segment} "
              f"alpha_grid={alpha_grid} device={dev}")
        print("wave | mode (tenant/global) | solved | cum hit rate | "
              "acc on tenant-local queries")
    burst = 0
    for lo in range(0, packed.n_waves, segment):
        server.absorb(packed.slice_waves(lo, min(lo + segment, packed.n_waves)))
        for _ in range(bursts_per_segment):
            # a burst of tenant-attributed queries: each query is a sample
            # from the querying tenant's OWN distribution (the personalized
            # case); bursts after the first can hit the per-segment cache
            cids = trace[burst * queries_per_burst:(burst + 1) * queries_per_burst]
            burst += 1
            qx, qy = [], []
            for cid in cids:
                cd = fed.client(int(cid))
                i = int(rng.integers(0, cd.n))
                qx.append(cd.features[i])
                qy.append(cd.labels[i])
            scores, rep = server.query(cids, np.stack(qx))
            qy_t = torch.as_tensor(np.asarray(qy), device=scores.device).long()
            acc = float((torch.argmax(scores, dim=-1) == qy_t).to(torch.float32).mean())
            if engine == "slots":
                hits, misses = server.hits, server.misses
            else:
                hits, misses = server.cache.hits, server.cache.misses
            hit_rate = hits / max(hits + misses, 1)
            log["wave"].append(int(server.state.wave))
            log["per_tenant"].append(rep["per_tenant"])
            log["global"].append(rep["global"])
            log["solved_now"].append(rep["solved_now"])
            log["hit_rate"].append(hit_rate)
            log["acc_personal"].append(acc)
            log["scores"].append(scores)
            log["modes"].append(rep["modes"])
            if verbose:
                print(f"{int(server.state.wave):4d} | {rep['per_tenant']:6d} /"
                      f"{rep['global']:6d} | {rep['solved_now']:6d} | "
                      f"{hit_rate:12.3f} | {acc:.4f}")
    acc_global = float(fed3r.accuracy(
        server.stream.classifier(server.state), test.features, test.labels,
    ))
    log["acc_global_test"] = acc_global
    if engine == "slots":
        log["stream_dispatches"] = server.absorb_dispatches
        log["personalize_dispatches"] = server.solve_dispatches
        log["serve_dispatches"] = server.serve_dispatches
        log["stage_s"] = dict(server.stage_s)
        log["cache"] = {
            "hits": server.hits, "misses": server.misses,
            "stale_evictions": 0,  # slots re-solve stale heads in place
            "lru_evictions": server.table.evictions,
        }
        log["latency_p50_s"] = server._latency_hist.p50
        log["latency_p99_s"] = server._latency_hist.p99
    else:
        log["stream_dispatches"] = server.stream.dispatches
        log["personalize_dispatches"] = server.pers.dispatches
        log["cache"] = {
            "hits": server.cache.hits, "misses": server.cache.misses,
            "stale_evictions": server.cache.stale_evictions,
            "lru_evictions": server.cache.lru_evictions,
        }
    log["wall_s"] = time.perf_counter() - t0
    log["server"] = server
    log["packed"] = packed
    get_telemetry().gauge(
        "driver_wall_seconds", driver="serve_heads", engine=engine
    ).set(log["wall_s"])
    if verbose:
        c = log["cache"]
        print(f"global-head test acc={acc_global:.4f}  "
              f"stream dispatches={log['stream_dispatches']}, "
              f"head-solve dispatches={log['personalize_dispatches']}")
        print(f"cache: {c['hits']} hits / {c['misses']} misses "
              f"({c['stale_evictions']} stale evictions on stream advance, "
              f"{c['lru_evictions']} evictions), {log['wall_s']:.2f}s")
    return log


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=24)
    ap.add_argument("--segment", type=int, default=6)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--bursts", type=int, default=2,
                    help="query bursts per absorbed segment")
    ap.add_argument("--cache", type=int, default=32)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--ridge-lambda", type=float, default=1e-2)
    ap.add_argument("--engine", choices=("lru", "slots"), default="lru",
                    help="synchronous LRU path vs continuous-batching slots")
    ap.add_argument("--invalidation", choices=("strict", "segmented"),
                    default="strict",
                    help="absorb invalidates everything vs only arrived tenants")
    ap.add_argument("--traffic", choices=("zipf", "uniform"), default="zipf")
    ap.add_argument("--zipf-exponent", type=float, default=1.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    serve_heads(
        n_waves=args.waves, segment=args.segment, rate=args.rate,
        queries_per_burst=args.queries, bursts_per_segment=args.bursts,
        cache_capacity=args.cache,
        n_clients=args.clients, d=args.d, n_classes=args.classes,
        ridge_lambda=args.ridge_lambda, engine=args.engine,
        invalidation=args.invalidation, traffic=args.traffic,
        zipf_exponent=args.zipf_exponent, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
