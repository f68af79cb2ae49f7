"""Live-refresh classifier serving over a streaming FED3R arrival process.

The port of the reference's ``launch/serve_stream.py`` for its synchronous
driver (``engine="lru"``) and its slot-engine driver (``engine="slots"``).
Clients arrive over time (Poisson or
label-skewed schedule), the server folds each arrival SEGMENT through the
streaming engine (:mod:`repro_torch.federated.streaming_engine`), and
between segments it answers a query burst with the currently served
classifier — which is as fresh as the refresh policy paid for:

* ``--policy arrival``  refresh-on-arrival (``refresh_every=1``): every
  wave re-solves W by two triangular solves; queries never see stale
  weights;
* ``--policy every-k``  refresh every k-th wave (``--k``): a cheaper
  refresh cadence, and the reported STALENESS (waves / samples absorbed
  since the last re-solve) says what queries see.

``--engine slots`` routes the same loop through the continuous-batching
slot engine (:mod:`repro_torch.launch.serving_engine`): absorbs go through
its absorb stage, query bursts are admitted to its queue and answered by
the one-dispatch serve stage against the pinned global slot (refreshed at
tick time whenever the stream advanced — the slot engine's solve stage owns
the refresh, so the ``--policy`` staleness knobs report the stream state's
lag while queries see a tick-fresh head).  The asynchronous chaos rounds
(``--engine async``, ROADMAP Queue 1 item 8) are not ported yet.
Everything runs on ``--device`` (the card by default).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_stream --device cuda \\
      --waves 24 --rate 4 --policy every-k --k 4 --segment 6 --engine slots
"""
from __future__ import annotations

import argparse
import time
from typing import Union

import numpy as np
import torch

from repro_torch.core import fed3r
from repro_torch.data.pipeline import make_federated_features
from repro_torch.federated.arrivals import (
    dominant_labels,
    pack_schedule,
    poisson_schedule,
    skewed_schedule,
)
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.streaming_engine import (
    StreamConfig,
    StreamingEngine,
    WaveTrace,
)
from repro_torch.federated.telemetry import get_telemetry

# the reference driver's dataset: noise calibrated so the served accuracy
# GROWS over the stream — stale refreshes are then visible in the query bursts
N_SAMPLES, ALPHA, NOISE = 8000, 0.1, 7.0


def stream_setup(
    n_waves: int, rate: float, skew: float, n_clients: int, d: int, n_classes: int,
    seed: int, device: torch.device,
):
    """The federation, held-out set and arrival schedule of one run."""
    fed, test = make_federated_features(
        seed=seed, n=N_SAMPLES, d=d, n_classes=n_classes, n_clients=n_clients,
        alpha=ALPHA, noise=NOISE, device=device,
    )
    if skew > 0.0:
        schedule = skewed_schedule(dominant_labels(fed), n_waves, skew=skew, seed=seed)
    else:
        schedule = poisson_schedule(fed.n_clients, n_waves, rate, seed=seed)
    return fed, test, schedule


def serve_stream(
    n_waves: int = 24,
    rate: float = 4.0,
    policy: str = "arrival",
    k: int = 4,
    segment: int = 6,
    skew: float = 0.0,
    n_clients: int = 64,
    d: int = 64,
    n_classes: int = 10,
    ridge_lambda: float = 1e-2,
    engine: str = "lru",
    seed: int = 0,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Run the arrival → absorb → query loop; returns the serving log.

    ``engine="lru"`` is the synchronous driver; ``engine="slots"`` rides the
    continuous-batching slot engine (absorb/serve stages, one dispatch each)
    behind the same log shape.  The log has the reference's keys, plus ``W``
    (the final served classifier), ``trace`` (the :class:`WaveTrace` of the
    whole stream) and ``packed`` (the host timeline that was absorbed).
    """
    if engine == "async":
        raise NotImplementedError(
            "engine='async': asynchronous merge-on-arrival rounds are ROADMAP Queue 1 item 8"
        )
    if engine not in ("lru", "slots"):
        raise ValueError(f"unknown serving engine: {engine!r}")
    if policy not in ("arrival", "every-k"):
        raise ValueError(f"unknown refresh policy: {policy!r}")
    dev = resolve_device(device)
    fed, test, schedule = stream_setup(n_waves, rate, skew, n_clients, d, n_classes, seed, dev)
    packed = pack_schedule(fed, schedule)
    timeline = packed.to(dev)  # one copy to the device; segments are views

    refresh_every = 1 if policy == "arrival" else k
    slot_server = None
    if engine == "slots":
        from repro_torch.launch.serving_engine import ServingConfig, ServingEngine

        # global-only traffic: a tiny table (slot 0 + one spare) suffices,
        # and every query carries tenant -1 (no server-side data)
        test_np = test.features.cpu().numpy()
        slot_server = ServingEngine(
            ServingConfig(
                n_classes=n_classes, ridge_lambda=ridge_lambda, n_slots=2,
                queue_depth=max(4096, len(test_np)),
            ),
            fed,
            device=dev,
        )
        slot_server.init(d)
        stream_engine = slot_server.stream
        state = slot_server.state
    else:
        stream_engine = StreamingEngine(StreamConfig(
            n_classes=n_classes, ridge_lambda=ridge_lambda, refresh_every=refresh_every,
        ), device=dev)
        state = stream_engine.init(d)

    log: dict = {
        "wave": [], "clients_seen": [], "samples_seen": [],
        "stale_waves": [], "stale_samples": [], "acc_served": [],
        # this driver serves ONE global head to all tenants
        "served_head": "global",
        "engine": engine,
    }
    traces = []
    seen = 0
    t0 = time.perf_counter()  # monotonic: wall clock steps under NTP
    if verbose:
        print(f"engine={engine} policy={policy} refresh_every={refresh_every} "
              f"waves={packed.n_waves} clients={packed.n_clients} device={dev}")
        print("served head: GLOBAL (one W for all tenants; staleness below is "
              "refresh-policy lag)")
        print("wave | arrived | samples seen | stale (waves/samples) | acc(served W)")
    for lo in range(0, packed.n_waves, segment):
        hi = min(lo + segment, packed.n_waves)
        if engine == "slots":
            traces.append(slot_server.absorb(packed.slice_waves(lo, hi)))  # ONE dispatch
            state = slot_server.state
            # the query burst: every test row admitted with tenant -1 →
            # served by the pinned global slot in ONE serve dispatch
            scores, _ = slot_server.query(np.full((len(test_np),), -1, np.int64), test_np)
            acc = float((torch.argmax(scores, dim=-1) == test.labels).to(torch.float32).mean())
        else:
            state, trace = stream_engine.absorb(state, timeline.slice_waves(lo, hi))
            traces.append(trace)
            # a query burst against the served (possibly stale) classifier
            acc = float(fed3r.accuracy(stream_engine.classifier(state), test.features,
                                       test.labels))
        arrived = packed.slice_waves(lo, hi).n_clients
        seen += arrived
        log["wave"].append(int(state.wave))
        log["clients_seen"].append(seen)
        log["samples_seen"].append(float(state.n))
        log["stale_waves"].append(int(state.stale_waves))
        log["stale_samples"].append(float(state.stale_samples))
        log["acc_served"].append(acc)
        if verbose:
            print(f"{int(state.wave):4d} | {arrived:7d} | "
                  f"{float(state.n):12.0f} | {int(state.stale_waves):5d} /"
                  f"{float(state.stale_samples):8.0f} | {acc:.4f}")
    if engine == "slots":
        acc = log["acc_served"][-1]  # slot ticks already serve a fresh head
        log["dispatches"] = (
            slot_server.absorb_dispatches + slot_server.solve_dispatches
            + slot_server.serve_dispatches
        )
        log["serve_dispatches"] = slot_server.serve_dispatches
        log["stage_s"] = dict(slot_server.stage_s)
    else:
        state = stream_engine.refresh(state)  # final sync before reporting
        acc = float(fed3r.accuracy(stream_engine.classifier(state), test.features,
                                   test.labels))
        log["dispatches"] = stream_engine.dispatches
    log["acc_final"] = acc
    log["wall_s"] = time.perf_counter() - t0
    log["W"] = stream_engine.classifier(state)
    log["trace"] = WaveTrace(*(torch.cat(parts) for parts in zip(*traces)))
    log["packed"] = packed
    get_telemetry().gauge(
        "driver_wall_seconds", driver="serve_stream", engine=engine
    ).set(log["wall_s"])
    if verbose:
        print(f"final sync: acc={acc:.4f}  "
              f"({log['dispatches']} dispatches for {packed.n_waves} waves, "
              f"{log['wall_s']:.2f}s)")
    return log


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=24)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--policy", choices=("arrival", "every-k"), default="arrival")
    ap.add_argument("--k", type=int, default=4, help="refresh cadence (every-k)")
    ap.add_argument("--segment", type=int, default=6,
                    help="waves absorbed between query bursts")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="label-skewed arrival order in [0, 1]")
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--ridge-lambda", type=float, default=1e-2)
    ap.add_argument("--engine", choices=("lru", "slots", "async"), default="lru",
                    help="the synchronous driver or the slot-serving engine "
                         "(async is not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    serve_stream(
        n_waves=args.waves, rate=args.rate, policy=args.policy, k=args.k,
        segment=args.segment, skew=args.skew, n_clients=args.clients,
        d=args.d, n_classes=args.classes, ridge_lambda=args.ridge_lambda,
        engine=args.engine, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
