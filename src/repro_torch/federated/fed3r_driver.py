"""FED3R / FedNCM round drivers (Algorithm 1), in PyTorch.

The port of the reference's ``federated/fed3r_driver.py``: the simulator
level, over a :class:`FederatedDataset` of precomputed features (or an
``extractor`` that maps a client's raw inputs to features).  The datacenter
statistics pass is :mod:`repro_torch.launch.train`; both fold clients
through the same accumulation engine.

Not ported yet: FED3R-RF (``n_random_features > 0``, ROADMAP Queue 1 item
3) and FED3R+FT (``run_fed3r_ft``, item 7).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import Fed3RConfig, FederatedConfig
from repro_torch.core import fed3r, ncm
from repro_torch.data.pipeline import FederatedDataset, pack_client_shards
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.engine import (
    AccumulationEngine,
    EngineConfig,
    EngineStats,
    to_ncm_stats,
)
from repro_torch.federated.sampling import ClientSampler

Extractor = Callable[[np.ndarray], torch.Tensor]

# each round's per-client sample capacity is rounded up to a multiple of this
PACK_ROUND_TO = 64


@dataclass
class Fed3RHistory:
    rounds: List[int] = field(default_factory=list)
    accuracy: List[float] = field(default_factory=list)
    clients_seen: List[int] = field(default_factory=list)
    wall_time: List[float] = field(default_factory=list)


def _default_extractor(device: torch.device) -> Extractor:
    return lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def _host(x) -> np.ndarray:
    """Test inputs as host numpy, whether given as an array or a tensor."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(x, device: torch.device) -> torch.Tensor:
    """Test labels on ``device`` (a copy of a host array: it may be read-only)."""
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x), device=device)


def _fresh_clients(sampled, seen: set) -> List[int]:
    """Statistics of a client are sent exactly once: a resampled or
    re-drawn client re-sends nothing (idempotent), in both sampling modes.
    With-replacement rounds can contain the same client TWICE, so the dedup
    runs draw by draw, not against the previous rounds only."""
    fresh = []
    for k in (int(k) for k in sampled):
        if k not in seen:
            seen.add(k)
            fresh.append(k)
    return fresh


def _accumulate_round(
    engine: AccumulationEngine,
    acc: EngineStats,
    dataset: FederatedDataset,
    fresh: List[int],
    extractor: Extractor,
    clients_per_shard: int,
) -> EngineStats:
    """Pack this round's unseen clients and fold them in.

    The sample capacity is sized per call (bucketed by PACK_ROUND_TO) so tail
    rounds with few/small fresh clients don't pay the dataset-global maximum
    in padded FLOPs.
    """
    clients = []
    for k in fresh:
        cd = dataset.client(k)
        clients.append((extractor(cd.features).cpu().numpy(), cd.labels))
    packed = pack_client_shards(
        clients, clients_per_shard, client_ids=fresh, round_to=PACK_ROUND_TO
    )
    return engine.accumulate(acc, packed)


def run_fed3r(
    dataset: FederatedDataset,
    test_features,
    test_labels,
    f3_cfg: Fed3RConfig,
    fed_cfg: FederatedConfig,
    *,
    extractor: Optional[Extractor] = None,
    eval_every: int = 10,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, fed3r.Fed3RStats, Fed3RHistory]:
    """FED3R (Algorithm 1).  Returns (W*, final stats, accuracy history)."""
    if f3_cfg.n_random_features > 0:
        raise NotImplementedError(
            "FED3R-RF (n_random_features > 0) is ROADMAP Queue 1 item 3"
        )
    dev = resolve_device(device)
    extractor = extractor or _default_extractor(dev)
    C = dataset.n_classes
    d = int(extractor(dataset.features[:1]).shape[-1])
    test_phi = extractor(_host(test_features))
    test_y = _on(test_labels, dev)

    sampler = ClientSampler(
        dataset.n_clients, fed_cfg.clients_per_round,
        replacement=fed_cfg.sample_with_replacement, seed=fed_cfg.seed,
    )
    engine = AccumulationEngine(EngineConfig(n_classes=C), device=dev)
    acc = engine.init(d)
    clients_per_shard = min(fed_cfg.clients_per_round, dataset.n_clients)

    hist = Fed3RHistory()
    n_rounds = fed_cfg.n_rounds or sampler.rounds_to_full_coverage()
    seen_once: set = set()
    t0 = time.time()
    for rnd in range(n_rounds):
        fresh = _fresh_clients(sampler.sample(), seen_once)
        if fresh:
            acc = _accumulate_round(
                engine, acc, dataset, fresh, extractor, clients_per_shard
            )
        stats = acc.stats
        if (rnd + 1) % eval_every == 0 or rnd == n_rounds - 1 or len(seen_once) == dataset.n_clients:
            W = fed3r.solve(stats, f3_cfg.ridge_lambda, f3_cfg.normalize_classifier)
            test_acc = float(fed3r.accuracy(W, test_phi, test_y))
            hist.rounds.append(rnd + 1)
            hist.accuracy.append(test_acc)
            hist.clients_seen.append(len(seen_once))
            hist.wall_time.append(time.time() - t0)
        if len(seen_once) == dataset.n_clients and not fed_cfg.sample_with_replacement:
            break  # exact convergence after ⌈K/κ⌉ rounds (paper §4.3)

    stats = acc.stats
    W = fed3r.solve(stats, f3_cfg.ridge_lambda, f3_cfg.normalize_classifier)
    return W, stats, hist


def run_fedncm(
    dataset: FederatedDataset,
    test_features,
    test_labels,
    fed_cfg: FederatedConfig,
    *,
    extractor: Optional[Extractor] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, Fed3RHistory]:
    """FedNCM baseline (Legate et al. 2023a) — Table 1/6 comparison.

    Runs on the same accumulation engine as FED3R: the NCM statistics
    (per-class sums + counts) are a projection of the engine accumulator
    (sums = bᵀ, counts = class_counts), so the baseline costs no second
    statistics pass.
    """
    dev = resolve_device(device)
    extractor = extractor or _default_extractor(dev)
    C = dataset.n_classes
    d = int(extractor(dataset.features[:1]).shape[-1])
    engine = AccumulationEngine(EngineConfig(n_classes=C), device=dev)
    acc = engine.init(d)
    sampler = ClientSampler(dataset.n_clients, fed_cfg.clients_per_round, seed=fed_cfg.seed)
    clients_per_shard = min(fed_cfg.clients_per_round, dataset.n_clients)
    seen: set = set()
    hist = Fed3RHistory()
    for rnd in range(sampler.rounds_to_full_coverage()):
        fresh = _fresh_clients(sampler.sample(), seen)
        if fresh:
            acc = _accumulate_round(
                engine, acc, dataset, fresh, extractor, clients_per_shard
            )
    W = ncm.solve(to_ncm_stats(acc))
    test_phi = extractor(_host(test_features))
    test_acc = float(ncm.accuracy(W, test_phi, _on(test_labels, dev)))
    hist.rounds.append(sampler.rounds_to_full_coverage())
    hist.accuracy.append(test_acc)
    return W, hist
