"""FED3R / FED3R-RF / FedNCM / FED3R+FT round drivers (Algorithm 1, §4.4), in PyTorch.

The port of the reference's ``federated/fed3r_driver.py``: the simulator
level, over a :class:`FederatedDataset` of precomputed features (or an
``extractor`` that maps a client's raw inputs to features).  The datacenter
statistics pass is :mod:`repro_torch.launch.train`; both fold clients
through the same accumulation engine.

With ``n_random_features > 0`` :func:`run_fed3r` is FED3R-RF (paper §4.2):
every client's features go through one shared random-features map before
the statistics pass.  :func:`run_fed3r_ft` is FED3R+FT (paper §4.4): the
calibrated FED3R classifier initialises a softmax head, then the model is
fine-tuned with any gradient FL algorithm on the cohort round engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint
from repro_torch.configs.base import Fed3RConfig, FederatedConfig
from repro_torch.core import calibration, fed3r, ncm
from repro_torch.core.random_features import RFFParams, rff_init, rff_map
from repro_torch.data.pipeline import FederatedDataset, pack_client_shards
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.engine import (
    AccumulationEngine,
    EngineConfig,
    EngineStats,
    to_ncm_stats,
)
from repro_torch.federated.sampling import ClientSampler
from repro_torch.federated.simulator import FLTask, as_f32, as_labels, run_federated, softmax_ce

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
    rff_params: Optional[RFFParams] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, fed3r.Fed3RStats, Fed3RHistory]:
    """FED3R (Algorithm 1).  Returns (W*, final stats, accuracy history).

    With ``f3_cfg.n_random_features > 0`` this is FED3R-RF: the server draws
    one shared (Ω, β) (from a ``torch.Generator`` seeded ``fed_cfg.seed +
    101``, unless ``rff_params`` is given) and every client maps its
    features before computing statistics; the test set goes through the
    same map.
    """
    dev = resolve_device(device)
    extractor = extractor or _default_extractor(dev)
    C = dataset.n_classes
    d_raw = int(extractor(dataset.features[:1]).shape[-1])

    use_rf = f3_cfg.n_random_features > 0
    if use_rf and rff_params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(fed_cfg.seed + 101)
        rff_params = rff_init(gen, d_raw, f3_cfg.n_random_features, f3_cfg.rff_sigma)
    d = f3_cfg.n_random_features if use_rf else d_raw
    test_phi = extractor(_host(test_features))
    if use_rf:
        test_phi = rff_map(rff_params, test_phi)
    test_y = as_labels(test_labels, dev)

    sampler = ClientSampler(
        dataset.n_clients, fed_cfg.clients_per_round,
        replacement=fed_cfg.sample_with_replacement, seed=fed_cfg.seed,
    )
    engine = AccumulationEngine(
        EngineConfig(n_classes=C), rff_params=rff_params if use_rf else None, device=dev,
    )
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
    test_acc = float(ncm.accuracy(W, test_phi, as_labels(test_labels, dev)))
    hist.rounds.append(sampler.rounds_to_full_coverage())
    hist.accuracy.append(test_acc)
    return W, hist


# ---------------------------------------------------------------------------
# FED3R + FT (paper §4.4): calibrated softmax init + gradient fine-tuning
# ---------------------------------------------------------------------------

# the parameters each FT strategy trains (1.0) or freezes (0.0)
FT_FREEZE = {
    "full": {"M": 1.0, "W": 1.0, "bias": 1.0},
    "lp": {"M": 0.0, "W": 1.0, "bias": 1.0},
    "feat": {"M": 1.0, "W": 0.0, "bias": 0.0},
}


def feature_finetune_task(
    d: int,
    n_classes: int,
    W_init,
    test_features,
    test_labels,
    *,
    strategy: str = "feat",  # full | lp | feat
    device: Union[str, torch.device] = "cuda",
) -> FLTask:
    """FT task with a trainable feature map M (init = I) + softmax head.

    logits = (x·M)·W + bias — the simulator-scale analogue of fine-tuning
    the extractor: FT trains (M, W), FT-LP trains W only, FT-FEAT trains M
    only with the FED3R classifier W kept fixed (the paper's most robust
    variant in cross-device settings).
    """
    if strategy not in FT_FREEZE:
        raise ValueError(strategy)
    dev = resolve_device(device)
    params0 = {
        "M": torch.eye(d, dtype=torch.float32, device=dev),
        "W": as_f32(W_init, dev),
        "bias": torch.zeros((n_classes,), dtype=torch.float32, device=dev),
    }

    def logits_fn(params, x):
        h = x.to(torch.float32) @ params["M"]
        return h @ params["W"] + params["bias"]

    def per_example_loss(params, batch):
        return softmax_ce(logits_fn(params, batch["x"]), batch["y"])

    tf, tl = as_f32(test_features, dev), as_labels(test_labels, dev)

    @torch.no_grad()
    def eval_fn(params):
        return (logits_fn(params, tf).argmax(-1) == tl).to(torch.float32).mean()

    return FLTask(params0=params0, per_example_loss=per_example_loss,
                  freeze=dict(FT_FREEZE[strategy]), eval_fn=eval_fn)


def run_fed3r_ft(
    dataset: FederatedDataset,
    test_features,
    test_labels,
    f3_cfg: Fed3RConfig,
    fed_cfg: FederatedConfig,
    *,
    strategy: Optional[str] = None,
    use_fed3r_init: bool = True,
    eval_every: int = 10,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Any, Dict[str, Any]]:
    """Two-stage FED3R+FT (paper §4.4 / Table 2).

    Stage 1: FED3R classifier (skipped if ``use_fed3r_init=False`` — the
    paper's "✗ init" ablation rows, whose head is drawn 0.01·N(0, 1) from a
    ``torch.Generator`` seeded ``fed_cfg.seed``).  Temperature-calibrate
    the init on up to 4096 training features.  Stage 2: federated
    fine-tuning with the configured algorithm and the requested freeze
    strategy, one ``round_step`` a round on the cohort round engine;
    ``ckpt_dir``/``resume`` snapshot and restore the FT phase's full
    ServerState at round granularity.
    """
    dev = resolve_device(device)
    strategy = strategy or f3_cfg.ft_strategy
    C = dataset.n_classes
    d = dataset.features.shape[-1]

    # Resuming from a full FT-state snapshot makes stage 1 dead work: the
    # loaded ServerState overwrites whatever init it would produce.
    resuming = bool(ckpt_dir and resume and latest_checkpoint(ckpt_dir))

    info: Dict[str, Any] = {}
    if use_fed3r_init and not resuming:
        W, stats, hist1 = run_fed3r(
            dataset, test_features, test_labels, f3_cfg, fed_cfg,
            eval_every=max(1, dataset.n_clients // fed_cfg.clients_per_round), device=dev,
        )
        # calibrate on a subsample of training features (paper App. C)
        n_cal = min(4096, len(dataset.labels))
        sample = as_f32(dataset.features[:n_cal], dev)
        temp, _ = calibration.calibrate_temperature(
            fed3r.predict(W, sample), as_labels(dataset.labels[:n_cal], dev))
        W_init = calibration.fold_temperature(W, temp)
        info["fed3r_history"] = hist1
        info["temperature"] = float(temp)
        info["fed3r_rounds"] = hist1.rounds[-1] if hist1.rounds else 0
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(fed_cfg.seed)
        W_init = 0.01 * torch.randn((d, C), generator=gen, device=dev)
        info["fed3r_rounds"] = 0

    task = feature_finetune_task(
        d, C, W_init, test_features, test_labels, strategy=strategy, device=dev
    )
    params, hist2 = run_federated(
        task, dataset, fed_cfg, eval_every=eval_every,
        ckpt_dir=ckpt_dir, resume=resume,
    )
    if not resuming:
        info["W_init"] = task.params0["W"]  # the head stage 2 starts from
    info["ft_history"] = hist2
    return params, info
