"""Fed3R-RF on the port: pre-extracted features through the random-features map.

* :func:`make_inputs`: the federation's features, by a copy of the port's
  ``data/synthetic.py::make_feature_dataset`` method (Gaussian class means
  at ``class_scale``, isotropic noise at ``noise``), drawn on the card from
  the seed and handed to the host as fp32 (``pack_client_shards`` packs
  numpy);
* :func:`make_params`: the server's shared (Omega, beta), Omega normal at
  1/sigma and beta uniform on [0, 2 pi), as ``core/random_features.py``
  draws them, on the card from the seed;
* :func:`engine`: the port's ``AccumulationEngine`` with ``rff_params``, as
  ``federated/fed3r_driver.py::run_fed3r`` builds it for FED3R-RF.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import yardstick


def make_inputs(config: dict, traffic: dict, fed, gen: torch.Generator) -> np.ndarray:
    """(N, d) fp32 features, rows in the federation's order."""
    dev, d = gen.device, config["d"]
    labels = torch.from_numpy(fed.labels).to(dev).long()
    means = config["class_scale"] * torch.randn((fed.n_classes, d), generator=gen, device=dev)
    x = torch.randn((len(labels), d), generator=gen, device=dev).mul_(config["noise"])
    x += means[labels]
    return x.cpu().numpy()


def make_params(config: dict, gen: torch.Generator) -> dict:
    d, D, dev = config["d"], config["n_random_features"], gen.device
    omega = torch.randn((d, D), generator=gen, device=dev) / config["rff_sigma"]
    beta = torch.rand((D,), generator=gen, device=dev) * (2.0 * math.pi)
    return {"omega": omega, "beta": beta}


def engine(config: dict, params: dict, n_classes: int, device):
    """(the port's engine, the statistics' width)."""
    from repro_torch.core.random_features import RFFParams
    from repro_torch.federated.engine import AccumulationEngine, EngineConfig

    sigma = torch.tensor(config["rff_sigma"], dtype=torch.float32, device=params["omega"].device)
    rff = RFFParams(omega=params["omega"], beta=params["beta"], sigma=sigma)
    eng = AccumulationEngine(EngineConfig(n_classes=n_classes), rff_params=rff, device=device)
    return eng, config["n_random_features"]


def sample_flops(config: dict, traffic: dict) -> float:
    """What one live sample needs: its random features and its share of the
    statistics."""
    D = config["n_random_features"]
    return (yardstick.rff_sample_flops(config["d"], D)
            + yardstick.stats_sample_flops(D, traffic["n_classes"]))


def launches(config: dict, rounds: list) -> dict:
    """The live rows of each launch of the port's kernels in ``rounds``:
    ``rff`` once a shard, ``fed3r_stats`` once a slot."""
    return {"rff": [n for r in rounds for n in r["shard_live"]],
            "fed3r_stats": [n for r in rounds for n in r["slot_live"]]}
