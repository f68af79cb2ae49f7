"""The federation simulator's set-up at the paper's feature width.

50,000 synthetic d = 1280 features (MobileNetV2's width) of 100 Gaussian
classes, one class a client (alpha 0, the most heterogeneous split) over
100 clients, 10 a round; λ = 0.01 (paper App. C).  FED3R-RF maps them to
D = 5000 random features, the smaller of the paper's D ∈ {5k, 10k}.
``chip_smoke.py``'s ``[sim]`` and ``[rf]`` cells and ``profile_slice
--cell rf`` all build it here, so a profile measures the cell the check
reports.  Importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.configs.base import Fed3RConfig, FederatedConfig

FEATURES = dict(n=50_000, d=1280, n_classes=100, n_clients=100, alpha=0.0, noise=2.0)
CLIENTS_PER_ROUND = 10
RIDGE_LAMBDA = 0.01
RF_D = 5000


def simulator_setup(device, n_random_features: int = 0):
    """``(fed, test, f3, fc)``: the features (seed 0) on ``device``, the
    Fed3R config (``n_random_features`` > 0 for FED3R-RF) and the
    federation's, one round a shard of fresh clients."""
    from repro_torch.data.pipeline import make_federated_features

    fed, test = make_federated_features(seed=0, **FEATURES, device=device)
    f3 = Fed3RConfig(ridge_lambda=RIDGE_LAMBDA, n_classes=FEATURES["n_classes"],
                     n_random_features=n_random_features)
    fc = FederatedConfig(n_clients=FEATURES["n_clients"], clients_per_round=CLIENTS_PER_ROUND,
                         n_rounds=FEATURES["n_clients"])
    return fed, test, f3, fc
