"""Quickstart: FED3R in ~40 lines, on the port.

A heterogeneous federation (one class per client), a frozen feature space,
and the closed-form federated ridge classifier — converging exactly in
⌈K/κ⌉ rounds and matching the centralized solution to float precision.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import Fed3RConfig, FederatedConfig
from repro_torch.core import fed3r
from repro_torch.data.pipeline import make_federated_features
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.fed3r_driver import run_fed3r


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # 100 clients, pathological heterogeneity: every client holds ONE class
    # (drawn on the host: the same federation on any device)
    fed, test = make_federated_features(seed=0, n=8000, d=64, n_classes=10, n_clients=100,
                                        alpha=0.0, noise=2.0, device="cpu")
    f3 = Fed3RConfig(ridge_lambda=0.01, n_classes=10)
    fc = FederatedConfig(n_clients=100, clients_per_round=10, n_rounds=100)

    W, stats, hist = run_fed3r(fed, test.features, test.labels, f3, fc, eval_every=1,
                               device=dev)
    print("round | clients seen | test accuracy")
    for r, seen, acc in zip(hist.rounds, hist.clients_seen, hist.accuracy):
        print(f"{r:5d} | {seen:12d} | {acc:.4f}")

    # exact equivalence with the centralized ridge solution (paper §4.3)
    cen = fed3r.solve(fed3r.client_stats(torch.as_tensor(fed.features, device=dev),
                                         torch.as_tensor(fed.labels, device=dev), 10),
                      f3.ridge_lambda)
    gap = float((W - cen).abs().max())
    print(f"\nconverged in {hist.rounds[-1]} rounds (= ceil(100/10))")
    print(f"max |W_federated - W_centralized| = {gap:.2e}  (exact aggregation)")
    return {"rounds": hist.rounds, "clients_seen": hist.clients_seen,
            "accuracy": hist.accuracy, "gap": gap, "n_test": int(test.labels.shape[0])}


if __name__ == "__main__":
    main()
