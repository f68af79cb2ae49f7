"""Federated training driver, phase 1 (FED3R, Algorithm 1), in PyTorch.

The port of the reference's ``launch/train.py`` phase 1: a statistics pass
over packed client shards through the accumulation engine, backbone
features extracted per shard and each client's statistics computed by the
``fed3r_stats`` kernel; then the ridge solve, test accuracy and softmax
temperature calibration of the classifier.

Phase 2 (federated fine-tuning, ``rounds > 0``) is ROADMAP Queue 1 item 7.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch fed3r-mnv2-proxy \\
      --clients 100 --per-round 10 --seq-len 128 --device cuda
"""
from __future__ import annotations

import argparse
import time
from typing import Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration, fed3r
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import pack_client_shards
from repro_torch.data.synthetic import TokenDataset, make_token_dataset
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.engine import AccumulationEngine, EngineConfig
from repro_torch.models import build_model

RIDGE_LAMBDA = 0.01


def fed3r_phase(
    cfg: ModelConfig,
    params: dict,
    ds: TokenDataset,
    *,
    n_clients: int,
    clients_per_round: int,
    device: Union[str, torch.device] = "cuda",
    verbose: bool = True,
) -> dict:
    """Phase 1 on given backbone params and token dataset.

    Every client contributes exactly once: the clients (a one-class-per-
    client split of ``ds``) are packed ``clients_per_round`` to a shard and
    folded by the engine.  The first fifth of ``ds`` is the test set; the
    temperature is calibrated on the next 512 samples.  Returns the
    classifier, its calibrated form, the statistics and what was measured.
    """
    dev = resolve_device(device)
    model = build_model(cfg)
    tokens_np = ds.tokens.cpu().numpy()
    labels_np = ds.labels.cpu().numpy()
    parts = dirichlet_partition(np.random.default_rng(2), labels_np, n_clients, alpha=0.0)
    n_test = len(labels_np) // 5
    tokens, labels = ds.tokens.to(dev), ds.labels.to(dev)

    t0 = time.time()
    engine = AccumulationEngine(
        EngineConfig(n_classes=ds.n_classes),
        feature_fn=lambda p, toks: model.extract_features(p, {"tokens": toks}),
        device=dev,
    )
    packed = pack_client_shards(
        [(tokens_np[parts[k]], labels_np[parts[k]]) for k in range(n_clients)],
        clients_per_shard=clients_per_round,
    )
    acc = engine.accumulate(engine.init(cfg.d_feat), packed, params)
    W = fed3r.solve(acc.stats, RIDGE_LAMBDA)
    with torch.no_grad():
        feats_test = model.extract_features(params, {"tokens": tokens[:n_test]})
        cal = slice(n_test, n_test + 512)
        scores = fed3r.predict(W, model.extract_features(params, {"tokens": tokens[cal]}))
    test_acc = float(fed3r.accuracy(W, feats_test, labels[:n_test]))
    temp, _ = calibration.calibrate_temperature(scores, labels[cal])
    W_head = calibration.fold_temperature(W, temp)
    seconds = time.time() - t0
    if verbose:
        print(f"[fed3r] classifier in {n_clients} client visits "
              f"({seconds:.1f}s)  acc={test_acc:.4f}  T={float(temp):.2f}")
    return {
        "W": W, "W_head": W_head, "stats": acc.stats, "fed3r_acc": test_acc,
        "temperature": float(temp), "seconds": seconds,
        "n_slots": packed.n_slots, "max_n": packed.inputs.shape[2],
    }


def run(
    arch: str,
    *,
    n_classes: int = 16,
    n_clients: int = 40,
    clients_per_round: int = 8,
    rounds: int = 0,
    seq_len: int = 32,
    n_samples: int = 2048,
    device: Union[str, torch.device] = "cuda",
    verbose: bool = True,
) -> dict:
    """Random backbone params (seed 0) and a synthetic token dataset (seed 1),
    then phase 1.  ``rounds > 0`` (fine-tuning) is not ported yet."""
    if rounds > 0:
        raise NotImplementedError(
            "phase 2 (federated fine-tuning, rounds > 0) is ROADMAP Queue 1 item 7"
        )
    dev = resolve_device(device)
    cfg = get_config(arch)
    params = build_model(cfg).init(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ds = make_token_dataset(gen, n_samples, seq_len, cfg.vocab_size, n_classes)
    return fed3r_phase(
        cfg, params, ds, n_clients=n_clients, clients_per_round=clients_per_round,
        device=dev, verbose=verbose,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fed3r-mnv2-proxy-smoke")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--per-round", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(
        args.arch, rounds=args.rounds, n_clients=args.clients,
        clients_per_round=args.per_round, seq_len=args.seq_len, device=args.device,
    )


if __name__ == "__main__":
    main()
