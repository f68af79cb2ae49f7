"""The one generator of the statistics cells' federations.

It reads a traffic file (``perfbench/traffic/<name>.json``):

* ``n_clients``, ``n_samples``, ``n_classes``: the source federation's counts;
* ``size_sigma``: the log-normal sigma of the client sizes, which are scaled
  to the source's mean and rounded to sum to ``n_samples`` exactly;
* ``label_alpha``: the Dirichlet concentration of each client's label mix;
* ``clients_per_round``, ``clients_per_shard``: a round is one
  ``AccumulationEngine.accumulate`` call over that many clients;
* ``layout_seed``: fixes the client sizes and their order.

A client is one slot of a packed shard.  The layout (sizes, order, rounds)
comes from ``layout_seed`` alone, so every ``--seed`` runs the same rounds at
the same shapes and the same work; ``--seed`` draws the labels here, and the
inputs and weights in the family.
Clients sit in round order in the sample arrays: client ``k`` holds rows
``offsets[k]:offsets[k + 1]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Federation:
    sizes: np.ndarray  # (K,) samples of each client, in round order
    offsets: np.ndarray  # (K + 1,) row offsets of the clients
    labels: np.ndarray  # (N,) int32
    rounds: List[np.ndarray]  # a (slots, 2) array of [start, end) rows a round
    n_classes: int
    clients_per_shard: int

    @property
    def n_samples(self) -> int:
        return int(self.offsets[-1])


def client_sizes(n_clients: int, n_samples: int, sigma: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Log-normal sizes scaled to ``n_samples / n_clients`` on average, each
    at least 1, summing to ``n_samples`` exactly."""
    if n_samples < n_clients:
        raise ValueError(f"{n_samples} samples cannot fill {n_clients} clients")
    raw = rng.lognormal(0.0, sigma, n_clients)
    raw *= n_samples / raw.sum()
    sizes = np.maximum(1, np.floor(raw)).astype(np.int64)
    short = int(n_samples - sizes.sum())
    if short > 0:  # the largest fractional parts get one more
        sizes[np.argsort(-(raw - np.floor(raw)), kind="stable")[:short]] += 1
    while short < 0:  # clients raised to 1 overfilled: the largest give one back
        big = np.flatnonzero(sizes > 1)
        take = big[np.argsort(-sizes[big], kind="stable")[:-short]]
        sizes[take] -= 1
        short += len(take)
    return sizes


def client_labels(sizes: np.ndarray, n_classes: int, alpha: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Each client's labels from its own Dirichlet(alpha) mix over the classes:
    one inverse-CDF lookup over the clients' stacked CDFs."""
    mix = rng.dirichlet(np.full(n_classes, alpha), size=len(sizes))
    cdf = np.cumsum(mix, axis=1)
    cdf[:, -1] = 1.0
    owner = np.repeat(np.arange(len(sizes)), sizes)
    flat = (cdf + np.arange(len(sizes))[:, None]).ravel()
    hit = np.searchsorted(flat, owner + rng.random(len(owner)), side="right")
    return np.minimum(hit - owner * n_classes, n_classes - 1).astype(np.int32)


def build(traffic: dict, seed: int) -> Federation:
    """The federation of ``traffic``: its layout from ``layout_seed``, its
    labels from ``seed``."""
    layout = np.random.default_rng(int(traffic["layout_seed"]))
    sizes = client_sizes(traffic["n_clients"], traffic["n_samples"], traffic["size_sigma"], layout)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    labels = client_labels(sizes, traffic["n_classes"], traffic["label_alpha"],
                           np.random.default_rng(seed))
    per_round = traffic["clients_per_round"]
    bounds = np.stack([offsets[:-1], offsets[1:]], axis=1).astype(np.int64)
    rounds = [bounds[first:first + per_round] for first in range(0, len(sizes), per_round)]
    return Federation(sizes=sizes, offsets=offsets, labels=labels, rounds=rounds,
                      n_classes=traffic["n_classes"],
                      clients_per_shard=traffic["clients_per_shard"])
