"""Federated partitioners — statistical heterogeneity control.

``dirichlet_partition`` follows Hsu et al. (2019): each client draws a
class-mixture q ~ Dir(α·prior) and samples its examples from it.  α → ∞
recovers IID; α = 0 degenerates to one-class-per-client (the paper's
"most heterogeneous" Cifar100 split, App. C).

``quantity_skew_sizes`` adds lognormal dataset-size skew across clients
(the paper's datasets have 13–327 avg samples/client, Table 4).
"""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(rng: np.random.Generator, n: int, n_clients: int) -> List[np.ndarray]:
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def dirichlet_partition(
    rng: np.random.Generator,
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    min_size: int = 1,
) -> List[np.ndarray]:
    """Label-skew partition. alpha=0 → each client gets a single class."""
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idxs in by_class:
        rng.shuffle(idxs)

    clients: List[list] = [[] for _ in range(n_clients)]

    if alpha <= 0.0:
        # one class per client, classes dealt round-robin
        per_client_class = np.arange(n_clients) % n_classes
        # split each class's examples evenly among clients owning it
        owners = [np.flatnonzero(per_client_class == c) for c in range(n_classes)]
        for c in range(n_classes):
            if len(owners[c]) == 0:
                continue
            parts = np.array_split(by_class[c], len(owners[c]))
            for o, part in zip(owners[c], parts):
                clients[o].extend(part.tolist())
        return [np.sort(np.asarray(cl, np.int64)) for cl in clients]

    # proportions per class over clients
    for c in range(n_classes):
        props = rng.dirichlet(alpha * np.ones(n_clients))
        counts = np.floor(props * len(by_class[c])).astype(int)
        # distribute the remainder
        rem = len(by_class[c]) - counts.sum()
        if rem > 0:
            extra = rng.choice(n_clients, size=rem, replace=True, p=props)
            np.add.at(counts, extra, 1)
        start = 0
        for k in range(n_clients):
            clients[k].extend(by_class[c][start : start + counts[k]].tolist())
            start += counts[k]

    # guarantee min_size by stealing from the largest clients
    for k in range(n_clients):
        while len(clients[k]) < min_size:
            donor = int(np.argmax([len(cl) for cl in clients]))
            clients[k].append(clients[donor].pop())
    return [np.sort(np.asarray(cl, np.int64)) for cl in clients]


def quantity_skew_sizes(
    rng: np.random.Generator, n: int, n_clients: int, sigma: float = 1.0
) -> np.ndarray:
    """Lognormal client sizes summing to n (each ≥ 1)."""
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=n_clients)
    sizes = np.maximum(1, np.floor(raw / raw.sum() * n).astype(int))
    # fix rounding drift
    while sizes.sum() > n:
        sizes[int(np.argmax(sizes))] -= 1
    while sizes.sum() < n:
        sizes[int(np.argmin(sizes))] += 1
    return sizes
