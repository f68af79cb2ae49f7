"""FedNCM baseline (Legate et al. 2023a) — Nearest Class Mean classifier.

The paper's Table 1/6 ablation: like FED3R, FedNCM aggregates exactly
(per-class feature sums + counts are associative), but the classifier is the
matrix of normalized class centroids instead of the ridge solution.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.fed3r import normalize_columns
from repro_torch.federated.dist import resolve_device


class NCMStats(NamedTuple):
    sums: torch.Tensor  # (C, d) per-class feature sums
    counts: torch.Tensor  # (C,) per-class sample counts


def init_stats(
    d: int, n_classes: int, device: Union[str, torch.device] = "cuda"
) -> NCMStats:
    dev = resolve_device(device)
    return NCMStats(
        sums=torch.zeros((n_classes, d), dtype=torch.float32, device=dev),
        counts=torch.zeros((n_classes,), dtype=torch.float32, device=dev),
    )


def client_stats(
    features: torch.Tensor, labels: torch.Tensor, n_classes: int,
    mask: Optional[torch.Tensor] = None,
) -> NCMStats:
    z = features.to(torch.float32)
    oh = F.one_hot(labels.long(), n_classes).to(torch.float32)  # (n, C)
    if mask is not None:
        oh = oh * mask.to(torch.float32)[:, None]
    return NCMStats(sums=oh.T @ z, counts=oh.sum(dim=0))


def merge(*stats: NCMStats) -> NCMStats:
    return NCMStats(
        sums=sum(s.sums for s in stats), counts=sum(s.counts for s in stats)
    )


def solve(stats: NCMStats, normalize: bool = True) -> torch.Tensor:
    """Classifier W (d, C): column c = (normalized) class centroid."""
    means = stats.sums / torch.clamp_min(stats.counts, 1.0)[:, None]  # (C, d)
    W = means.T
    if normalize:
        W = normalize_columns(W)
    return W


def accuracy(W: torch.Tensor, features: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    scores = features.to(torch.float32) @ W
    return (torch.argmax(scores, -1) == labels.to(W.device).long()).to(torch.float32).mean()
