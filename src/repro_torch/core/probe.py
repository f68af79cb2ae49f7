"""RR as a feature-quality probe (paper §5.4, Table 3), in PyTorch.

The port of the reference's ``core/probe.py``.  Fitting the closed-form RR
classifier on a (possibly fine-tuned) extractor's features gives a
deterministic, hyper-parameter-free measure of feature linear separability
— decoupling extractor quality from classifier quality.  In federated
settings the probe is computed through the FED3R formulation, so it is
itself unaffected by heterogeneity.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Tuple, Union

import torch

from repro_torch.core import fed3r


class ProbeResult(NamedTuple):
    accuracy: torch.Tensor
    W: torch.Tensor


def fit_probe(
    features: torch.Tensor,
    labels: torch.Tensor,
    n_classes: int,
    ridge_lambda: float = 0.01,
) -> torch.Tensor:
    """Fit RR on (features, labels); returns the classifier W."""
    stats = fed3r.client_stats(features, labels, n_classes)
    return fed3r.solve(stats, ridge_lambda)


def probe_quality(
    train_features: torch.Tensor,
    train_labels: torch.Tensor,
    test_features: torch.Tensor,
    test_labels: torch.Tensor,
    n_classes: int,
    ridge_lambda: float = 0.01,
) -> ProbeResult:
    """Train-on-train, evaluate-on-test RR accuracy — the Table-3 number."""
    W = fit_probe(train_features, train_labels, n_classes, ridge_lambda)
    acc = fed3r.accuracy(W, test_features, test_labels)
    return ProbeResult(accuracy=acc, W=W)


def probe_extractor(
    extract_fn: Callable[[dict], torch.Tensor],
    batches: Iterable[Tuple[dict, torch.Tensor]],
    n_classes: int,
    d: int,
    ridge_lambda: float = 0.01,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Streaming probe: accumulate FED3R stats over an extractor's batches."""
    stats = fed3r.init_stats(d, n_classes, device)
    for batch, labels in batches:
        feats = extract_fn(batch)
        stats = fed3r.merge(stats, fed3r.client_stats(feats, labels, n_classes))
    return fed3r.solve(stats, ridge_lambda)
