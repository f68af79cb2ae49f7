"""Synthetic federated data generators, on ``torch.Generator``.

The port of the reference's ``data/synthetic.py``.  The two generators draw
from the same distributions as the reference's, but from another random
stream: equal in distribution, not in bits.  Tests that compare the two
packages make their data with the reference (or numpy) and hand the arrays
to both.

* ``make_feature_dataset`` — "pre-extracted φ(x)" vectors: Gaussian class
  clusters, or (``nonlinear``) labels from random quadratic forms, so that
  classes are not linearly separable.
* ``make_token_dataset`` — class-conditional token sequences for the
  backbone drivers (each class has its own unigram distribution; a
  class-specific prefix token makes features informative).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureDataset(NamedTuple):
    features: torch.Tensor  # (n, d) fp32
    labels: torch.Tensor  # (n,) int64
    n_classes: int


def make_feature_dataset(
    gen: torch.Generator,
    n: int,
    d: int,
    n_classes: int,
    *,
    noise: float = 1.0,
    class_scale: float = 3.0,
    nonlinear: bool = False,
    class_imbalance: float = 0.0,  # 0 = balanced; >0 = Zipf-like skew exponent
) -> FeatureDataset:
    """Draw on the generator's device (a CUDA generator draws on the card)."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if nonlinear:
        # labels from random QUADRATIC forms: class = argmax_c xᵀQ_c x + q_cᵀx
        x = normal(n, d)
        Q = normal(n_classes, d, d) / d ** 0.5
        q = 0.3 * normal(n_classes, d)
        scores = torch.einsum("nd,cde,ne->nc", x, Q, x) + x @ q.T
        labels = torch.argmax(scores + noise * normal(n, n_classes), dim=-1)
        return FeatureDataset(features=x * class_scale, labels=labels, n_classes=n_classes)

    means = class_scale * normal(n_classes, d)
    if class_imbalance > 0:
        w = 1.0 / torch.arange(1, n_classes + 1, dtype=torch.float32, device=dev) ** class_imbalance
        labels = torch.multinomial(w / w.sum(), n, replacement=True, generator=gen)
    else:
        labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    x = means[labels] + noise * normal(n, d)
    return FeatureDataset(features=x, labels=labels, n_classes=n_classes)


class TokenDataset(NamedTuple):
    tokens: torch.Tensor  # (n, S) int64
    labels: torch.Tensor  # (n,) int64 class labels
    lm_labels: torch.Tensor  # (n, S) next-token targets
    n_classes: int


def make_token_dataset(
    gen: torch.Generator,
    n: int,
    seq_len: int,
    vocab_size: int,
    n_classes: int,
    *,
    sharpness: float = 2.0,
) -> TokenDataset:
    """Class-conditional unigram sequences with a class-id prefix token."""
    dev = gen.device
    class_logits = sharpness * torch.randn((n_classes, vocab_size), generator=gen, device=dev)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    probs = torch.softmax(class_logits, dim=-1)
    toks = torch.empty((n, seq_len), dtype=torch.int64, device=dev)
    for c in range(n_classes):  # one draw per class: no (n, vocab) matrix
        rows = torch.nonzero(labels == c).flatten()
        if len(rows):
            draw = torch.multinomial(probs[c], len(rows) * seq_len, replacement=True, generator=gen)
            toks[rows] = draw.view(len(rows), seq_len)
    # class prefix token (mod vocab) so even a mean-pooled feature is class-aware
    toks[:, 0] = labels % vocab_size
    lm_labels = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    return TokenDataset(tokens=toks, labels=labels, lm_labels=lm_labels, n_classes=n_classes)
