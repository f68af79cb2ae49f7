"""Softmax-temperature calibration of the FED3R initialization (paper §4.4).

The RR solution minimizes squared loss, so its score scale does not match the
cross-entropy landscape used in fine-tuning.  The paper calibrates by scanning
softmax temperatures and picking the one minimizing training CE (App. C,
Fig. 7 — best temperature 0.1 on both datasets).  We fold 1/T into the
classifier weights so the FT phase starts from W/T with an ordinary softmax.
"""
from __future__ import annotations

from typing import Tuple

import torch

DEFAULT_TEMPERATURES = (3.0, 1.0, 0.3, 0.1, 0.03, 0.01)


def ce_at_temperature(
    scores: torch.Tensor, labels: torch.Tensor, temp: torch.Tensor
) -> torch.Tensor:
    logits = scores.to(torch.float32) / temp
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return (lse - picked).mean()


def calibrate_temperature(
    scores: torch.Tensor,  # (n, C) RR scores on (a sample of) the training set
    labels: torch.Tensor,  # (n,)
    temperatures=DEFAULT_TEMPERATURES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-search the temperature. Returns (best_temp, per-temp CE)."""
    temps = torch.tensor(temperatures, dtype=torch.float32, device=scores.device)
    labels = labels.to(scores.device)
    ces = torch.stack([ce_at_temperature(scores, labels, t) for t in temps])
    return temps[torch.argmin(ces)], ces


def fold_temperature(W: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Return the calibrated softmax-classifier init W/T."""
    return W / temp
