"""Client-shard accumulation engine for FED3R statistics, in PyTorch.

The port of the reference's ``federated/engine.py``.  Every consumer of
Eq. 5/6 — the simulator drivers (:mod:`repro_torch.federated.fed3r_driver`)
and the datacenter path (:mod:`repro_torch.launch.train`) — funnels through
:class:`AccumulationEngine`:

* the packed client selection (:class:`repro_torch.data.pipeline.
  PackedClients`) moves to the engine's device once per call;
* per shard, ``feature_fn`` maps the flattened raw inputs (tokens, or
  precomputed features) to φ features in one batch, so backbone extraction
  batches over whole shards;
* per client block, the masked design goes through ONE launch of the
  ``fed3r_stats`` kernel (:func:`repro_torch.kernels.ops.fed3r_stats`; its
  plain version on the CPU), and the block folds into the accumulator.

Exactness: per-client blocks have identical padded shapes, the kernel sums
each element in sample order without atomics, and the client fold is a
strict left fold in sorted-id order regardless of how clients land in
shards — so A and b are bit-identical under client reordering AND
re-sharding (different ``clients_per_shard``), the paper's §4.3 invariance
made exact rather than approximate.

Not ported yet: compressed wire formats (ROADMAP Queue 1 item 6), the fused
FED3R-RF map (item 3), the psum/mesh/tree backends (item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import fed3r, ncm
from repro_torch.core.fed3r import Fed3RStats
from repro_torch.data.pipeline import PackedClients
from repro_torch.federated.dist import (
    DistConfig,
    DistContext,
    DistDispatchMixin,
    resolve_device,
)
from repro_torch.federated.telemetry import Telemetry
from repro_torch.kernels.ops import fed3r_stats


class EngineStats(NamedTuple):
    """Engine accumulator: ridge statistics + per-class sample counts.

    ``class_counts`` rides along for free (one masked one-hot column sum per
    client) and makes the NCM baseline a byproduct of the same pass:
    ``NCMStats(sums=stats.b.T, counts=class_counts)``.
    """

    stats: Fed3RStats
    class_counts: torch.Tensor  # (C,) fp32


def engine_init(
    d: int, n_classes: int, device: Union[str, torch.device] = "cuda"
) -> EngineStats:
    dev = resolve_device(device)
    return EngineStats(
        stats=fed3r.init_stats(d, n_classes, dev),
        class_counts=torch.zeros((n_classes,), dtype=torch.float32, device=dev),
    )


def to_ncm_stats(acc: EngineStats) -> ncm.NCMStats:
    """The FedNCM view of the accumulated statistics (sums = bᵀ)."""
    return ncm.NCMStats(sums=acc.stats.b.T, counts=acc.class_counts)


@dataclass(frozen=True)
class EngineConfig:
    n_classes: int
    dist: DistConfig = field(default_factory=DistConfig)  # "merge" only
    # statistics wire format; the compressed formats are a later slice
    wire: str = "fp32"

    def __post_init__(self):
        if self.wire != "fp32":
            raise NotImplementedError(
                f"wire={self.wire!r}: compressed statistics uplinks are ROADMAP "
                "Queue 1 item 6; the port carries fp32 statistics only"
            )


class AccumulationEngine(DistDispatchMixin):
    """Packed client-shard accumulation of FED3R statistics.

    ``feature_fn(params, flat_inputs) -> (n, d)`` maps the packed raw inputs
    of one shard (flattened to ``(clients_per_shard·max_n, ...)``) to φ
    features; ``None`` means the inputs already are features.  Everything
    runs on ``device`` (the card by default).
    """

    def __init__(
        self,
        cfg: EngineConfig,
        *,
        feature_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
        rff_params: Optional[Any] = None,
        device: Union[str, torch.device] = "cuda",
        telemetry: Optional[Telemetry] = None,
    ):
        if rff_params is not None:
            raise NotImplementedError(
                "rff_params: the fused FED3R-RF map is ROADMAP Queue 1 item 3"
            )
        self.cfg = cfg
        self.feature_fn = feature_fn
        self.device = resolve_device(device)
        self.dist = DistContext(cfg.dist, engine="accumulation", telemetry=telemetry)

    def init(self, d: int) -> EngineStats:
        return engine_init(d, self.cfg.n_classes, self.device)

    def _client_fold(
        self, acc: EngineStats, feats: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
    ) -> EngineStats:
        """Fold one client's padded block into the accumulator (one launch)."""
        z, y, n = fed3r.masked_design(feats, labels, self.cfg.n_classes, mask)
        A, b = fed3r_stats(z, y)
        return EngineStats(
            stats=fed3r.merge(acc.stats, Fed3RStats(A=A, b=b, n=n)),
            class_counts=acc.class_counts + y.sum(dim=0),
        )

    @torch.no_grad()
    def accumulate(
        self, acc: EngineStats, packed: PackedClients, params: Any = None
    ) -> EngineStats:
        """Fold a packed client selection into the accumulator.

        Shards in order, and within a shard the clients in slot order: a
        strict left fold in canonical client-id order.
        """
        with self.dist.telemetry.span("accumulate", engine="accumulation"):
            self.dist.dispatch()
            inputs = torch.as_tensor(packed.inputs, device=self.device)
            labels = torch.as_tensor(packed.labels, device=self.device)
            mask = torch.as_tensor(packed.mask, device=self.device)
            for x, y, m in zip(inputs, labels, mask):  # (P, N, ...), (P, N), (P, N)
                flat = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
                feats = flat if self.feature_fn is None else self.feature_fn(params, flat)
                feats = feats.reshape(tuple(x.shape[:2]) + tuple(feats.shape[1:]))
                for c in range(x.shape[0]):
                    acc = self._client_fold(acc, feats[c], y[c], m[c])
            return acc  # "merge": the local fold IS the global sum
