"""Client-shard accumulation engine for FED3R statistics, in PyTorch.

The port of the reference's ``federated/engine.py``.  Every consumer of
Eq. 5/6 — the simulator drivers (:mod:`repro_torch.federated.fed3r_driver`)
and the datacenter path (:mod:`repro_torch.launch.train`) — funnels through
:class:`AccumulationEngine`:

* the packed client selection (:class:`repro_torch.data.pipeline.
  PackedClients`) moves to the engine's device once per call;
* per shard, ``feature_fn`` maps the flattened raw inputs (tokens, or
  precomputed features) to φ features in one batch, so backbone extraction
  batches over whole shards; with ``rff_params`` (FED3R-RF) the shard's
  features then go through ONE launch of the fused random-features kernel
  (:func:`repro_torch.kernels.ops.rff_transform`).  ψ(0) ≠ 0, so padding
  rows are masked after the map, in the masked design, as in the reference;
* per client block, the masked design goes through ONE launch of the
  ``fed3r_stats`` kernel (:func:`repro_torch.kernels.ops.fed3r_stats`; its
  plain version on the CPU), and the block folds into the accumulator;
* with a compressed wire format (``EngineConfig(wire=WireFormat(kind="int8"
  | "fp8" | "sketch"))``) each client's (A_k, b_k) crosses the wire
  compressed and lands in the fp32 accumulator through
  :func:`repro_torch.federated.compress.roundtrip_add` — under int8 two
  ``quantize_tiles`` and two ``dequant_accumulate`` launches per client.
  The tiny exact sidecars (n, class counts) stay fp32.

Exactness: per-client blocks have identical padded shapes, the kernel sums
each element in sample order without atomics, and the client fold is a
strict left fold in sorted-id order regardless of how clients land in
shards — so A and b are bit-identical under client reordering AND
re-sharding (different ``clients_per_shard``), the paper's §4.3 invariance
made exact rather than approximate.

Not ported yet: the psum/mesh/tree backends (ROADMAP Queue 1 item 8), and
with them the compressed wire's psum form.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import fed3r, ncm
from repro_torch.core.fed3r import Fed3RStats
from repro_torch.core.random_features import RFFParams, rff_map
from repro_torch.data.pipeline import PackedClients
from repro_torch.federated import compress
from repro_torch.federated.compress import WireFormat
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
    # statistics wire format (repro_torch.federated.compress): each client's
    # (A_k, b_k) crosses the wire in this format; fp32 is bitwise the
    # uncompressed engine
    wire: WireFormat = field(default_factory=WireFormat)


class AccumulationEngine(DistDispatchMixin):
    """Packed client-shard accumulation of FED3R statistics.

    ``feature_fn(params, flat_inputs) -> (n, d)`` maps the packed raw inputs
    of one shard (flattened to ``(clients_per_shard·max_n, ...)``) to φ
    features; ``None`` means the inputs already are features.
    ``rff_params`` maps each shard's φ through the FED3R-RF random features.
    Everything runs on ``device`` (the card by default).
    """

    def __init__(
        self,
        cfg: EngineConfig,
        *,
        feature_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
        rff_params: Optional[RFFParams] = None,
        device: Union[str, torch.device] = "cuda",
        telemetry: Optional[Telemetry] = None,
    ):
        if rff_params is not None and not isinstance(rff_params, RFFParams):
            raise TypeError(f"rff_params must be RFFParams, got {type(rff_params).__name__}")
        self.cfg = cfg
        self.feature_fn = feature_fn
        self.rff_params = rff_params
        self.device = resolve_device(device)
        self.wire = cfg.wire.resolved()  # fp8 → int8 only where torch lacks fp8
        self.dist = DistContext(cfg.dist, engine="accumulation", telemetry=telemetry)

    def init(self, d: int) -> EngineStats:
        return engine_init(d, self.cfg.n_classes, self.device)

    def _client_fold(
        self, acc: EngineStats, feats: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
    ) -> EngineStats:
        """Fold one client's padded block into the accumulator: one
        ``fed3r_stats`` launch, then the wire format's fold."""
        z, y, n = fed3r.masked_design(feats, labels, self.cfg.n_classes, mask)
        A, b = fed3r_stats(z, y)
        if self.wire.kind == "fp32":
            stats = fed3r.merge(acc.stats, Fed3RStats(A=A, b=b, n=n))
        else:
            accA, accb = compress.roundtrip_add(acc.stats.A, acc.stats.b, A, b, self.wire)
            stats = Fed3RStats(A=accA, b=accb, n=acc.stats.n + n)
        return EngineStats(stats=stats, class_counts=acc.class_counts + y.sum(dim=0))

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
                if self.rff_params is not None:  # one kernel launch per shard
                    feats = rff_map(self.rff_params, feats)
                feats = feats.reshape(tuple(x.shape[:2]) + tuple(feats.shape[1:]))
                for c in range(x.shape[0]):
                    acc = self._client_fold(acc, feats[c], y[c], m[c])
            return acc  # "merge": the local fold IS the global sum
