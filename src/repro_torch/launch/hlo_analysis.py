"""Collective wire bytes and roofline terms of a rank's program.

The port's counterpart of the reference's ``launch/hlo_analysis.py``.  The
reference parses the compiled, partitioned HLO; the port has no HLO: a
rank issues its collectives eagerly, and each goes through
:func:`repro_torch.sharding.hints.collective`, which records it in the
active census (:func:`repro_torch.sharding.hints.census`) as the logical
collective it stands for, with its buffer bytes and group size.
:func:`collective_stats` sums, per collective kind, the *wire bytes per
card* of those records by the reference's ring-algorithm factors:

    all-reduce        2·(n−1)/n · buffer
    all-gather        (n−1)/n · result        (result = gathered buffer)
    reduce-scatter    (n−1)   · result        (operand = n·result)
    all-to-all        (n−1)/n · buffer
    collective-permute  1 · buffer

where n is the group's size.  A record's buffer is what the census took:
an all-reduce's operand, an all-gather's gathered result, a
reduce-scatter's result block.

Eager PyTorch hides no loop body, so the dry run (:mod:`repro_torch.launch.dryrun`)
counts the whole program and needs no depth extrapolation; the
:class:`CollectiveStats` arithmetic (``scaled``, ``minus``,
``plus_scaled``) is kept, as the reference's, for callers that combine
censuses.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable

from repro_torch.sharding.hints import Collective

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    wire_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    buffer_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def scaled(self, factor: float) -> "CollectiveStats":
        out = CollectiveStats()
        for k in self.counts:
            out.counts[k] = int(self.counts[k] * factor)
            out.buffer_bytes[k] = self.buffer_bytes[k] * factor
            out.wire_bytes[k] = self.wire_bytes[k] * factor
        return out

    def minus(self, other: "CollectiveStats") -> "CollectiveStats":
        out = CollectiveStats()
        keys = set(self.counts) | set(other.counts)
        for k in keys:
            out.counts[k] = self.counts.get(k, 0) - other.counts.get(k, 0)
            out.buffer_bytes[k] = self.buffer_bytes.get(k, 0.0) - other.buffer_bytes.get(k, 0.0)
            out.wire_bytes[k] = self.wire_bytes.get(k, 0.0) - other.wire_bytes.get(k, 0.0)
        return out

    def plus_scaled(self, other: "CollectiveStats", factor: float) -> "CollectiveStats":
        # clamped at zero, as the reference's: a per-layer delta of a rare
        # collective kind can come out slightly negative
        out = CollectiveStats()
        keys = set(self.counts) | set(other.counts)
        for k in keys:
            out.counts[k] = max(
                int(self.counts.get(k, 0) + factor * other.counts.get(k, 0)), 0
            )
            out.buffer_bytes[k] = max(
                self.buffer_bytes.get(k, 0.0) + factor * other.buffer_bytes.get(k, 0.0), 0.0
            )
            out.wire_bytes[k] = max(
                self.wire_bytes.get(k, 0.0) + factor * other.wire_bytes.get(k, 0.0), 0.0
            )
        return out

    def summary(self) -> str:
        lines = []
        for k in sorted(self.counts):
            lines.append(
                f"{k:20s} n={self.counts[k]:4d} buffer={self.buffer_bytes[k]/1e6:10.1f}MB"
                f" wire={self.wire_bytes[k]/1e6:10.1f}MB"
            )
        lines.append(f"{'TOTAL':20s} wire={self.total_wire_bytes/1e6:10.1f}MB")
        return "\n".join(lines)


def wire_bytes(kind: str, buf: float, n: int) -> float:
    """A card's wire bytes of one ``kind`` collective of ``buf`` bytes over
    a group of ``n`` (the ring factors above)."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / max(n, 1) * buf
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / max(n, 1) * buf
    if kind == "reduce-scatter":
        return float(n - 1) * buf
    if kind == "collective-permute":
        return float(buf)
    raise ValueError(f"unknown collective kind {kind!r}; the kinds are {_COLLECTIVES}")


def collective_stats(records: Iterable[Collective]) -> CollectiveStats:
    """Per-card wire bytes, buffer bytes and counts per collective kind of
    a census's records."""
    stats = CollectiveStats()
    for rec in records:
        stats.counts[rec.kind] += 1
        stats.buffer_bytes[rec.kind] += rec.nbytes
        stats.wire_bytes[rec.kind] += wire_bytes(rec.kind, rec.nbytes, rec.group)
    return stats


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_global: float
    hlo_bytes_global: float
    collective_wire_bytes_per_chip: float
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    n_chips: int,
    *,
    peak_flops: float,
    hbm_bw: float,
    ici_bw: float,
) -> RooflineTerms:
    """Three-term roofline, as the reference's:

    compute   = FLOPs / (cards × peak)   [= flops_pd / peak]
    memory    = bytes / (cards × HBM_bw) [= bytes_pd / bw]
    collective= wire_bytes_pd / link_bw  (``ici_bw``: the card's link rate)
    """
    return RooflineTerms(
        compute_s=flops_per_device / peak_flops,
        memory_s=bytes_per_device / hbm_bw,
        collective_s=wire_bytes_per_device / ici_bw,
        hlo_flops_global=flops_per_device * n_chips,
        hlo_bytes_global=bytes_per_device * n_chips,
        collective_wire_bytes_per_chip=wire_bytes_per_device,
        n_chips=n_chips,
    )
