"""Hierarchical N-tier aggregation trees — edge → region → cloud.

The port of the reference's ``federated/tiers.py`` for its host tiers.
Fed3R's statistics are ORDER-INVARIANT additive sums (paper §4.3): any
reduction topology yields the same A/b, so topology is a free performance
variable.  Every tier of an :class:`AggregationTree` owns

* a BATCHING WINDOW — ``fan_in`` child payloads fold in ONE fixed order per
  tier, so with fp32 wires the final ``W`` stays bitwise equal to the flat
  sum on grid-exact statistics;
* a WIRE FORMAT — the payload crosses each boundary compressed
  (:mod:`repro_torch.federated.compress`) and is dequantized exactly ONCE
  per boundary through the fused dequantize-accumulate (int8: one
  ``quantize_tiles`` and one ``dequant_acc`` launch per child matrix);
* a STALENESS BUDGET — how many segments the tier's upward reduction may
  trail the newest arrival (the depth of the pending-reduction ring).

:meth:`AggregationTree.fold_stacked` folds stacked child payloads tier by
tier.  The reference vmaps its per-matrix wire over the stacked groups; the
port's kernels take 2-D operands, so the fold loops over the children and
over the groups, one launch each, in the reference's order.
:class:`TieredAbsorber` splits each segment at the top-tier boundary into a
LOWER part (the leaf payloads, one ``fed3r_stats`` launch a leaf, and every
tier below the top) and an UPPER part (the top-tier crossing, the
refactorization and the solve).  With ``overlap=True`` the upper part of
segment t is issued after the lower part of segment t+1: on one CUDA
stream the host queues the next segment's work while the card still runs
the previous one, the same kind of overlap the reference gets from XLA's
asynchronous dispatch.

Every tier crossing is metered through the telemetry registry —
``tier_wire_bytes_total{tier=...}`` / ``tier_batches_total{tier=...}``
counters, ``tier_lower``/``tier_upper`` spans, the
``tier_overlap_efficiency`` and ``tier_cost_model_drift`` gauges, and
flight-recorder events (``tier_batch_flushed``, ``tier_staleness_exceeded``,
``tier_wire_fallback``) that :mod:`repro_torch.launch.obs_report` renders
as the tree.

The collective form runs over a ``DeviceMesh``
(:mod:`repro_torch.launch.mesh`): :func:`mesh_tree` makes one collective
tier a data axis of a tier mesh, leaf (edge) innermost, and
:meth:`AggregationTree.psum` — which ``DistConfig(tree=...)`` routes the
engines' all-reduce through — crosses each collective tier in its wire
(each rank's partial roundtripped, dequantized once) and all-reduces over
the tier's axis, leaf first.  With fp32 wires it issues exactly the
two-stage program of :func:`repro_torch.federated.dist.two_stage_psum`.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core import fed3r
from repro_torch.core.random_features import rff_map
from repro_torch.federated import compress
from repro_torch.federated.compress import WireFormat
from repro_torch.federated.costs import stats_wire_bytes
from repro_torch.federated.dist import DistConfig, DistContext, psum_axis
from repro_torch.federated.engine import shard_stats
from repro_torch.federated.streaming_engine import StreamState
from repro_torch.federated.telemetry import Telemetry
from repro_torch.launch.mesh import ICI_BW, axis_size, data_axes
from repro_torch.tree import tree_map

# tier boundaries carry arbitrary statistics payloads, so only the
# per-matrix formats are valid tier wires (sketch is a client-uplink
# format for PSD second moments, not a generic boundary format)
TIER_WIRE_KINDS = ("fp32", "int8", "fp8")


@dataclass(frozen=True)
class TierSpec:
    """One tier of the aggregation tree.

    ``fan_in`` is the tier's batching window: how many child payloads fold
    into one parent payload.  ``wire`` is the format each child crosses
    this boundary in; ``bandwidth`` prices the crossing
    (``CostModel.tiered_allreduce``); ``staleness`` is the tier's
    pending-reduction budget in segments (only the TOP tier's budget drives
    the :class:`TieredAbsorber` pipeline depth); ``axis`` names the mesh
    axis when the tier is a collective stage (``None`` for host tiers).
    """

    name: str
    fan_in: int
    wire: WireFormat = field(default_factory=WireFormat)
    bandwidth: float = ICI_BW
    staleness: int = 0
    axis: Optional[str] = None

    def __post_init__(self):
        if self.fan_in < 1:
            raise ValueError(f"tier {self.name!r}: fan_in must be >= 1, got {self.fan_in}")
        if self.staleness < 0:
            raise ValueError(
                f"tier {self.name!r}: staleness must be >= 0, got {self.staleness}"
            )
        if self.bandwidth <= 0:
            raise ValueError(
                f"tier {self.name!r}: bandwidth must be > 0, got {self.bandwidth}"
            )
        if self.wire.kind not in TIER_WIRE_KINDS:
            raise ValueError(
                f"tier {self.name!r}: wire kind {self.wire.kind!r} is not a "
                f"tier-boundary format (expected one of {TIER_WIRE_KINDS})"
            )


def _wire_leaf(child: torch.Tensor) -> bool:
    """Children the tier wire applies to: ≥2-D float matrices (the d² Gram
    and d·C class-sum payloads).  Scalars and 1-D sidecars (sample counts)
    stay exact fp32 — the same convention as the engines' uplink."""
    return child.dim() >= 2 and child.is_floating_point()


def _roundtrip_nd(x: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """The per-matrix wire roundtrip over any leading stack axes (one
    roundtrip a matrix, in index order)."""
    if x.dim() == 2:
        return compress.matrix_roundtrip(x, fmt)
    return torch.stack([_roundtrip_nd(m, fmt) for m in x])


def _map(fn, payload):
    """Apply ``fn`` to each tensor of a (named) tuple payload."""
    leaves = [fn(x) for x in payload]
    return payload._make(leaves) if hasattr(payload, "_make") else type(payload)(leaves)


def _stack(payloads: Sequence[Any]):
    """Stack same-structured (named) tuple payloads along a new leading axis."""
    first = payloads[0]
    leaves = [torch.stack(list(xs)) for xs in zip(*payloads)]
    return first._make(leaves) if hasattr(first, "_make") else type(first)(leaves)


@dataclass(frozen=True)
class AggregationTree:
    """An N-tier reduction tree, LEAF TIER FIRST (edge → region → cloud).

    ``leaves`` child payloads enter the first tier; each tier folds
    ``fan_in`` children per group, so tier i receives ``prod(fan_in[i:])``
    payloads per reduction.  The fp32 tree is an exact reassociation of the
    flat sum — bitwise equal on grid-exact statistics for ANY fan-in
    assignment and tier permutation.
    """

    tiers: Tuple[TierSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise ValueError("an aggregation tree needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"tier names must be unique, got {names}")
        axes = [t.axis for t in self.tiers if t.axis is not None]
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh-tier axes must be unique, got {axes}")

    @property
    def leaves(self) -> int:
        n = 1
        for t in self.tiers:
            n *= t.fan_in
        return n

    @property
    def axes(self) -> Tuple[str, ...]:
        """Mesh axes of the collective tiers, leaf tier first."""
        return tuple(t.axis for t in self.tiers if t.axis is not None)

    @property
    def lossy_wire(self) -> Optional[WireFormat]:
        """The coarsest-boundary lossy wire (topmost non-fp32 tier), or
        ``None`` for an all-fp32 (bit-exact) tree."""
        for t in reversed(self.tiers):
            if t.wire.kind != "fp32":
                return t.wire
        return None

    def resolved(self) -> "AggregationTree":
        """Tier wires resolved for this torch build (fp8 → int8 fallback)."""
        return AggregationTree(
            tuple(
                TierSpec(
                    name=t.name,
                    fan_in=t.fan_in,
                    wire=t.wire.resolved(),
                    bandwidth=t.bandwidth,
                    staleness=t.staleness,
                    axis=t.axis,
                )
                for t in self.tiers
            )
        )

    def validate_mesh_axes(self, axis_names: Sequence[str]) -> None:
        """A mesh-routed tree must cover the reduce axes exactly, leaf tier
        on the INNERMOST axis — the order a two-stage all-reduce takes."""
        want = tuple(reversed(tuple(axis_names)))
        if self.axes != want:
            raise ValueError(
                f"tree mesh axes {self.axes} must equal the reversed reduce "
                f"axes {want} (leaf tier innermost)"
            )

    # ---- collective form -----------------------------------------------------

    def psum(self, payload: Any, mesh: Any) -> Any:
        """The N-tier all-reduce over ``mesh``: per collective tier, LEAF
        FIRST, each rank's partial crosses the tier's wire (≥2-D float
        matrices, one roundtrip a matrix, dequantized once at the boundary;
        fp32 leaves it untouched), then one all-reduce over the tier's axis.
        Host-level tiers (``axis=None``) are skipped — they fold via
        :meth:`fold_stacked`.  With fp32 wires this is exactly
        ``two_stage_psum`` generalized to N axes."""
        for tier in self.tiers:
            if tier.axis is None:
                continue
            if tier.wire.kind != "fp32":
                payload = tree_map(lambda x, t=tier: _roundtrip_nd(x, t.wire)
                                   if _wire_leaf(x) else x, payload)
            payload = psum_axis(payload, mesh, tier.axis)
        return payload

    # ---- host-tier form (stacked fixed-order folds) ------------------------

    def fold_stacked(self, payload: Any, tiers: Optional[Sequence[TierSpec]] = None) -> Any:
        """Fold stacked child payloads tier by tier, one FIXED-ORDER fold per
        tier (groups of ``fan_in`` along the leading axis, children
        accumulated left to right).  Lossy tiers cross every child matrix
        through the fused dequantize-accumulate, one launch pair per child
        and group; fp32 tiers are a strict left fold (an exact
        reassociation of the flat sum).  Returns the stacked parents of the
        last folded tier."""
        for tier in self.tiers if tiers is None else tuple(tiers):
            k = tier.fan_in

            def fold_leaf(x, tier=tier, k=k):
                if x.shape[0] % k:
                    raise ValueError(
                        f"tier {tier.name!r}: {x.shape[0]} stacked children "
                        f"do not group by fan_in={k}"
                    )
                g = x.reshape((x.shape[0] // k, k) + tuple(x.shape[1:]))
                if tier.wire.kind != "fp32" and _wire_leaf(g[0, 0]):
                    acc = [torch.zeros_like(g[j, 0], dtype=torch.float32)
                           for j in range(g.shape[0])]
                    for i in range(k):
                        acc = [compress.matrix_roundtrip_add(acc[j], g[j, i], tier.wire)
                               for j in range(g.shape[0])]
                    return torch.stack(acc)
                acc = g[:, 0]
                for i in range(1, k):
                    acc = acc + g[:, i]
                return acc

            payload = _map(fold_leaf, payload)
        return payload

    def reduce(self, payloads: Sequence[Any]) -> Any:
        """Reduce exactly ``leaves`` child payloads through the full tree
        (host-level convenience over :meth:`fold_stacked`)."""
        payloads = list(payloads)
        if len(payloads) != self.leaves:
            raise ValueError(
                f"tree with fan-ins {tuple(t.fan_in for t in self.tiers)} "
                f"reduces {self.leaves} leaf payloads, got {len(payloads)}"
            )
        folded = self.fold_stacked(_stack(payloads))
        return _map(lambda x: x[0], folded)

    # ---- pricing ------------------------------------------------------------

    def as_cost_tiers(self) -> Tuple[dict, ...]:
        """The plain-data tier description ``CostModel.tiered_allreduce``
        prices."""
        return tuple(
            {
                "name": t.name,
                "fan_in": t.fan_in,
                "wire": t.wire.kind,
                "bandwidth": t.bandwidth,
                "tile": t.wire.tile,
            }
            for t in self.tiers
        )


def two_stage_tree(axis_names: Sequence[str]) -> AggregationTree:
    """The fp32 tree equivalent of a two-stage all-reduce over
    ``axis_names`` (outermost first): one fan-in-1 collective tier per
    axis, innermost (leaf) first."""
    names = tuple(axis_names)
    if not names:
        raise ValueError("two_stage_tree needs at least one mesh axis")
    return AggregationTree(
        tuple(TierSpec(name=ax, fan_in=1, axis=ax) for ax in reversed(names))
    )


def mesh_tree(mesh: Any, wires: Optional[dict] = None,
              bandwidths: Optional[dict] = None) -> AggregationTree:
    """An N-tier tree over a tier mesh (:func:`repro_torch.launch.mesh.
    make_tier_host_mesh`): one collective tier a batch-carrying axis,
    innermost (leaf/edge) first, fan-in = the axis size.  ``wires`` /
    ``bandwidths`` map axis name → per-tier overrides."""
    wires = wires or {}
    bandwidths = bandwidths or {}
    tiers = []
    for ax in reversed(data_axes(mesh)):
        kwargs = {}
        if ax in wires:
            kwargs["wire"] = wires[ax]
        if ax in bandwidths:
            kwargs["bandwidth"] = bandwidths[ax]
        tiers.append(TierSpec(name=ax, fan_in=axis_size(mesh, ax), axis=ax, **kwargs))
    return AggregationTree(tuple(tiers))


class TieredAbsorber:
    """Overlapped N-tier absorb pipeline over a streaming engine.

    Each SEGMENT is one batch of ``tree.leaves`` edge payload blocks —
    ``(leaves, N, ...)`` features/labels/mask.  The pipeline splits the
    work at the top-tier boundary in two:

    * LOWER — feature extraction, per-leaf masked statistics (one
      ``fed3r_stats`` launch a leaf), and every tier fold below the top;
    * UPPER — the top-tier crossing, the Gram L Lᵀ + S (the engine's own
      ``chol_gram`` launch with no sample rows, as ``absorb_stats`` forms
      it), the guarded refactorization and the solve.

    With ``overlap=True`` the upper reduction of segment t is issued AFTER
    the lower part of segment t+1; the top tier's ``staleness`` budget
    bounds how many segments the served classifier may trail (exceeding
    the budget forces the oldest pending reduction and logs
    ``tier_staleness_exceeded``).  ``overlap=False`` runs both parts as one
    blocking step per segment, host-synced — bitwise equal to the
    overlapped result and, with fp32 tiers on grid-exact data, to
    ``engine.absorb_stats`` of the flat sum.
    """

    def __init__(
        self,
        engine: Any,  # StreamingEngine (duck-typed)
        tree: AggregationTree,
        *,
        overlap: bool = True,
        cost_model: Optional[Any] = None,
        telemetry: Optional[Telemetry] = None,
    ):
        if any(t.axis is not None for t in tree.tiers):
            raise ValueError(
                "TieredAbsorber folds host-level tiers; mesh tiers "
                "(axis=...) route through DistConfig(tree=...)"
            )
        if engine.cfg.dist.mesh is not None or engine.cfg.dist.aggregation != "merge":
            raise ValueError(
                "TieredAbsorber owns the reduction topology; give it a "
                "merge-backend engine without a dist-owned mesh"
            )
        if engine.wire.kind != "fp32":
            raise ValueError(
                "tier wires own the compression here; use an fp32 engine "
                "wire and put int8/fp8 on the tree's tiers"
            )
        self.engine = engine
        self.tree = tree.resolved()
        for before, after in zip(tree.tiers, self.tree.tiers):
            if before.wire.kind != after.wire.kind:
                tel = telemetry if telemetry is not None else engine.dist.telemetry
                tel.event(
                    "tier_wire_fallback",
                    tier=after.name,
                    requested=before.wire.kind,
                    using=after.wire.kind,
                )
        top = self.tree.tiers[-1]
        self.depth = top.staleness if overlap else 0
        if overlap and self.depth < 1:
            raise ValueError(
                "overlap needs a top-tier staleness budget >= 1 "
                "(the pending-reduction ring depth); got "
                f"staleness={top.staleness}"
            )
        self.dist = DistContext(
            DistConfig(),
            engine="tiers",
            telemetry=telemetry if telemetry is not None else engine.dist.telemetry,
        )
        self.telemetry = self.dist.telemetry
        self.cost_model = cost_model
        self._pending: deque = deque()
        self._state: Optional[StreamState] = None
        self._segments = 0
        self._absorb_syncs = 0
        self._bytes_by_tier = {t.name: 0.0 for t in self.tree.tiers}

    # ---- device work ----------------------------------------------------------

    def _leaf_payload(self, feats, labels, mask, params):
        """Per-leaf masked statistics: feature extraction over the whole
        segment (the packed-flat idiom of the engines), then one
        ``fed3r_stats`` launch per edge block, in leaf order."""
        eng = self.engine
        leaves = feats.shape[0]
        flat = feats.reshape((leaves * feats.shape[1],) + tuple(feats.shape[2:]))
        if eng.feature_fn is not None:
            flat = eng.feature_fn(params, flat)
        if eng.rff_params is not None:
            flat = rff_map(eng.rff_params, flat)
        phi = flat.reshape((leaves, feats.shape[1], flat.shape[-1]))
        stats = [shard_stats(phi[j], labels[j], eng.cfg.n_classes, mask[j])
                 for j in range(leaves)]
        return _stack([(s.A, s.b, s.n.to(torch.float32)) for s in stats])

    def _lower(self, feats, labels, mask, params):
        payload = self._leaf_payload(feats, labels, mask, params)
        return self.tree.fold_stacked(payload, tiers=self.tree.tiers[:-1])

    def _upper(self, state: StreamState, children) -> StreamState:
        top = self.tree.tiers[-1]
        S, dB, nw = _map(lambda x: x[0], self.tree.fold_stacked(children, tiers=(top,)))
        G = self.engine._gram(state) + S
        if top.wire.kind in ("int8", "fp8"):
            L = compress.psd_cholesky(G, compress.quant_spectral_bound(S, top.wire))
        else:
            L = fed3r.psd_cholesky(G)
        b = state.b + dB
        return StreamState(
            L=L, b=b, n=state.n + nw, W=self.engine._solve(L, b), wave=state.wave + 1,
            stale_waves=0, stale_samples=torch.zeros_like(state.stale_samples),
        )

    def _sync(self) -> None:
        """Wait for the card (the blocking form's and drain's host sync)."""
        if self._state.W.device.type == "cuda":
            torch.cuda.current_stream(self._state.W.device).synchronize()

    # ---- host pipeline ------------------------------------------------------

    def reset(self, d: int) -> None:
        """(Re)initialize the carried state for feature dimension ``d``."""
        self._pending.clear()
        self._state = self.engine.init(d)
        self._segments = 0
        self._absorb_syncs = 0
        self._bytes_by_tier = {t.name: 0.0 for t in self.tree.tiers}

    def _account_tiers(self, tiers, entering: int) -> int:
        """Meter one segment's crossings for the given tiers: ``entering``
        payloads arrive at the first of them; each tier folds ``fan_in``
        children per batch.  Pure host-side integer math."""
        d, C = self._state.L.shape[0], self.engine.cfg.n_classes
        level = {t.name: i for i, t in enumerate(self.tree.tiers)}
        for t in tiers:
            per_child = stats_wire_bytes(d, C, t.wire.kind, tile=t.wire.tile)
            nbytes = entering * per_child
            self._bytes_by_tier[t.name] += nbytes
            self.telemetry.counter(
                "tier_wire_bytes_total", tier=t.name, level=level[t.name],
                wire=t.wire.kind,
            ).inc(int(nbytes))
            self.telemetry.counter(
                "tier_batches_total", tier=t.name, level=level[t.name]
            ).inc(entering // t.fan_in)
            self.telemetry.event(
                "tier_batch_flushed",
                tier=t.name,
                children=entering,
                batches=entering // t.fan_in,
                wire=t.wire.kind,
            )
            entering //= t.fan_in
        return entering

    def _flush_one(self) -> None:
        children = self._pending.popleft()
        with self.telemetry.span("tier_upper", engine="tiers"):
            self.dist.dispatch()
            self._state = self._upper(self._state, children)
        self._account_tiers((self.tree.tiers[-1],), self.tree.tiers[-1].fan_in)

    @torch.no_grad()
    def absorb_segment(self, feats, labels, mask, params: Any = None) -> None:
        """Absorb one segment of ``tree.leaves`` edge blocks.

        Blocking mode (``overlap=False``): both parts at once, host-synced
        per segment.  Overlapped mode: the segment's LOWER part is issued
        immediately; its UPPER (top-tier) reduction is deferred onto the
        pending ring and issued once a newer segment is in flight (or at
        :meth:`drain`), never letting the ring exceed the top tier's
        staleness budget.  With the segment already on the engine's device
        the overlapped form never waits for the card.
        """
        dev = self.engine.device
        feats = torch.as_tensor(feats, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        if feats.shape[0] != self.tree.leaves:
            raise ValueError(
                f"segment carries {feats.shape[0]} edge blocks; the tree "
                f"folds {self.tree.leaves}"
            )
        if self._state is None:
            if self.engine.feature_fn is not None:
                raise ValueError(
                    "feature_fn hides the feature dim; call reset(d) first"
                )
            self.reset(int(feats.shape[-1]))
        if self.depth == 0:
            with self.telemetry.span("tier_absorb", engine="tiers"):
                self.dist.dispatch()
                self._state = self._upper(self._state, self._lower(feats, labels, mask, params))
            self._sync()
            self._absorb_syncs += 1
            self._segments += 1
            self._account_tiers(self.tree.tiers, self.tree.leaves)
            return
        with self.telemetry.span("tier_lower", engine="tiers"):
            self.dist.dispatch()
            children = self._lower(feats, labels, mask, params)
        self._segments += 1
        self._account_tiers(self.tree.tiers[:-1], self.tree.leaves)
        self._pending.append(children)
        while len(self._pending) > self.depth:
            self.telemetry.event(
                "tier_staleness_exceeded",
                tier=self.tree.tiers[-1].name,
                pending=len(self._pending),
                budget=self.depth,
            )
            self._flush_one()

    def classifier(self) -> torch.Tensor:
        """The currently served W — trails the newest segment by at most
        the top tier's staleness budget."""
        if self._state is None:
            raise ValueError("no segments absorbed yet")
        return self._state.W

    @torch.no_grad()
    def drain(self) -> StreamState:
        """Retire every pending reduction, sync, and publish the gauges.

        ``tier_overlap_efficiency`` = 1 − host_syncs/segments over the
        absorb phase: 0.0 for the blocking path (one sync per segment),
        → 1.0 when every upper reduction overlapped a newer segment.
        With a ``cost_model``, ``tier_cost_model_drift`` compares metered
        tier bytes against ``CostModel.tiered_allreduce``'s prediction.
        """
        while self._pending:
            self._flush_one()
        self._sync()
        if self._segments:
            eff = 1.0 - self._absorb_syncs / self._segments
            self.telemetry.gauge("tier_overlap_efficiency").set(eff)
        if self.cost_model is not None and self._segments:
            priced = self.cost_model.tiered_allreduce(self.tree.as_cost_tiers())
            model = priced["uplink_bytes_total"] * self._segments
            measured = sum(self._bytes_by_tier.values())
            if model > 0:
                self.telemetry.gauge("tier_cost_model_drift").set(measured / model)
        return self._state
