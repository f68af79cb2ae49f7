"""Execution layer shared by the port's engines: device, aggregation, meshes.

The port's counterpart of the reference's ``federated/dist.py``.  The
reference runs each engine as one SPMD program a device under
``shard_map``; the port runs one process a rank (started by
:mod:`repro_torch.launch.world`), and each process runs the same engine on
its own block of the packed arrays:

* :func:`resolve_device` — the ONE device rule of the port.  Every entry
  point takes ``device=`` and defaults to ``"cuda"``; asking for the card on
  a machine without one raises, and nothing falls back to the CPU.  The CPU
  runs only when the caller asks for it (the tests do).  Which statistics
  backend runs is then decided by the tensor's device alone
  (:func:`repro_torch.kernels.ops.fed3r_stats`): the CUDA kernel for a CUDA
  tensor, its plain PyTorch version for a CPU tensor.
* :class:`DistConfig` — ``aggregation="merge"`` (single process: the
  engine's left fold IS the global sum) or ``"psum"`` over a
  :class:`torch.distributed.device_mesh.DeviceMesh` (``mesh=``, from
  :mod:`repro_torch.launch.mesh`), optionally routed through an N-tier
  :class:`repro_torch.federated.tiers.AggregationTree` (``tree=``), with
  the reference's validation.
* :class:`DistContext` — the per-engine handle: the host dispatch counter
  (homed in the telemetry registry as ``engine_dispatches_total``), the
  rank's block of a batch-carrying axis (:meth:`DistContext.local_block`,
  the counterpart of the reference's ``data_spec``), the all-reduce
  (:meth:`DistContext.all_reduce`: the identity under ``"merge"``, the
  two-stage psum under ``"psum"``) and the gather of per-rank blocks
  (:meth:`DistContext.gather_blocks`).
* :func:`two_stage_psum` — one all-reduce a mesh axis, INNERMOST FIRST, as
  the reference's: on a ``("pod", "data")`` mesh the d² statistics reduce
  inside a pod before the cross-pod stage.  A stage flattens the whole
  tree into one contiguous buffer a dtype and issues one collective, never
  one a leaf (the FT round's delta tree holds hundreds of leaves).
* :func:`linear_shard_index` — the rank's row-major coordinate over the
  data axes, the order in which the blocks of a batch-carrying axis are
  laid out.
* :func:`shard_cohort` — the deterministic partition of a cohort over
  shards (pure Python).

Unlike the reference, the port's ``"psum"`` always needs a mesh: its
collectives run on the mesh's process groups, and there is no ambient
``shard_map`` to take them from.  So the reduce axes are always the mesh's
data axes, and the reference's ``mesh_axes`` (explicit axes for an
external ``shard_map``) and ``donate`` have no counterpart: the port's
engines update their carried buffers in place where the reference donates
them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.federated.telemetry import Telemetry, get_telemetry
from repro_torch.launch.mesh import axis_size, data_axes, data_parallel_size
from repro_torch.sharding import hints
from repro_torch.sharding.specs import data_parallel_spec
from repro_torch.tree import tree_leaves, tree_map


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The port's device rule: the card unless the caller asks for the CPU.

    Raises ``RuntimeError`` for a CUDA device on a machine without a card
    rather than falling back to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for a CUDA card, but torch sees none "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def validate_backend(aggregation: str, axis_names: Tuple[str, ...]) -> None:
    """The merge|psum validation every engine shares."""
    if aggregation not in ("merge", "psum"):
        raise ValueError(f"unknown aggregation backend: {aggregation!r}")
    if aggregation == "psum" and not axis_names:
        raise ValueError("psum aggregation needs at least one mesh axis")


def linear_shard_index(mesh: Any, axis_names: Sequence[str]) -> int:
    """This rank's position over the given mesh axes, row-major in axis
    order: the index of its block of a batch-carrying axis."""
    idx = 0
    for ax in axis_names:
        idx = idx * axis_size(mesh, ax) + mesh.get_local_rank(ax)
    return idx


def _flat_collective(tree: Any, collective: Callable[[torch.Tensor], Any]) -> Any:
    """Run ``collective`` in place on one contiguous copy of the leaves of
    ``tree`` a dtype, and return the tree as views of those buffers.  The
    inputs are never written."""
    leaves = list(tree_leaves(tree))
    flats: Dict[torch.dtype, torch.Tensor] = {}
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        flat = torch.cat([t.reshape(-1) for t in leaves if t.dtype == dtype])
        collective(flat)
        flats[dtype] = flat
    offsets = dict.fromkeys(flats, 0)

    def unflat(t: torch.Tensor) -> torch.Tensor:
        start = offsets[t.dtype]
        offsets[t.dtype] = start + t.numel()
        return flats[t.dtype][start:start + t.numel()].view(t.shape)

    return tree_map(unflat, tree)


def broadcast_tree(tree: Any, src: int = 0) -> Any:
    """Every leaf of ``tree`` as global rank ``src`` holds it, on every rank
    of the world: one broadcast a dtype."""
    def bcast(flat):  # each rank receives the buffer once: priced as a permute
        hints.collective("collective-permute", flat.numel() * flat.element_size(), (None,),
                         lambda: dist.broadcast(flat, src=src))

    return _flat_collective(tree, bcast)


def psum_axis(tree: Any, mesh: Any, axis: str) -> Any:
    """One all-reduce stage: sum over the mesh axis ``axis``, one collective
    a dtype of the tree's leaves, each a contiguous buffer of them."""
    group = mesh.get_group(axis)
    return _flat_collective(tree, lambda flat: hints.all_reduce(flat, (group,)))


def two_stage_psum(tree: Any, mesh: Any, axis_names: Sequence[str]) -> Any:
    """Hierarchical all-reduce: one stage an axis, innermost (last) first.

    On ``axis_names=("pod", "data")`` this reduces inside each pod first and
    crosses pods with the already-reduced statistics.  For a single axis it
    is exactly one all-reduce (one a dtype of the tree's leaves).
    """
    for ax in reversed(tuple(axis_names)):
        tree = psum_axis(tree, mesh, ax)
    return tree


@dataclass(frozen=True)
class DistConfig:
    """Aggregation backend of an engine, with the reference's validation.

    ``aggregation``:
      * ``"merge"`` — single process: the engine's strict left fold
        already produced the global statistics; ``mesh`` must be ``None``.
      * ``"psum"`` — distributed: each rank folds its block of the packed
        arrays and the local partials are all-reduced over the data axes of
        ``mesh`` (a ``DeviceMesh`` from :mod:`repro_torch.launch.mesh`).
        Every rank must make the same engine calls on the same packed
        arrays; every rank ends with the same results.

    The reduce axes are the mesh's data axes (every non-``"model"`` axis:
    ``("pod", "data")`` on the multi-pod mesh).  ``tree`` routes the
    all-reduce through an N-tier
    :class:`repro_torch.federated.tiers.AggregationTree` — one collective
    tier a reduce axis, LEAF TIER INNERMOST — so an all-fp32 tree issues
    exactly the two-stage program.  Requires ``"psum"``.
    """

    aggregation: str = "merge"  # "merge" | "psum"
    mesh: Optional[Any] = None  # DeviceMesh the psum reduces over
    tree: Optional[Any] = None  # N-tier AggregationTree (repro_torch.federated.tiers)

    def __post_init__(self):
        if self.aggregation not in ("merge", "psum"):
            raise ValueError(f"unknown aggregation backend: {self.aggregation!r}")
        if self.aggregation == "merge" and self.mesh is not None:
            raise ValueError(
                "mesh-mode execution all-reduces rank partials: use "
                "aggregation='psum' (merge is the single-process backend)"
            )
        if self.aggregation == "psum" and not self.axis_names:
            raise ValueError(
                "psum aggregation needs at least one mesh axis: the data axes "
                "of a DeviceMesh (one process a rank), DistConfig(mesh=...) "
                "from repro_torch.launch.mesh.make_host_mesh"
            )
        if self.tree is not None:
            if self.aggregation != "psum":
                raise ValueError(
                    "an aggregation tree routes the psum backend; merge "
                    "has no collective to tier"
                )
            # duck-typed (tiers.py imports this module); the tree's
            # collective tiers must cover the reduce axes leaf-innermost
            self.tree.validate_mesh_axes(self.axis_names)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The reduce axes: the mesh's data axes (none without a mesh)."""
        return data_axes(self.mesh) if self.mesh is not None else ()

    @property
    def data_shards(self) -> int:
        """Data-parallel way count of the mesh (1 without a mesh)."""
        return 1 if self.mesh is None else data_parallel_size(self.mesh)

    @property
    def lossy_tier_wire(self) -> Optional[Any]:
        """The routed tree's coarsest lossy tier wire (``None`` when the
        reduction is bit-exact): engines size the guarded Cholesky's jitter
        by it when a tree crossing quantizes."""
        return None if self.tree is None else self.tree.lossy_wire


class DistContext:
    """Per-engine handle: dispatch counter, spans, aggregation backend.

    The dispatch counter is the labeled telemetry series
    ``engine_dispatches_total{engine=<name>, inst=<n>}``, one cell per
    context, so N same-type engines stay independently resettable.
    """

    def __init__(
        self,
        cfg: DistConfig,
        *,
        engine: str = "engine",
        telemetry: Optional[Telemetry] = None,
    ):
        self.cfg = cfg
        self.telemetry = get_telemetry() if telemetry is None else telemetry
        inst = self.telemetry.next_instance(f"dist:{engine}")
        self._dispatches = self.telemetry.counter(
            "engine_dispatches_total", engine=engine, inst=inst
        )

    @property
    def dispatches(self) -> int:
        """Host-API entry count (a telemetry counter cell)."""
        return int(self._dispatches.value)

    def dispatch(self) -> None:
        """Record one host-API entry (a plain integer add)."""
        self._dispatches.inc()

    @property
    def shard_index(self) -> int:
        """This rank's block index over the data axes (0 without a mesh)."""
        if self.cfg.mesh is None:
            return 0
        return linear_shard_index(self.cfg.mesh, self.cfg.axis_names)

    def local_block(self, x: Any, axis: int = 0) -> Any:
        """This rank's contiguous block of dim ``axis`` of ``x`` (a view;
        ``x`` itself without a mesh) — the reference's ``data_spec``.  The
        axis must divide the data-parallel way count: pack with ``mesh=``."""
        if self.cfg.mesh is None:
            return x
        spec = data_parallel_spec(self.cfg.axis_names, axis)
        return spec.block(x, self.shard_index, self.cfg.data_shards)

    def all_reduce(self, tree: Any, wire_fn: Optional[Callable[[Any], Any]] = None) -> Any:
        """The server aggregation behind one interface: identity under
        ``"merge"`` (the local fold IS the global sum); the two-stage psum
        over the mesh's data axes under ``"psum"``.

        ``wire_fn`` is the compressed-uplink hook
        (:mod:`repro_torch.federated.compress`): each rank's LOCAL partial
        crosses the wire in the configured format before the sum; ``None``
        (and ``"merge"``, whose uplink compression happens per client inside
        the engine fold) keeps the reduce bit-exact fp32.  With ``cfg.tree``
        the reduction runs the N-tier tree instead — ``wire_fn`` stays the
        LEAF-side hook, then each collective tier compresses and reduces,
        leaf first; an all-fp32 tree issues the two-stage program."""
        if self.cfg.aggregation == "merge":
            return tree
        if wire_fn is not None:
            tree = wire_fn(tree)
        if self.cfg.tree is not None:
            return self.cfg.tree.psum(tree, self.cfg.mesh)
        return two_stage_psum(tree, self.cfg.mesh, self.cfg.axis_names)

    def gather_blocks(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The inverse of :meth:`local_block` on dim 0: every rank's block of
        each tensor, concatenated in block order, on every rank (identity
        without a mesh).  Exact: each block travels by ``broadcast`` from
        its owner, one a rank and axis, all tensors packed into one buffer
        of rows (gloo moves CUDA tensors by ``all_reduce`` and ``broadcast``
        only, and a sum of zero-filled buffers would turn -0.0 into +0.0)."""
        if self.cfg.mesh is None:
            return list(tensors)
        k = tensors[0].shape[0]
        widths = [t[0].numel() for t in tensors]
        rows = torch.cat([t.reshape(k, -1) for t in tensors], dim=1)
        for ax in reversed(self.cfg.axis_names):  # innermost first, as the layout nests
            rows = hints.gather_rows(rows, self.cfg.mesh.get_group(ax))
        parts = torch.split(rows, widths, dim=1)
        return [p.reshape((rows.shape[0],) + tuple(t.shape[1:])) for p, t in zip(parts, tensors)]


class DistDispatchMixin:
    """The engines' public ``.dispatches`` counter, proxied onto the owned
    :class:`DistContext` (``self.dist``)."""

    dist: DistContext

    @property
    def dispatches(self) -> int:
        return self.dist.dispatches


def shard_cohort(cohort: Sequence[int], shard: int, n_shards: int) -> Tuple[int, ...]:
    """Deterministic partition of a (possibly partial) cohort across shards.

    Round-robin by sorted cohort position, so the partition is independent
    of arrival order, covers every client exactly once, and stays balanced
    even when the cohort is PARTIAL (fewer clients than slots: late joiners,
    demoted stragglers dropped by the health tracker).  The psum mode of the
    merge-on-arrival engine, where each rank scatters only the clients it
    owns, builds on it.
    """
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range for {n_shards} shards")
    ordered = sorted(int(c) for c in cohort)
    return tuple(c for i, c in enumerate(ordered) if i % n_shards == shard)
