"""Host meshes over a ``torch.distributed`` world, and the tier bandwidths.

The port's counterpart of the reference's ``launch/mesh.py``.  The
reference lays its engines over ``jax.devices()``; the port runs one
process per rank (:mod:`repro_torch.launch.world` starts them), and a mesh
is a :class:`torch.distributed.device_mesh.DeviceMesh` over the initialized
world, built by ``init_device_mesh``.  The layouts are the reference's:

* :func:`make_host_mesh` — ``("data", "model")``, or with ``pods > 1``
  ``("pod", "data", "model")``, the multi-pod layout whose two data axes
  the dist layer reduces innermost first;
* :func:`make_tier_host_mesh` — one axis per aggregation tier, outermost
  (cloud) first, the leaf (edge) tier innermost, plus ``"model"``;
* :func:`make_production_mesh` — the reference's production axis sizes;
* :func:`make_dryrun_mesh` — one rank's view of the production mesh, over
  a fake world (no collective moves data) of 256 or 512 ranks in this one
  process: what :mod:`repro_torch.launch.dryrun` runs a rank's program on,
  and nothing else (every other mesh refuses a fake world);
* :func:`data_axes` (every axis but ``"model"``), :func:`data_parallel_size`
  (the way count the packers pad to) and :func:`n_chips`.

The ``"model"`` axis carries tensor and expert parallelism: the engines
shard only over the data axes, and a dense or MoE model served under the
mesh (:func:`repro_torch.sharding.hints.use_mesh`) splits its layers over
``"model"``.  A mesh's ``device_type`` is the card's by default (``"cpu"``
for gloo worlds on the CPU, as the tests run them); the backend is
whatever the world was initialized with, and nothing here picks one.

``PEAK_FLOPS_BF16``, ``HBM_BW``, ``NVLINK_BW`` and ``NETWORK_BW`` are the
card's figures the dry run's roofline divides by: NVIDIA H100 SXM
data-sheet numbers at its 700 W limit (dense bf16 tensor-core rate, HBM3
rate, NVLink 4 each way per card, one 400 Gb/s InfiniBand port per card),
not measurements.  A collective group within one node of
``hints.RANKS_PER_NODE`` cards rides NVLink; one that spans nodes, as
every group of the row-major 16 × 16 layout does, the network.

``ICI_BW``, ``DCN_BW`` and ``WAN_BW`` are the reference's pricing inputs
for the tiers of an aggregation tree (:class:`repro_torch.federated.tiers.TierSpec`,
:meth:`repro_torch.federated.costs.CostModel.tiered_allreduce`): edge folds
over the fast intra-host interconnect, region crossings over the data-centre
network, cloud crossings over the WAN.  They are assumed deployment links,
not measurements of any device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# NVIDIA H100 SXM data sheet at 700 W (not measurements)
PEAK_FLOPS_BF16 = 989e12  # dense bf16 FLOP/s a card
HBM_BW = 3.35e12  # bytes/s a card
NVLINK_BW = 450e9  # bytes/s each way a card, inside an 8-card node
NETWORK_BW = 50e9  # bytes/s a card over its 400 Gb/s InfiniBand port, across nodes

ICI_BW = 50e9  # bytes/s per link (~per-chip effective for ring collectives)
DCN_BW = 12.5e9  # bytes/s per pod boundary (~100 Gbps cross-pod effective)
WAN_BW = 1.25e9  # bytes/s cross-region (~10 Gbps effective over WAN)

# Per-tier bandwidth lookup for aggregation trees: edge folds ride ICI,
# region crossings ride DCN, cloud crossings ride the WAN.
TIER_BANDWIDTHS = {"ici": ICI_BW, "dcn": DCN_BW, "wan": WAN_BW}

# Default axis names for N-tier host meshes, outermost (slowest) first.
# The leaf tier keeps the name "edge"; a 1-tier mesh degenerates to it.
_TIER_AXIS_NAMES = ("cloud", "region", "edge")

FAKE_BACKEND = "fake"


def link_bw(cross_node: bool) -> float:
    """Bytes/s a card of a collective group: the network where the group
    spans nodes, NVLink inside one."""
    return NETWORK_BW if cross_node else NVLINK_BW


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed world is initialized: start the ranks with "
            "repro_torch.launch.world (run_world, or init_world under torchrun)"
        )
    if dist.get_backend() == FAKE_BACKEND:
        raise RuntimeError("a fake world moves no data: only repro_torch.launch.dryrun runs "
                           "on it (make_dryrun_mesh)")
    return dist.get_world_size()


def make_dryrun_mesh(multi_pod: bool = False, rank: int = 0, device_type: str = "cuda",
                     sizes: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """Rank ``rank`` of the production mesh (or of one of axis ``sizes``,
    outermost first) in this process: a world of the fake backend (every
    collective returns at once and moves nothing, so a buffer it would
    fill keeps what it held) over all its ranks, and the ``DeviceMesh``
    with the reference's axes.  Only the dry run runs on it; tear it down
    with ``torch.distributed.destroy_process_group()``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sizes = dict(sizes or make_production_mesh(multi_pod=multi_pod))
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already initialized in this process")
    world = math.prod(sizes.values())
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    dist.init_process_group(FAKE_BACKEND, rank=rank, world_size=world, store=FakeStore())
    return init_device_mesh(device_type, tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as axis sizes only: ``{"data": 16,
    "model": 16}``, with ``"pod": 2`` in front for the multi-pod layout.

    The reference lays it over a 16 × 16 TPU pod (two over DCN); no card
    host has that topology, so the port keeps the sizes, which the sharding
    rules (:func:`repro_torch.sharding.specs.param_specs`) take as their
    default, and builds no mesh from them.
    """
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(
    model_parallel: int = 1, *, pods: int = 1, device_type: str = "cuda"
) -> DeviceMesh:
    """A mesh over every rank of the world, in the reference's layouts.

    ``pods=1`` builds ("data", "model"); ``pods > 1`` adds the leading
    "pod" axis: ("pod", "data", "model").  Ranks are laid out row-major, so
    a data group's model ranks are consecutive.  Raises ``ValueError`` when
    the world size does not factor as pods × data × model_parallel.
    """
    n = _world_size()
    if model_parallel < 1 or pods < 1:
        raise ValueError(
            f"model_parallel and pods must be >= 1, got {model_parallel}, {pods}"
        )
    if n % (model_parallel * pods) != 0:
        raise ValueError(
            f"{n} ranks do not factor as pods={pods} × data × "
            f"model_parallel={model_parallel}"
        )
    data = n // (model_parallel * pods)
    if pods > 1:
        return init_device_mesh(
            device_type, (pods, data, model_parallel), mesh_dim_names=("pod", "data", "model")
        )
    return init_device_mesh(device_type, (data, model_parallel), mesh_dim_names=("data", "model"))


def make_tier_host_mesh(
    tier_shape: Tuple[int, ...],
    tier_names: Tuple[str, ...] = (),
    model_parallel: int = 1,
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """N-tier mesh over the world's ranks: one axis per tier + "model".

    ``tier_shape`` lists tier sizes OUTERMOST FIRST (cloud → edge), so the
    trailing tier axis is the leaf/edge tier.  Default names for ≤3 tiers
    are drawn from ("cloud", "region", "edge") right-aligned; deeper trees
    must name their axes.  Raises ``ValueError`` when the world size does
    not factor as prod(tier_shape) × model_parallel or names and shape
    disagree.
    """
    if not tier_shape or any(s < 1 for s in tier_shape):
        raise ValueError(f"tier_shape must be non-empty positive ints, got {tier_shape}")
    if not tier_names:
        if len(tier_shape) > len(_TIER_AXIS_NAMES):
            raise ValueError(
                f"{len(tier_shape)} tiers need explicit tier_names "
                f"(defaults cover {len(_TIER_AXIS_NAMES)})"
            )
        tier_names = _TIER_AXIS_NAMES[len(_TIER_AXIS_NAMES) - len(tier_shape):]
    if len(tier_names) != len(tier_shape):
        raise ValueError(f"tier_names {tier_names} do not match tier_shape {tier_shape}")
    if "model" in tier_names:
        raise ValueError('"model" is reserved for the model-parallel axis')
    n = _world_size()
    want = model_parallel
    for s in tier_shape:
        want *= s
    if n != want:
        raise ValueError(
            f"{n} ranks do not factor as tiers {tier_shape} × "
            f"model_parallel={model_parallel}"
        )
    return init_device_mesh(
        device_type,
        tuple(tier_shape) + (model_parallel,),
        mesh_dim_names=tuple(tier_names) + ("model",),
    )


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes carrying the batch dimension (everything but "model")."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of one named axis."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def data_parallel_size(mesh: DeviceMesh) -> int:
    """Product of the batch-carrying axis sizes — the shard count the
    packers pad the engines' leading axes to a multiple of."""
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def n_chips(mesh: DeviceMesh) -> int:
    return int(mesh.mesh.numel())
