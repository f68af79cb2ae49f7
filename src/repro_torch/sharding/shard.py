"""Cut a model's parameters into a rank's blocks.

A rank of a mesh with a ``"model"`` axis holds only its block of every
parameter, the block :func:`repro_torch.sharding.specs.param_specs` gives
it: tensor and expert parallelism, and with ``fsdp=True`` the FSDP layout
too (big dims split over the data axes as well, which every block
gathers where it starts, :func:`repro_torch.sharding.hints.gather_data`;
:func:`fsdp_dims` says which dim of each leaf):

* :func:`shard_params` cuts a whole tree, e.g. the reference's weights
  carried over by :func:`repro_torch.models.convert.params_from_jax`;
* :func:`shard_params_from` asks a factory for each block, leaf by leaf,
  so that a rank never holds the whole tree, on the host or on the card;
  :func:`seeded_factory` is such a factory: random weights from a seed,
  each element a function of its leaf and its global index, so every
  mesh — one card unsharded included — sees the same weights;
* :func:`gather_params` is the inverse of :func:`shard_params`: the
  ranks' blocks gathered over ``"model"`` into whole leaves (a checkpoint
  in the reference's layout; a tree of the parameters' structure, such as
  a server optimizer's buffers, gathers alike);
* :func:`replicated_leaves` flags the leaves every model rank holds whole,
  whose gradients :func:`repro_torch.sharding.hints.sum_replicated` sums
  (:func:`leaf_specs` gives every leaf's spec).

Every family's blocks are cut as the rules give them; a layout that the
sharded layers do not implement raises where a layer meets it
(:mod:`repro_torch.sharding.hints`).
"""
from __future__ import annotations

import functools
import math
import re
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.sharding import hints
from repro_torch.sharding.specs import PartitionSpec, map_with_path, param_specs

Factory = Callable[[str, Tuple[int, ...], Tuple[slice, ...], torch.device], torch.Tensor]


def shard_params(cfg: Any, params: Any, mesh: Any, fsdp: bool = False) -> Any:
    """The rank's block of every leaf of ``params`` (a copy for a split
    leaf, the leaf itself for a replicated one); with ``fsdp`` in the FSDP
    layout over the mesh's data axes."""
    sizes, where = hints.axis_sizes(mesh), hints.coords(mesh)
    specs = _specs(cfg, params, sizes, fsdp)
    flat = {}
    map_with_path(specs, lambda path, spec: flat.__setitem__(path, spec))

    def cut(path, leaf):
        spec = flat[path]
        return leaf if spec.is_replicated() else spec.block(leaf, where, sizes).clone()

    return map_with_path(params, cut)


def _specs(cfg: Any, params: Any, sizes: dict, fsdp: bool) -> Any:
    """``param_specs`` of ``params`` under the mesh axis ``sizes``, in the
    FSDP layout over the reference's FSDP axes where ``fsdp``."""
    if not fsdp:
        return param_specs(cfg, params, sizes or {"model": 1})
    return param_specs(cfg, params, sizes, fsdp=True, fsdp_axis=hints.fsdp_axis_of(sizes))


def leaf_specs(cfg: Any, sizes: dict, fsdp: bool = False) -> Tuple[Any, dict]:
    """(``cfg``'s whole parameters on the meta device, {key path (a tuple):
    the leaf's spec under the mesh axis ``sizes``, FSDP-split with
    ``fsdp``})."""
    from repro_torch.launch.shapes import abstract_params  # shapes imports the models

    meta = abstract_params(cfg)
    flat = {}
    map_with_path(_specs(cfg, meta, sizes, fsdp), lambda path, spec: flat.__setitem__(path, spec))
    return meta, flat


def _data_dim(spec: PartitionSpec) -> Optional[int]:
    """The dim an FSDP spec splits over the data axes, or None."""
    for i, e in enumerate(spec):
        if e is not None and "data" in (e if isinstance(e, tuple) else (e,)):
            return i
    return None


@functools.lru_cache(maxsize=64)
def _fsdp_dims(cfg: Any, sizes: Tuple[Tuple[str, int], ...]) -> dict:
    _, flat = leaf_specs(cfg, dict(sizes), fsdp=True)
    return {path: d for path, spec in flat.items() if (d := _data_dim(spec)) is not None}


@functools.lru_cache(maxsize=1024)
def _fsdp_dims_at(cfg: Any, sizes: Tuple[Tuple[str, int], ...], prefix: Tuple[str, ...]) -> dict:
    n = len(prefix)
    return {path[n:]: d for path, d in _fsdp_dims(cfg, sizes).items() if path[:n] == prefix}


def fsdp_dims(cfg: Any, prefix: Tuple[str, ...]) -> dict:
    """{key path under ``prefix``: the dim FSDP splits over the data axes}
    of the leaves of ``cfg``'s parameters at ``prefix`` (e.g. ``("layers",
    "0")``, a block; ``("enc_norm",)``) under the ambient mesh; the other
    leaves are whole over the data axes."""
    return _fsdp_dims_at(cfg, tuple(sorted(hints.axis_sizes().items())), tuple(prefix))


def gather_fsdp(cfg: Any, tree: Any, prefix: Tuple[str, ...]) -> Any:
    """``tree`` (the rank's blocks of the leaves at ``prefix``, its own key
    path: a block's ``(stack, index)``) with each FSDP leaf gathered over
    the ambient FSDP axes (:func:`hints.gather_data`): the blocks as the
    rank holds them without FSDP (``tree`` itself without FSDP)."""
    if not hints.fsdp_axes():
        return tree
    dims = fsdp_dims(cfg, prefix)
    return map_with_path(tree, lambda path, leaf: hints.gather_data(leaf, dims[path])
                         if path in dims else leaf)


def fsdp_leaves(cfg: Any, sizes: dict) -> Any:
    """A tree of bools of ``cfg``'s parameters: True where FSDP splits a
    leaf over the data axes of a mesh of axis ``sizes``."""
    meta, flat = leaf_specs(cfg, sizes, fsdp=True)
    return map_with_path(meta, lambda path, _: _data_dim(flat[path]) is not None)


def replicated_leaves(cfg: Any, model: int) -> Any:
    """A tree of bools of ``cfg``'s parameters: True where a leaf is whole
    on every rank of a "model" axis of ``model``."""
    meta, flat = leaf_specs(cfg, {"model": model})
    return map_with_path(meta, lambda path, _: flat[path].is_replicated())


def gather_params(cfg: Any, blocks: Any, mesh: Any, fsdp: bool = False) -> Any:
    """Every leaf whole from the ranks' ``blocks`` (one tree of ``cfg``'s
    parameter structure a rank, as :func:`shard_params` cut it, with
    ``fsdp`` in the FSDP layout): a collective over the groups of the axes
    each leaf is split over, which every rank joins, and every one gets the
    whole tree (:func:`repro_torch.sharding.hints.gather_block`: exact,
    recorded as one all-gather a leaf)."""
    sizes, where = hints.axis_sizes(mesh), hints.coords(mesh)
    if sizes.get("model", 1) == 1 and not fsdp:
        return blocks
    meta, flat = leaf_specs(cfg, sizes, fsdp)
    shapes = {}
    map_with_path(meta, lambda path, leaf: shapes.__setitem__(path, tuple(leaf.shape)))

    def gather(path, block):
        spec = flat[path]
        axes = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))
                if sizes[a] > 1]
        if not axes:
            return block
        return hints.gather_block(block, spec.index(shapes[path], where, sizes), shapes[path],
                                  [mesh.get_group(a) for a in axes])

    return map_with_path(blocks, gather)


def shard_params_from(cfg: Any, factory: Factory, mesh: Any,
                      device: Union[str, torch.device], fsdp: bool = False) -> Any:
    """The rank's blocks of ``cfg``'s parameters, made one block at a time
    by ``factory(path, shape, index, device)``: the leaf at key path
    ``path`` ("/"-joined) has global ``shape`` and the rank's block is
    ``index`` (a tuple of slices), in the FSDP layout with ``fsdp``.  With
    ``mesh=None`` every block is the whole leaf."""
    dev = torch.device(device)
    sizes, where = hints.axis_sizes(mesh), hints.coords(mesh)
    meta, flat = leaf_specs(cfg, sizes, fsdp and mesh is not None)

    def make(path, leaf):
        spec: PartitionSpec = flat[path]
        index = (tuple(slice(None) for _ in leaf.shape) if mesh is None or spec.is_replicated()
                 else spec.index(leaf.shape, where, sizes))
        return factory("/".join(path), tuple(leaf.shape), index, dev)

    return map_with_path(meta, make)


def _init_scale(path: str, shape: Sequence[int]) -> Tuple[str, float]:
    """("ones" | "zeros" | "uniform", std) of a leaf, as the port's init
    draws it: norms' scales 1 and biases 0, embeddings and the head 0.02,
    every matrix 1/√fan-in over its init's input axis (an expert stack's
    axis 1, any other matrix's axis 0)."""
    last = path.rsplit("/", 1)[-1]
    if re.search(r"norm\d?/scale$|final_norm/scale$|enc_norm/scale$", path):
        return "ones", 0.0
    if last.startswith("b") or last == "bias":
        return "zeros", 0.0
    if last in ("embedding", "kernel") and re.search(r"(embed|dec_pos|lm_head)/", path):
        return "uniform", 0.02
    in_axis = 1 if re.search(r"moe/w_(gate|up|down)$", path) else 0
    return "uniform", 1.0 / math.sqrt(shape[in_axis])


_MASK32 = 0xFFFFFFFF


def _mix(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (int64 holding values < 2^32; each product stays
    below 2^63)."""
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _MASK32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _MASK32
    return h ^ (h >> 16)


def seeded_factory(seed: int, chunk: int = 1 << 24) -> Factory:
    """A :data:`Factory` of random weights from ``seed``: element i of the
    leaf at ``path`` is uniform with the init's standard deviation
    (``_init_scale``), from a hash of (seed, path, i) computed on the
    device, so a block is made without its leaf and equals the leaf's
    slice bit for bit.  At most ``chunk`` elements are hashed at a time."""

    def factory(path: str, shape: Tuple[int, ...], index: Tuple[slice, ...],
                device: torch.device) -> torch.Tensor:
        kind, std = _init_scale(path, shape)
        bounds = [s.indices(n) for s, n in zip(index, shape)]
        block = tuple(b - a for a, b, _ in bounds)
        if kind != "uniform":
            return (torch.ones if kind == "ones" else torch.zeros)(
                block, dtype=torch.float32, device=device)
        key = seed
        for ch in path.encode():
            key = (key * 131 + ch) % 2147483647
        n = math.prod(block)
        out = torch.empty(n, dtype=torch.float32, device=device)
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        for j0 in range(0, n, chunk):
            # the global flat index of the block's elements j0 .. j1 - 1
            rem = torch.arange(j0, min(n, j0 + chunk), device=device)
            flat = torch.zeros_like(rem)
            for (a, _, _), size, st in reversed(list(zip(bounds, block, strides))):
                flat += (a + rem % size) * st
                rem = rem // size
            h = _mix(((flat & _MASK32) ^ key) & _MASK32)
            h = _mix(h ^ (flat >> 32) ^ ((key * 7919) & _MASK32))
            u = (h.to(torch.float64) + 0.5) * (1.0 / 4294967296.0)
            out[j0:j0 + u.numel()] = ((2.0 * u - 1.0) * (math.sqrt(3.0) * std)).to(torch.float32)
        return out.view(block)

    return factory


def full_params(cfg: Any, factory: Factory, device: Union[str, torch.device]) -> Any:
    """Every leaf of ``cfg``'s parameters whole from ``factory`` (the
    unsharded counterpart of :func:`shard_params_from`)."""
    return shard_params_from(cfg, factory, None, device)


def local_rows(x: Any, mesh: Any, axis: int = 0) -> Any:
    """The rank's block of a batch-carrying ``x`` over the mesh's data axes
    (row-major over them), ``ValueError`` where it does not split."""
    sizes, where = hints.axis_sizes(mesh), hints.coords(mesh)
    axes = tuple(a for a in sizes if a != "model")
    if not axes:
        return x
    spec = PartitionSpec(*((None,) * axis + (axes,)))
    return spec.block(x, where, sizes)
