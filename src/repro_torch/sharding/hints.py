"""The ambient mesh that the model's layers read, and their collectives.

The port's counterpart of the reference's ``sharding/hints.py`` and
``sharding/compat.py``.  The reference's layers run on whole arrays inside
one SPMD program, and ``hint(x, *tokens)`` constrains how GSPMD lays out an
intermediate; GSPMD then inserts the collectives.  The port runs one
process a rank and a rank holds only its block of every parameter
(:mod:`repro_torch.sharding.shard`), so ``hint`` needs no counterpart: a
layer computes on its blocks and calls the collective where GSPMD would
insert it (:func:`reduce_model`, :func:`gather_model`).  ``compat.py`` is a
shim over JAX versions for the ambient-mesh API; its counterpart is the
slot here (:func:`set_mesh`, :func:`get_mesh`, :func:`use_mesh`), not a
copy.

With no mesh set — the unit tests, one card, the engines' data-parallel
paths, which pass their mesh explicitly — :func:`mesh_axis_size` and
:func:`data_shards` return 1, as the reference's do, and every layer runs
exactly its unsharded code.  Under a mesh whose ``"model"`` axis is larger
than 1, every family's layers run tensor-, expert- or context-parallel in
the layouts :func:`repro_torch.sharding.specs.param_specs` and
:func:`~repro_torch.sharding.specs.cache_specs` pick:

* attention: q/k/v column-parallel over the (kv-)head axis and ``wo``
  row-parallel (one all-reduce); where a projection falls back to d_model
  it is row-parallel (the rank's slice of x times its rows, then an
  all-reduce) and each rank picks the kv heads its q heads need; the KV
  cache holds the rank's kv heads, or its block of the slots (the
  sequence layout: decode attends all heads over the rank's slots and
  combines the ranks' softmax pieces, :func:`max_model` then one sum), or
  all of it where the rules replicate it; Whisper's cross-attention runs
  head-parallel alike;
* the MLP and the MoE's shared expert column-parallel up, row-parallel
  down (one all-reduce); the routed experts expert-parallel on the E axis
  (a rank dispatches to and runs its experts only), or, where E does not
  divide, split on their hidden axis;
* the RG-LRU width-sharded (its gates' (W, W) products read the conv's
  output gathered over ``"model"``) and the Mamba2 mixer head-sharded (its
  in_proj and conv blocks gathered, the SSD on the rank's heads, the gated
  norm's sum of squares all-reduced);
* the embedding vocab-sharded (a rank looks up its rows, zeroes the rest,
  all-reduces) or d_model-sharded (the rank's columns, gathered), the LM
  head vocab-sharded (rank-local logits, gathered where logits are
  returned, the padded-vocab mask on the global column) or d_model-sharded
  (the rank's partial logits, all-reduced).

A replicated leaf is computed whole on every rank and never all-reduced.
Every reduction runs in fp32 over the ``"model"`` group and is cast back
once; a rank's partial sum of a replicated product is that product on
model rank 0 and zeros elsewhere (:func:`as_partial`).

The backward follows GSPMD's convention: a rank's cotangent of a
replicated activation is a *partial*, the model ranks' cotangents summing
to the true one.  Three pieces make every family's forward differentiate
so, with no call site of its own in the layers:

1. the backward of :func:`reduce_model` is the same all-reduce (sum, in
   fp32, cast back once), and that of :func:`reduce_data` the same sum over
   the data axes; :func:`gather_model` and :func:`as_partial` then
   differentiate through plain autograd (the backward of
   :func:`pad_block` is a narrow, that of :func:`as_partial` rank 0's
   cotangent, zeros elsewhere, the graph kept on every rank);
2. a replicated loss is seeded once (:func:`seed_loss`: its value, a
   backward of 1/m on each of the m model ranks);
3. the gradient of every replicated leaf is summed over ``"model"``
   (:func:`sum_replicated`) right after the loss gradient, before any
   per-leaf term (a proximal term, weight decay) is added.

A sharded block's gradient is then whole on its rank: every path from it to
the loss passes through a :func:`reduce_model`.  Each collective is an
``autograd.Function`` with a ``vmap`` rule that all-reduces the physical
batched tensor (exact: an all-reduce is elementwise), so the round engine's
``torch.func.vmap`` of ``torch.func.grad`` over the cohort and the block
recompute's ``torch.func.vjp`` reach c10d with plain tensors.  Every rank
runs the same graph, so the collectives of a backward line up.
:func:`max_model` (decode's context-parallel combine) has no backward.
What these layers do not implement raises ``NotImplementedError``
(:func:`refuse`): any layout the rules pick that a layer lacks.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map

ROADMAP_ITEM = "ROADMAP Queue 1 item 13b(ii)"

# the ambient mesh with its axis sizes and this rank's coordinates, read
# once (a DeviceMesh recomputes its layout on every read of .mesh)
_AMBIENT: List[Tuple[Any, Dict[str, int], Dict[str, int]]] = []


def _read(mesh: Any) -> Tuple[Dict[str, int], Dict[str, int]]:
    names = tuple(mesh.mesh_dim_names)
    sizes = {a: int(s) for a, s in zip(names, mesh.mesh.shape)}
    return sizes, {a: int(mesh.get_local_rank(a)) for a in names}


def set_mesh(mesh: Any) -> None:
    """Make ``mesh`` (a ``DeviceMesh``, or None to clear) the ambient mesh."""
    _AMBIENT[:] = [] if mesh is None else [(mesh, *_read(mesh))]


def get_mesh() -> Optional[Any]:
    """The ambient mesh, or None."""
    return _AMBIENT[-1][0] if _AMBIENT else None


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """``mesh`` as the ambient mesh inside the block, the previous one after."""
    prev = list(_AMBIENT)
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT[:] = prev


def axis_sizes(mesh: Any = None) -> Dict[str, int]:
    """{axis name: size} of ``mesh`` (default: the ambient one; {} without)."""
    if mesh is None:
        return dict(_AMBIENT[-1][1]) if _AMBIENT else {}
    return _read(mesh)[0]


def coords(mesh: Any = None) -> Dict[str, int]:
    """{axis name: this rank's index along it} of ``mesh`` (default: ambient)."""
    if mesh is None:
        return dict(_AMBIENT[-1][2]) if _AMBIENT else {}
    return _read(mesh)[1]


def mesh_axis_size(name: str) -> int:
    """Size of an ambient-mesh axis (1 when no mesh is set)."""
    return _AMBIENT[-1][1].get(name, 1) if _AMBIENT else 1


def data_shards() -> int:
    """Product of the non-"model" (batch-carrying) axis sizes; 1 if none."""
    n = 1
    for a, s in axis_sizes().items():
        if a != "model":
            n *= s
    return n


def model_size() -> int:
    return mesh_axis_size("model")


def model_rank() -> int:
    """This rank's index along "model" (0 without a mesh)."""
    return _AMBIENT[-1][2].get("model", 0) if _AMBIENT else 0


def data_axes() -> tuple:
    return tuple(a for a in axis_sizes() if a != "model")


def layout(path: str, shape) -> Any:
    """The full-rank spec the rules give the parameter at ``path`` (e.g.
    ``"attn/wq"``) of global ``shape`` under the ambient "model" axis."""
    from repro_torch.sharding.specs import rule_spec

    return rule_spec(path, shape, {"model": model_size()}).full(len(shape))


def refuse(what: str) -> None:
    """Raise for a layout or path this slice does not implement."""
    raise NotImplementedError(f"{what} under a 'model' axis of {model_size()}: not "
                              f"implemented, {ROADMAP_ITEM}")


def _group(axis: str):
    return get_mesh().get_group(axis)


class _Sum(torch.autograd.Function):
    """The sum of ``x`` over ``groups`` (all-reduced one group after the
    other), in fp32 where ``fp32`` else in x's dtype, returned in x's dtype;
    its backward is the same sum of the cotangent.  Under ``vmap`` the
    physical batched tensor is all-reduced (exact: the sum is elementwise,
    and every rank maps the same batch)."""

    @staticmethod
    def forward(x, groups, fp32):
        t = x.to(torch.float32 if fp32 else x.dtype, copy=True).contiguous()
        for g in groups:
            dist.all_reduce(t, group=g)
        return t.to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.groups, ctx.fp32 = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.groups, ctx.fp32), None, None

    @staticmethod
    def vmap(info, in_dims, x, groups, fp32):
        return _Sum.forward(x, groups, fp32), in_dims[0]


class _RankZero(torch.autograd.Function):
    """``y`` where ``keep``, zeros elsewhere, with the cotangent likewise:
    the graph stays whole on every rank, so each rank's backward issues
    the same collectives."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y, keep):
        return y.clone() if keep else torch.zeros_like(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.keep = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


class _Scale(torch.autograd.Function):
    """``x`` itself forward, the cotangent times ``scale`` backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the "model" ranks (x itself without a model axis),
    in fp32, returned in x's dtype; x is not written.  Its backward is the
    same sum of the cotangent."""
    if model_size() == 1:
        return x
    return _Sum.apply(x, (_group("model"),), True)


def max_model(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max of ``x`` over the "model" ranks, in fp32 (x itself,
    as fp32, without a model axis); x is not written.  It has no backward:
    a call under a gradient raises."""
    if torch.is_grad_enabled() and x.requires_grad and model_size() > 1:
        raise NotImplementedError("max_model has no backward: decode's combine runs under "
                                  "torch.no_grad")
    t = x.to(torch.float32, copy=True).contiguous()
    if model_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group("model"))
    return t


def pad_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Model rank r's block ``x`` placed at block r of ``dim``, zeros
    elsewhere: the partial form of the ranks' blocks concatenated (its
    backward is the narrow to the block)."""
    m = model_size()
    if m == 1:
        return x
    dim = dim % x.dim()
    n, r = x.shape[dim], model_rank()
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [r * n, (m - 1 - r) * n])


def model_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Model rank r's block r of ``dim`` of a whole ``x`` (a view; x itself
    without a model axis)."""
    m = model_size()
    if m == 1:
        return x
    n = x.shape[dim] // m
    return x.narrow(dim, model_rank() * n, n)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks ``x`` concatenated along ``dim`` (exact: each
    entry is one rank's, the others add zeros)."""
    return reduce_model(pad_block(x, dim))


def as_partial(y: torch.Tensor) -> torch.Tensor:
    """A replicated value in the partial form (its sum over the model ranks
    is ``y``): ``y`` on model rank 0, zeros elsewhere; under a gradient the
    cotangent goes to rank 0's ``y`` and zeros to the others'."""
    if model_size() > 1 and torch.is_grad_enabled():
        return _RankZero.apply(y, model_rank() == 0)
    return y if model_rank() == 0 else torch.zeros_like(y)


def finish(y: torch.Tensor, partial: bool, reduce: bool) -> torch.Tensor:
    """A layer's output: ``y`` is a rank's partial sum (``partial``) or the
    whole replicated value; ``reduce`` asks for the whole value, else the
    partial form, for a caller that sums several partials in one
    all-reduce."""
    if reduce:
        return reduce_model(y) if partial else y
    return y if partial else as_partial(y)


def _data_groups(mesh: Any) -> Tuple[tuple, int]:
    """(the groups of ``mesh``'s data axes (default: ambient) larger than 1,
    the innermost first; the data ranks they span)."""
    sizes = axis_sizes(mesh)
    mesh = get_mesh() if mesh is None else mesh
    axes = [a for a, n in sizes.items() if a != "model" and n > 1]
    return tuple(mesh.get_group(a) for a in reversed(axes)), math.prod(sizes[a] for a in axes)


def reduce_data(x: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """Sum of ``x`` over every data axis of ``mesh`` (default: ambient), in
    x's dtype; x itself without one.  Its backward is the same sum of the
    cotangent."""
    groups, _ = _data_groups(mesh)
    return _Sum.apply(x, groups, False) if groups else x


def seed_loss(loss: torch.Tensor) -> torch.Tensor:
    """A loss replicated over the model ranks, seeded once: its value, with
    a backward of 1/m of the cotangent on each of the m ranks (``loss``
    itself without a model axis).  Unseeded, every gradient would come out
    m times too large."""
    m = model_size()
    return loss if m == 1 else _Scale.apply(loss, 1.0 / m)


def _flat_sum(leaves: Sequence[torch.Tensor], groups: tuple,
              scale: float = 1.0) -> List[torch.Tensor]:
    """``leaves`` summed over ``groups`` as one fp32 buffer (times
    ``scale``), each cast back to its dtype once."""
    flat = _Sum.apply(torch.cat([t.to(torch.float32).reshape(-1) for t in leaves]), groups, False)
    if scale != 1.0:
        flat = flat * scale
    out, i = [], 0
    for t in leaves:
        out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
        i += t.numel()
    return out


def sum_replicated(grads: Any, replicated: Any) -> Any:
    """``grads`` with the gradient of each leaf that ``replicated`` (a tree
    of bools of the same structure) flags summed over the "model" ranks:
    one fp32 all-reduce of them all (``grads`` itself without a model
    axis).  A replicated leaf's gradient is a partial on each rank; a
    sharded leaf's is whole."""
    if model_size() == 1:
        return grads
    picked: List[torch.Tensor] = []
    tree_map(lambda g, r: picked.append(g) if r else None, grads, replicated)
    if not picked:
        return grads
    summed = iter(_flat_sum(picked, (_group("model"),)))
    return tree_map(lambda g, r: next(summed) if r else g, grads, replicated)


def mean_data(tree: Any) -> Any:
    """The mean of every leaf of ``tree`` over the ambient mesh's data
    ranks: one fp32 all-reduce, each leaf cast back once (``tree`` itself
    without a data axis)."""
    groups, n = _data_groups(None)
    if not groups:
        return tree
    summed = iter(_flat_sum(list(tree_leaves(tree)), groups, 1.0 / n))
    return tree_map(lambda _: next(summed), tree)
