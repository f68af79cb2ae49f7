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
  all-reduce) and each rank's q heads read their own kv heads (in runs of
  uniform group size where the rank's q heads and the kv group do not
  divide one another); the KV cache holds the rank's kv heads, or its
  block of the slots (the sequence layout: decode attends all heads over
  the rank's slots and combines the ranks' softmax pieces,
  :func:`max_model` then one sum), or all of it where the rules replicate
  it; Whisper's cross-attention runs alike, its (k, v) the rank's kv heads
  or its block of the encoder's frames (combined as the ring's slots);
* the MLP and the MoE's shared expert column-parallel up, row-parallel
  down (one all-reduce); the routed experts expert-parallel on the E axis
  (a rank dispatches to and runs its experts only), or, where E does not
  divide, split on their hidden axis;
* the RG-LRU width-sharded (its gates' (W, W) products read the conv's
  output gathered over ``"model"``) and the Mamba2 mixer head-sharded (its
  in_proj and conv blocks gathered, the SSD on the rank's heads, the gated
  norm's sum of squares all-reduced), or, where its heads do not divide,
  the SSD on every head on every rank;
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
:func:`max_model` (the context-parallel combine's shift) passes no
gradient: the combine does not depend on it.  The layers run every layout
the rules pick.

FSDP (``use_mesh(mesh, fsdp=True)``; fully sharded data parallelism: the
parameters split over the data axes too, as ``param_specs(..., fsdp=True)``
lays them out) runs in every family's stacks: a block gathers its FSDP
leaves over the data axes when it starts (:func:`gather_data`) and drops
them when it ends, and under a gradient its recompute gathers them again
(ZeRO-3).  The gather's backward is a reduce-scatter: the data ranks'
cotangents summed, the rank's block kept, so an FSDP leaf's gradient is
already the sum over the data ranks, which :func:`mean_data` only divides.
Over a data axis of 1 the gather is the block itself: TP-only, bit for bit.

Every collective the port issues goes through :func:`collective`, which
records it in each active :func:`census` as the logical collective:
(kind, buffer bytes, group size, whether the group spans nodes).  An
all-gather or reduce-scatter that gloo has to emulate by a zero-filled
all-reduce (gloo gathers no CUDA tensor) is recorded as what it stands
for; launch/hlo_analysis.py prices the records.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.tree import tree_map

# the ambient mesh with its axis sizes, this rank's coordinates (read once:
# a DeviceMesh recomputes its layout on every read of .mesh) and the data
# axes its parameters are FSDP-split over (() without FSDP)
_AMBIENT: List[Tuple[Any, Dict[str, int], Dict[str, int], Tuple[str, ...]]] = []


def _read(mesh: Any) -> Tuple[Dict[str, int], Dict[str, int]]:
    names = tuple(mesh.mesh_dim_names)
    sizes = {a: int(s) for a, s in zip(names, mesh.mesh.shape)}
    return sizes, {a: int(mesh.get_local_rank(a)) for a in names}


def fsdp_axis_of(sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The axes FSDP splits parameters over on a mesh of axis ``sizes``:
    ``("pod", "data")`` on the multi-pod layout, else ``("data",)`` (the
    reference's ``fsdp_axis``)."""
    return tuple(a for a in ("pod", "data") if a in sizes)


def set_mesh(mesh: Any, fsdp: bool = False) -> None:
    """Make ``mesh`` (a ``DeviceMesh``, or None to clear) the ambient mesh;
    with ``fsdp`` its parameters are FSDP-split over its data axes."""
    if mesh is None:
        _AMBIENT[:] = []
        return
    sizes, where = _read(mesh)
    _AMBIENT[:] = [(mesh, sizes, where, fsdp_axis_of(sizes) if fsdp else ())]


def get_mesh() -> Optional[Any]:
    """The ambient mesh, or None."""
    return _AMBIENT[-1][0] if _AMBIENT else None


@contextlib.contextmanager
def use_mesh(mesh: Any, fsdp: bool = False) -> Iterator[Any]:
    """``mesh`` as the ambient mesh inside the block (its parameters
    FSDP-split with ``fsdp``), the previous one after."""
    prev = list(_AMBIENT)
    set_mesh(mesh, fsdp)
    try:
        yield mesh
    finally:
        _AMBIENT[:] = prev


def fsdp_axes() -> Tuple[str, ...]:
    """The data axes the ambient mesh FSDP-splits parameters over; () where
    it does not (or without a mesh)."""
    return _AMBIENT[-1][3] if _AMBIENT else ()


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


def _group(axis: str):
    return get_mesh().get_group(axis)


# ---------------------------------------------------------------------------
# the census: every collective the port issues, recorded as what it stands for
# ---------------------------------------------------------------------------

RANKS_PER_NODE = 8  # cards a node: a group within one node rides NVLink


class Collective(NamedTuple):
    """One collective as a rank issued it: ``kind`` (``"all-reduce"``,
    ``"all-gather"``, ``"reduce-scatter"``, ``"all-to-all"`` or
    ``"collective-permute"``), the bytes of its buffer (an all-reduce's
    operand, an all-gather's gathered result, a reduce-scatter's result
    block), the ranks of its group and whether the group spans nodes."""

    kind: str
    nbytes: int
    group: int
    cross_node: bool


_CENSUSES: List[List[Collective]] = []


@contextlib.contextmanager
def census() -> Iterator[List[Collective]]:
    """The collectives issued inside the block, in order (a list filled as
    they are issued; censuses nest)."""
    recs: List[Collective] = []
    _CENSUSES.append(recs)
    try:
        yield recs
    finally:  # by identity: two censuses may hold equal records
        _CENSUSES[:] = [r for r in _CENSUSES if r is not recs]


def _span(group: Any) -> Tuple[int, bool]:
    """(ranks, whether they span nodes) of a process group (None: the world)."""
    ranks = (range(dist.get_world_size()) if group is None
             else dist.get_process_group_ranks(group))
    return len(ranks), len({r // RANKS_PER_NODE for r in ranks}) > 1


def collective(kind: str, nbytes: int, groups: Sequence[Any], issue: Callable[[], Any]) -> Any:
    """Run ``issue()`` (the c10d calls) and record it in every active census
    as one ``kind`` collective of ``nbytes`` over the product of ``groups``
    (several groups: the axes of one logical group, e.g. ("pod", "data"))."""
    if _CENSUSES:
        n, cross = 1, False
        for g in groups:
            size, spans = _span(g)
            n, cross = n * size, cross or spans
        rec = Collective(kind, int(nbytes), n, cross)
        for recs in _CENSUSES:
            recs.append(rec)
    return issue()


def all_reduce(t: torch.Tensor, groups: Sequence[Any], op: Any = None) -> None:
    """``t`` all-reduced in place over each of ``groups`` in turn (the sum
    unless ``op``), recorded as one all-reduce over their product."""
    def issue():
        for g in groups:
            dist.all_reduce(t, group=g) if op is None else dist.all_reduce(t, op=op, group=g)
    collective("all-reduce", t.numel() * t.element_size(), groups, issue)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Sum(torch.autograd.Function):
    """The sum of ``x`` over ``groups`` (all-reduced one group after the
    other), in fp32 where ``fp32`` else in x's dtype, returned in x's dtype;
    its backward is the same sum of the cotangent.  Under ``vmap`` the
    physical batched tensor is all-reduced (exact: the sum is elementwise,
    and every rank maps the same batch)."""

    @staticmethod
    def forward(x, groups, fp32):
        t = x.to(torch.float32 if fp32 else x.dtype, copy=True).contiguous()
        all_reduce(t, groups)
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


class _Mean(torch.autograd.Function):
    """``x`` itself forward; backward the cotangent summed over ``groups``
    in fp32 and divided by ``m``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, groups, m):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.groups, ctx.m = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.groups, True) / ctx.m, None, None


def mean_cotangent(x: torch.Tensor) -> torch.Tensor:
    """``x``, computed whole on every "model" rank, whose cotangent each
    rank holds a piece of (the pieces sum to the whole): its backward gives
    every rank the pieces' mean, so what lies before it differentiates the
    whole cotangent, over m, on every rank, and not each rank's piece (x
    itself without a model axis or a gradient)."""
    if model_size() == 1 or not torch.is_grad_enabled():
        return x
    return _Mean.apply(x, (_group("model"),), model_size())


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the "model" ranks (x itself without a model axis),
    in fp32, returned in x's dtype; x is not written.  Its backward is the
    same sum of the cotangent."""
    if model_size() == 1:
        return x
    return _Sum.apply(x, (_group("model"),), True)


class _Max(torch.autograd.Function):
    """The elementwise max of ``x`` over the "model" ranks, in fp32; no
    gradient flows through it (a shift the caller's result does not depend
    on).  Under ``vmap`` the physical batched tensor is all-reduced
    (elementwise: exact)."""

    @staticmethod
    def forward(x):
        t = x.to(torch.float32, copy=True).contiguous()
        all_reduce(t, (_group("model"),), op=dist.ReduceOp.MAX)
        return t

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None

    @staticmethod
    def vmap(info, in_dims, x):
        return _Max.forward(x), in_dims[0]


def max_model(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max of ``x`` over the "model" ranks, in fp32 (x itself,
    as fp32, without a model axis); x is not written.  It passes no
    gradient: a caller differentiates only through what does not depend on
    the max (the context-parallel combine's shift)."""
    if model_size() == 1:
        return x.to(torch.float32, copy=True)
    return _Max.apply(x.detach())


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


def _axes_block(axes: Sequence[str]) -> Tuple[int, int]:
    """(ranks, this rank's block index) of the ambient mesh's ``axes``,
    row-major over them (the first axis outermost)."""
    sizes, where = _AMBIENT[-1][1], _AMBIENT[-1][2]
    n, i = 1, 0
    for a in axes:
        n, i = n * sizes[a], i * sizes[a] + where[a]
    return n, i


def gather_block(block: torch.Tensor, index: Tuple[slice, ...], shape: Sequence[int],
                 groups: Sequence[Any]) -> torch.Tensor:
    """The whole tensor of ``shape`` of which every rank of ``groups`` holds
    the block at ``index`` (a tuple of slices): the rank's ``block`` placed
    in zeros, all-reduced over each group in its dtype (exact: every entry
    is one rank's, the others add zeros; gloo gathers no CUDA tensor),
    recorded as one all-gather of the whole."""
    whole = block.new_zeros(tuple(shape))
    whole[index] = block

    def issue():
        for g in groups:
            dist.all_reduce(whole, group=g)
    collective("all-gather", _nbytes(whole), groups, issue)
    return whole


def gather_rows(rows: torch.Tensor, group: Any) -> torch.Tensor:
    """The group's ranks' ``rows`` concatenated along dim 0, in group-rank
    order: one broadcast from each rank, recorded as one all-gather (gloo
    moves CUDA tensors by ``all_reduce`` and ``broadcast`` only; unlike
    :func:`gather_block`'s sum, this keeps a -0.0 bit for bit)."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    span = rows.shape[0]
    out = rows.new_empty((size * span,) + tuple(rows.shape[1:]))

    def issue():
        for j in range(size):
            buf = out[j * span:(j + 1) * span]
            if j == me:
                buf.copy_(rows)
            dist.broadcast(buf, src=dist.get_global_rank(group, j), group=group)
    collective("all-gather", _nbytes(out), (group,), issue)
    return out


def _gather(x: torch.Tensor, dim: int, axes: Tuple[str, ...]) -> torch.Tensor:
    """The ranks' blocks ``x`` of ``axes`` concatenated along ``dim``
    (:func:`gather_block` over each axis's group)."""
    n, i = _axes_block(axes)
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * k
    index = (slice(None),) * dim + (slice(i * k, (i + 1) * k),)
    return gather_block(x, index, shape, tuple(_group(a) for a in reversed(axes)))


def _reduce_scatter(g: torch.Tensor, dim: int, axes: Tuple[str, ...]) -> torch.Tensor:
    """The sum of ``g`` over the ranks of ``axes``, in fp32, cut to the
    rank's block of ``dim`` and cast back: an all-reduce then a narrow,
    recorded as one reduce-scatter of the block.  The block is a copy of
    its own, so that the whole sum is freed (a narrowed view would hold it
    for as long as the gradient lives)."""
    n, i = _axes_block(axes)
    t = g.to(torch.float32, copy=True).contiguous()
    groups = tuple(_group(a) for a in reversed(axes))
    k = t.shape[dim] // n

    def issue():
        for grp in groups:
            dist.all_reduce(t, group=grp)
    collective("reduce-scatter", _nbytes(t) // n, groups, issue)
    return t.narrow(dim, i * k, k).to(g.dtype, copy=True)


class _Gather(torch.autograd.Function):
    """The all-gather of ``x``'s blocks over ``axes`` along ``dim`` (a
    non-negative dim of x); its backward the reduce-scatter of the
    cotangent (:class:`_ReduceScatter`).  Under ``vmap`` the physical
    batched tensor is gathered along the shifted dim."""

    @staticmethod
    def forward(x, dim, axes):
        return _gather(x, dim, axes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.axes = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.dim, ctx.axes), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, axes):
        if in_dims[0] is None:
            return _gather(x, dim, axes), None
        return _gather(x.movedim(in_dims[0], 0), dim + 1, axes), 0


class _ReduceScatter(torch.autograd.Function):
    """The reduce-scatter of ``g`` over ``axes`` along ``dim``; its backward
    the all-gather of the cotangent."""

    @staticmethod
    def forward(g, dim, axes):
        return _reduce_scatter(g, dim, axes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.axes = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.axes), None, None

    @staticmethod
    def vmap(info, in_dims, g, dim, axes):
        if in_dims[0] is None:
            return _reduce_scatter(g, dim, axes), None
        return _reduce_scatter(g.movedim(in_dims[0], 0), dim + 1, axes), 0


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks ``x`` concatenated along ``dim`` (exact);
    its backward the reduce-scatter of the cotangent over "model" (x itself
    without a model axis)."""
    if model_size() == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), ("model",))


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """An FSDP leaf's data-axis blocks ``x`` concatenated along ``dim`` over
    the ambient FSDP axes (exact): the leaf as the rank holds it without
    FSDP.  Its backward reduce-scatters the cotangent: the data ranks'
    summed, in fp32, the rank's block kept."""
    axes = fsdp_axes()
    if not axes or _axes_block(axes)[0] == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), axes)


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


def data_block() -> Tuple[int, int]:
    """(the data ranks of the ambient mesh, this rank's index among them,
    row-major over the data axes)."""
    return _axes_block(data_axes()) if _AMBIENT else (1, 0)


def gather_counts(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``x`` stacked on a new leading dim, row-major over
    the data axes (a (1, …) tensor without one); no backward."""
    axes = tuple(a for a in data_axes() if mesh_axis_size(a) > 1)
    return _gather(x[None], 0, axes) if axes else x[None]


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


def mean_data(tree: Any, summed: Any = None) -> Any:
    """The mean of every leaf of ``tree`` over the ambient mesh's data
    ranks: one fp32 all-reduce, each leaf cast back once (``tree`` itself
    without a data axis).  ``summed`` (a tree of bools of ``tree``'s
    structure) flags the leaves that are already sums over the data ranks
    (an FSDP leaf's gradient, reduce-scattered by :func:`gather_data`'s
    backward): those are only divided."""
    groups, n = _data_groups(None)
    if not groups:
        return tree
    flags = tree_map(lambda _: False, tree) if summed is None else summed
    picked: List[torch.Tensor] = []
    tree_map(lambda x, s: None if s else picked.append(x), tree, flags)
    out = iter(_flat_sum(picked, groups, 1.0 / n) if picked else ())
    return tree_map(lambda x, s: (x.to(torch.float32) * (1.0 / n)).to(x.dtype) if s else next(out),
                    tree, flags)
