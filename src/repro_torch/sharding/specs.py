"""Partition specs: which block of an array a rank holds.

The port's counterpart of the reference's ``sharding/specs.py``.  The
reference hands whole arrays to a ``jit`` or ``shard_map`` program with a
``PartitionSpec`` per argument, and GSPMD cuts them; the port runs one
process a rank, so a spec here is the rule that picks the rank's block
(:meth:`PartitionSpec.block`), and a replicated spec picks the whole array.

Two kinds of spec live here:

* the distributed engines' :class:`BlockSpec`: every engine's packed arrays
  use :func:`data_parallel_spec`, the batch-carrying axis — shards for the
  statistics engine, cohort for rounds, personalization and the async slot
  ring, wave width for the stream — split over the data axes in row-major
  order of the axes, so on ``("pod", "data")`` a pod's ranks hold
  neighbouring blocks and the intra-pod stage of the psum reduces them
  first;
* the model's :class:`PartitionSpec` trees, the reference's tensor- and
  expert-parallel rules (Megatron-style): attention's q/k/v shard the
  (kv-)head axis on ``"model"`` and ``wo`` its head axis; the MLP shards its
  hidden axis (column-parallel up, row-parallel down); embeddings and the
  LM head shard the vocab axis; MoE experts shard the expert axis; Mamba2
  and RG-LRU their inner width or head axes; batch dims shard over the data
  axes.  Each rule lists preference-ordered candidates and the first whose
  sharded dims all divide the mesh axis wins, else the leaf is replicated:
  projections head axis → d_model (row-parallel), embeddings vocab →
  d_model, KV caches kv-head axis → sequence → replicated.
  :func:`param_specs`, :func:`batch_specs` and :func:`cache_specs` give the
  reference's spec of every leaf, leaf by leaf; where the reference stacks
  a model's layers on a leading ``n_layers`` axis the port keeps a list of
  layers, and each layer's leaf gets the reference's spec with the stack
  dim dropped (decided on the stacked shape, since FSDP never shards a
  stack dim).

:mod:`repro_torch.sharding.shard` cuts a parameter tree by these specs;
which layouts the port's layers run is stated in
:mod:`repro_torch.sharding.hints`.  :func:`stats_specs` row-splits the
statistics over ``"model"``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")

_DEFAULT_AXES = {"model": 16, "data": 16, "pod": 2}
_STACKS = ("layers", "enc_layers", "dec_layers")  # the reference's stacked layer trees


# ---------------------------------------------------------------------------
# the model's specs
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry a dim, leading dims first: ``None`` (not split), an axis
    name, or a tuple of axis names (split over their product, row-major).
    A spec shorter than the array leaves its trailing dims whole; ``P()``
    replicates.  A one-name tuple is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"

    def full(self, ndim: int) -> "PartitionSpec":
        """The same spec with one entry for each of ``ndim`` dims."""
        return PartitionSpec(*(tuple(self) + (None,) * (ndim - len(self))))

    def is_replicated(self) -> bool:
        return all(e is None for e in self)

    def index(self, shape: Sequence[int], coords: Mapping[str, int],
              sizes: Mapping[str, int]) -> Tuple[slice, ...]:
        """The slices of the block that the rank at mesh coordinates
        ``coords`` (axis → index) holds of an array of ``shape``;
        ``ValueError`` where a split dim does not divide."""
        out = []
        for dim, entry in zip(shape, self.full(len(shape))):
            if entry is None:
                out.append(slice(None))
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, i = 1, 0
            for a in axes:
                n, i = n * sizes[a], i * sizes[a] + coords[a]
            if dim % n:
                raise ValueError(f"a dim of size {dim} does not split over {n} ranks "
                                 f"of {axes} (spec {self!r})")
            k = dim // n
            out.append(slice(i * k, (i + 1) * k))
        return tuple(out)

    def block(self, x: T, coords: Mapping[str, int], sizes: Mapping[str, int]) -> T:
        """The rank's block of ``x`` (a view; ``x`` itself when replicated)."""
        if self.is_replicated():
            return x
        return x[self.index(x.shape, coords, sizes)]


P = PartitionSpec

# (path regex, preference-ordered trailing-dim spec candidates): the
# reference's _PARAM_RULES, matched on the port's key paths ("/"-joined)
_PARAM_RULES: Sequence[Tuple[str, Sequence[Tuple]]] = (
    # embeddings / unembedding
    (r"embed/embedding$", [("model", None), (None, "model")]),  # (V, d)
    (r"dec_pos/embedding$", [(None, None)]),  # learned positions: replicated
    (r"lm_head/kernel$", [(None, "model"), ("model", None)]),  # (d, V)
    # attention projections
    (r"(attn|self_attn|cross_attn)/wq$", [(None, "model", None), ("model", None, None)]),
    (r"(attn|self_attn|cross_attn)/wk$", [(None, "model", None), ("model", None, None)]),
    (r"(attn|self_attn|cross_attn)/wv$", [(None, "model", None), ("model", None, None)]),
    (r"(attn|self_attn|cross_attn)/wo$", [("model", None, None), (None, None, "model")]),
    (r"(attn|self_attn|cross_attn)/b[qkv]$", [("model", None), (None, None)]),
    # dense MLP (and MoE shared-expert MLP)
    (r"(mlp|shared)/w_gate$", [(None, "model")]),
    (r"(mlp|shared)/w_up$", [(None, "model")]),
    (r"(mlp|shared)/w_down$", [("model", None)]),
    (r"(mlp|shared)/b_up$", [("model",)]),
    (r"(mlp|shared)/b_down$", [(None,)]),
    # MoE routed experts: expert-parallel on the leading E axis
    (r"moe/router$", [(None, None)]),  # (d, E) tiny: replicated
    (r"moe/w_gate$", [("model", None, None), (None, None, "model")]),
    (r"moe/w_up$", [("model", None, None), (None, None, "model")]),
    (r"moe/w_down$", [("model", None, None), (None, "model", None)]),
    # Mamba2
    (r"ssm/in_proj$", [(None, "model"), ("model", None)]),
    (r"ssm/conv/kernel$", [(None, "model")]),
    (r"ssm/conv/bias$", [("model",)]),
    (r"ssm/A_log$", [("model",)]),
    (r"ssm/dt_bias$", [("model",)]),
    (r"ssm/D$", [("model",)]),
    (r"ssm/norm_scale$", [("model",)]),
    (r"ssm/out_proj$", [("model", None), (None, None)]),
    # RG-LRU
    (r"rec/proj_main$", [(None, "model")]),
    (r"rec/proj_gate$", [(None, "model")]),
    (r"rec/conv/kernel$", [(None, "model")]),
    (r"rec/conv/bias$", [("model",)]),
    (r"rec/w_a$", [(None, "model")]),
    (r"rec/w_x$", [(None, "model")]),
    (r"rec/b_a$", [("model",)]),
    (r"rec/b_x$", [("model",)]),
    (r"rec/lambda$", [("model",)]),
    (r"rec/proj_out$", [("model", None), (None, None)]),
    # norms: replicated
    (r"(norm\d?|final_norm|enc_norm)/(scale|bias)$", [(None,)]),
)


def _fits(shape, trailing, axis_sizes) -> bool:
    """Every sharded trailing dim must divide the mesh axis size."""
    off = len(shape) - len(trailing)
    for i, ax in enumerate(trailing):
        if ax is None:
            continue
        size = axis_sizes[ax] if isinstance(ax, str) else 1
        if isinstance(ax, tuple):
            size = 1
            for a in ax:
                size *= axis_sizes[a]
        if shape[off + i] % size != 0:
            return False
    return True


def _pick(shape, candidates, axis_sizes) -> PartitionSpec:
    for trailing in candidates:
        if len(trailing) > len(shape):
            continue
        if _fits(shape, trailing, axis_sizes):
            n_lead = len(shape) - len(trailing)
            return P(*((None,) * n_lead + tuple(trailing)))
    return P()  # replicate


_FSDP_MIN_DIM = 1024  # don't FSDP-shard tiny dims


def _add_fsdp(shape, spec: PartitionSpec, axis_sizes, fsdp_axis="data") -> PartitionSpec:
    """Shard the largest eligible unsharded dim over ``fsdp_axis`` (ZeRO-3
    style), never dim 0 of a leaf with three or more dims: in the
    reference's stacked trees that is the layer stack.  ``shape`` is the
    reference's (stacked) shape."""
    entries = list(spec)
    if len(entries) != len(shape):
        return spec
    if isinstance(fsdp_axis, str):
        dsize = axis_sizes.get(fsdp_axis, 1)
    else:
        dsize = 1
        for a in fsdp_axis:
            dsize *= axis_sizes.get(a, 1)
        fsdp_axis = tuple(fsdp_axis)
    best, best_dim = -1, None
    for i in range(len(shape)):
        if entries[i] is not None:
            continue
        if shape[i] >= _FSDP_MIN_DIM and shape[i] % dsize == 0 and shape[i] > best:
            if i == 0 and len(shape) >= 3:
                continue
            best, best_dim = shape[i], i
    if best_dim is None:
        return spec
    entries[best_dim] = fsdp_axis
    return P(*entries)


def rule_spec(path: str, shape: Sequence[int], axis_sizes: Mapping[str, int]) -> PartitionSpec:
    """The tensor-parallel spec of one parameter at ``path`` (the last
    components of its key path suffice, e.g. ``"attn/wq"``) and ``shape``,
    without FSDP: what the layers read to know which layout each of their
    weights has."""
    for pattern, candidates in _PARAM_RULES:
        if re.search(pattern, path):
            return _pick(tuple(shape), candidates, axis_sizes)
    return P()


def map_with_path(tree: Any, fn, path: Tuple[str, ...] = ()) -> Any:
    """``tree_map`` with each leaf's key path (list indices as strings);
    tensors, shape stand-ins and specs are leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec) \
            and not hasattr(tree, "shape"):
        out = [map_with_path(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    return fn(path, tree)


def _stack_len(cfg, path: Tuple[str, ...]) -> Optional[int]:
    """The length of the reference's layer stack that holds this leaf, or
    None where the reference does not stack it (top-level leaves, a
    hybrid's remainder layers)."""
    if len(path) < 2 or path[0] not in _STACKS or not path[1].isdigit():
        return None
    if cfg.arch_type == "hybrid":
        pat = cfg.block_pattern
        if int(path[1]) >= cfg.n_superblocks * len(pat):
            return None
        return cfg.n_superblocks
    return cfg.n_encoder_layers if path[0] == "enc_layers" else cfg.n_layers


def param_specs(cfg, params, axis_sizes=None, *, fsdp: bool = False,
                fsdp_axis="data") -> Any:
    """A :class:`PartitionSpec` tree matching ``params`` (the port's tree,
    on any device, the meta device included).

    ``axis_sizes``: {"model": 16, "data": 16, ...}; defaults to the
    production mesh's.  ``fsdp``: additionally shard big dims over
    ``fsdp_axis`` (a name or a tuple of names), as the reference's ZeRO-3
    layout; embedding-family tables are excluded, as there.  A layer's leaf
    gets the reference's spec of its stacked leaf without the stack dim.
    """
    axis_sizes = axis_sizes or dict(_DEFAULT_AXES)

    def leaf_spec(path, leaf):
        ps = "/".join(path)
        shape = tuple(leaf.shape)
        n = _stack_len(cfg, path)
        ref_shape = shape if n is None else (n,) + shape
        for pattern, candidates in _PARAM_RULES:
            if re.search(pattern, ps):
                spec = _pick(ref_shape, candidates, axis_sizes)
                if fsdp and not re.search(r"(embedding|lm_head)", ps):
                    spec = _add_fsdp(ref_shape, spec, axis_sizes, fsdp_axis)
                break
        else:
            return P()
        if n is not None and len(spec):
            spec = P(*tuple(spec)[1:])
        return spec

    return map_with_path(params, leaf_spec)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def _data_size(data_axes: Sequence[str], axis_sizes: Mapping[str, int]) -> int:
    n = 1
    for a in data_axes:
        n *= axis_sizes[a]
    return n


def batch_specs(cfg, batch, data_axes: Tuple[str, ...], axis_sizes=None) -> Any:
    """The batch's leading dim over the data axes where it divides, else
    replicated (e.g. a global batch of 1)."""
    axis_sizes = axis_sizes or dict(_DEFAULT_AXES)
    da = tuple(data_axes)
    da_size = _data_size(da, axis_sizes)

    def spec(path, leaf):
        nd = len(leaf.shape)
        if nd >= 1 and leaf.shape[0] % da_size == 0:
            return P(*((da,) + (None,) * (nd - 1)))
        return P()

    return map_with_path(batch, spec)


def _cache_leaf_spec(path: str, shape: Tuple[int, ...], da, da_size, sizes) -> PartitionSpec:
    """The reference's cache rule on a (stacked) cache leaf's shape."""
    nd = len(shape)
    last = path.rsplit("/", 1)[-1]

    def batch_ax(b):
        return da if b % da_size == 0 else None

    if last in ("k", "v", "k_scale", "v_scale") or (last in ("0", "1") and "cross" in path):
        # (..., B, cap, KV, hd|1): kv-heads -> sequence -> replicated
        ba = batch_ax(shape[-4])
        cands = [(ba, None, "model", None), (ba, "model", None, None), (ba, None, None, None)]
        return _pick(shape, cands, sizes) if ba else _pick(
            shape, [(None,) + c[1:] for c in cands], sizes)
    if last == "pos":
        return P()
    if last == "state":  # (..., B, H, P, N)
        ba = batch_ax(shape[-4])
        return _pick(shape, [(ba, "model", None, None), (ba, None, None, None)], sizes)
    if last == "conv":  # (..., B, w, ch)
        ba = batch_ax(shape[-3])
        return _pick(shape, [(ba, None, "model"), (ba, None, None)], sizes)
    if last == "h":  # (..., B, w)
        ba = batch_ax(shape[-2])
        return _pick(shape, [(ba, "model"), (ba, None)], sizes)
    if nd >= 2:
        ba = batch_ax(shape[-2])
        return _pick(shape, [(None, ba) + (None,) * (nd - 2)], sizes)
    return P()


def cache_specs(cfg, cache, data_axes: Tuple[str, ...], axis_sizes=None) -> Any:
    """KV and state cache specs with the fallback chains above, over the
    port's list of per-layer caches: each layer's leaf the reference's spec
    of its stacked leaf without the stack dim."""
    axis_sizes = axis_sizes or dict(_DEFAULT_AXES)
    da = tuple(data_axes)
    da_size = _data_size(da, axis_sizes)

    def spec(path, leaf):
        s = _cache_leaf_spec("/".join(path), (1,) + tuple(leaf.shape), da, da_size,
                             dict(axis_sizes))
        return P(*tuple(s)[1:]) if len(s) else s

    return map_with_path(cache, spec)


def kv_cache_layout(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
                    data_axes: Tuple[str, ...], axis_sizes: Mapping[str, int]) -> str:
    """Which of the KV cache's fallbacks :func:`cache_specs` picks for a
    ring of (batch, capacity, n_kv_heads, head_dim): ``"heads"`` (the
    kv-head axis over ``"model"``), ``"sequence"`` (context-parallel: the
    slots over ``"model"``) or ``"replicated"``."""
    spec = _cache_leaf_spec("k", (batch, capacity, n_kv_heads, head_dim), tuple(data_axes),
                            _data_size(data_axes, axis_sizes), dict(axis_sizes)).full(4)
    if spec[2] == "model":
        return "heads"
    if spec[1] == "model":
        return "sequence"
    return "replicated"


# ---------------------------------------------------------------------------
# the distributed engines' specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockSpec:
    """Split dim ``axis`` over the mesh axes ``axes`` (``()``: replicated)."""

    axes: Tuple[str, ...] = ()
    axis: int = 0

    def block(self, x: T, index: int, count: int) -> T:
        """Block ``index`` of ``count`` equal contiguous blocks of dim
        ``axis`` (a view; ``x`` itself when replicated)."""
        if not self.axes:
            return x
        size = x.shape[self.axis]
        if size % count:
            raise ValueError(
                f"axis {self.axis} of size {size} does not split over {count} data "
                "shards: pack with mesh= (or num_shards=) so it divides"
            )
        k = size // count
        index_ = (slice(None),) * self.axis + (slice(index * k, (index + 1) * k),)
        return x[index_]


def replicated() -> BlockSpec:
    """Every rank holds the whole array: carried state, parameters, and the
    all-reduced outputs."""
    return BlockSpec()


def data_parallel_spec(axes: Sequence[str], axis: int = 0) -> BlockSpec:
    """Split dim ``axis`` over the (possibly several) data axes."""
    axes = tuple(axes)
    if not axes:
        raise ValueError("data_parallel_spec needs at least one mesh axis")
    return BlockSpec(axes, axis)


def stats_specs(d: int = 0, model_size: int = 1, shard_rows: bool = True) -> Any:
    """FED3R statistics: A (d, d) and b (d, C) row-split over "model" where
    d divides it, n replicated (a ``Fed3RStats`` of specs)."""
    from repro_torch.core.fed3r import Fed3RStats  # core imports the dist layer

    rows = shard_rows and (d == 0 or d % model_size == 0)
    row = BlockSpec(("model",), 0) if rows else replicated()
    return Fed3RStats(A=row, b=row, n=replicated())
