"""Backbone stacks: the ``"attn"``, ``"ssm"``, ``"rec"``, ``"enc"`` and ``"dec"`` blocks.

The port of the reference's ``models/transformer.py``: dense and MoE (an
MoE block's FFN is :func:`repro_torch.models.moe.moe_apply`), VLM (the
dense block), SSM (the Mamba2 mixer of :mod:`repro_torch.models.ssm`),
hybrid (RecurrentGemma: RG-LRU ``"rec"`` blocks of
:mod:`repro_torch.models.rglru` and local attention ``"attn"`` blocks) and
the encoder-decoder (Whisper: ``"enc"`` blocks of bidirectional
self-attention, ``"dec"`` blocks of causal self-attention, cross-attention
over the encoder states and a GELU MLP), in their three modes: ``train``
(causal, no cache; also the feature pass), ``prefill`` (build one cache a
layer: a KV ring, an SSM state, an RG-LRU state, or a decoder layer's ring
and its cross-attention (k, v); an encoder layer builds none) and
``decode`` (one token, consume and update the caches in place; the cross
(k, v) are read, never projected again).  The reference stacks the layer parameters
and caches on a leading ``(n_layers, …)`` axis and scans over it (the hybrid
over 12 ``(rec, rec, attn)`` super-blocks plus an unrolled remainder);
here every stack is a list of per-layer parameter dicts in layer order
(``cfg.pattern_for``), the caches a list of per-layer cache dicts, and the
scan a Python loop.  A block returns its MoE load-balance loss (None for
any other block) and the stack sums them.

Under a ``"model"`` axis larger than 1 (:mod:`repro_torch.sharding.hints`)
a block all-reduces once after attention (or cross-attention, the RG-LRU,
the Mamba2 mixer) and once after the FFN, a ``parallel_block`` once for
a + f together.  Under a gradient each block's backward runs its forward
again, collectives included, then their backward (the all-reduces of
:mod:`repro_torch.sharding.hints` differentiate as GSPMD's do): every rank
recomputes the same blocks in the same order, so the collectives line up,
and an MoE block routes on the all-reduced x, the same bits on every model
rank, in the forward and in its recompute.

Under FSDP (``hints.use_mesh(mesh, fsdp=True)``) every block gathers its
FSDP leaves over the data axes when it starts and drops them when it ends;
a recomputed block gathers them again in its backward, whose gradient
reduce-scatters them (ZeRO-3).  Which leaves a block gathers, and along
which dim, is read at the block's own key path (its stack's key and its
index): a hybrid's ``rec`` and ``attn`` blocks, Whisper's ``enc`` and
``dec`` blocks, and a layer the reference stacks and one it unrolls each
have their own layout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attn_apply, attn_init, cross_attn_apply
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.sharding import hints
from repro_torch.sharding.shard import gather_fsdp
from repro_torch.tree import tree_leaves, tree_map


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str = "attn") -> dict:
    dev = gen.device
    if kind == "attn" and cfg.arch_type in ("dense", "moe", "vlm", "hybrid"):
        p = {"norm1": norm_init(cfg, device=dev), "attn": attn_init(gen, cfg)}
        if cfg.arch_type == "moe":
            p["moe"] = moe_mod.moe_init(gen, cfg)
        else:
            p["mlp"] = mlp_init(gen, cfg)
        if not cfg.parallel_block:
            p["norm2"] = norm_init(cfg, device=dev)
        return p
    if kind == "ssm":
        return {"norm1": norm_init(cfg, device=dev), "ssm": ssm_mod.ssm_init(gen, cfg)}
    if kind == "rec":
        return {
            "norm1": norm_init(cfg, device=dev),
            "rec": rglru_mod.rglru_init(gen, cfg),
            "norm2": norm_init(cfg, device=dev),
            "mlp": mlp_init(gen, cfg),
        }
    if kind == "enc":
        return {
            "norm1": norm_init(cfg, device=dev),
            "attn": attn_init(gen, cfg),
            "norm2": norm_init(cfg, device=dev),
            "mlp": mlp_init(gen, cfg),
        }
    if kind == "dec":
        return {
            "norm1": norm_init(cfg, device=dev),
            "self_attn": attn_init(gen, cfg),
            "norm2": norm_init(cfg, device=dev),
            "cross_attn": attn_init(gen, cfg),
            "norm3": norm_init(cfg, device=dev),
            "mlp": mlp_init(gen, cfg),
        }
    raise ValueError(f"unknown block kind {kind!r} of a {cfg.arch_type!r} model")


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor, drops: Optional[moe_mod.DropTally],
         reduce: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if "moe" in p:
        return moe_mod.moe_apply(cfg, p["moe"], h, drops, reduce=reduce)
    return mlp_apply(cfg, p["mlp"], h, reduce=reduce), None


def block_apply(
    cfg: ModelConfig,
    kind: str,
    p: dict,
    x: torch.Tensor,
    *,
    angles: Optional[torch.Tensor],
    window: Optional[int],
    mode: str = "train",
    cache: Optional[dict] = None,
    decode_pos: Optional[int] = None,
    cache_capacity: Optional[int] = None,
    drops: Optional[moe_mod.DropTally] = None,
    enc_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Apply one block (pre-norm residual). Returns (x', the layer's cache,
    its MoE load-balance loss or None for any other block); an MoE block adds
    its dropped entries to ``drops``.  ``angles`` and ``window`` reach the
    attention block only; ``enc_states`` (B, F, d), the encoder's output,
    reaches a decoder block's cross-attention outside decode, whose cache
    ``{"self": ring, "cross": (k, v)}`` holds what decode reads instead."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    decode, build = mode == "decode", mode == "prefill"
    h = norm_apply(cfg, p["norm1"], x)
    if kind == "ssm":
        if decode:
            y, new_cache = ssm_mod.ssm_decode_step(cfg, p["ssm"], h, cache)
        else:
            y, new_cache = ssm_mod.ssm_apply(cfg, p["ssm"], h, build_cache=build)
        return x + y, new_cache, None
    if kind == "rec":
        if decode:
            y, new_cache = rglru_mod.rglru_decode_step(cfg, p["rec"], h, cache)
        else:
            y, new_cache = rglru_mod.rglru_apply(cfg, p["rec"], h, build_cache=build)
        x = x + y
        return x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["norm2"], x)), new_cache, None
    if kind == "enc":
        a, _ = attn_apply(cfg, p["attn"], h, bidirectional=True, build_cache=build)
        x = x + a
        return x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["norm2"], x)), None, None
    if kind == "dec":
        a, new_self = attn_apply(
            cfg, p["self_attn"], h, cache=cache["self"] if decode else None,
            decode_pos=decode_pos, build_cache=build, cache_capacity=cache_capacity,
        )
        x = x + a
        c, new_cross = cross_attn_apply(
            cfg, p["cross_attn"], norm_apply(cfg, p["norm2"], x),
            enc_kv=cache["cross"] if decode else None, enc_states=enc_states,
        )
        x = x + c
        x = x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["norm3"], x))
        new_cache = None if mode == "train" else {"self": new_self, "cross": new_cross}
        return x, new_cache, None
    if kind != "attn":
        raise ValueError(f"unknown block kind {kind!r}")
    # under a "model" axis: one all-reduce after the attention and one after
    # the FFN, or, in a parallel block, one of both
    par = cfg.parallel_block and hints.model_size() > 1
    a, new_cache = attn_apply(
        cfg, p["attn"], h, angles=angles, window=window,
        cache=cache if decode else None, decode_pos=decode_pos,
        build_cache=build, cache_capacity=cache_capacity, reduce=not par,
    )
    if cfg.parallel_block:
        f, aux = _ffn(cfg, p, h, drops, reduce=not par)
        return (x + hints.reduce_model(a + f) if par else x + a + f), new_cache, aux
    x = x + a
    h = norm_apply(cfg, p["norm2"], x)
    f, aux = _ffn(cfg, p, h, drops)
    return x + f, new_cache, aux


def stacked_block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int) -> List[dict]:
    return [block_init(gen, cfg, kind) for _ in range(n)]


def stacked_attn_cache(cfg: ModelConfig, n: int, batch: int, cap: int, dtype: torch.dtype,
                       device=None) -> List[dict]:
    """``n`` empty ring caches, one a layer (the reference's stacked leaves)."""
    return [attn_mod.init_cache(cfg, batch, cap, dtype, device) for _ in range(n)]


def stacked_ssm_cache(cfg: ModelConfig, n: int, batch: int, dtype: torch.dtype,
                      device=None) -> List[dict]:
    """``n`` zero SSM caches: ``state`` (B, H, P, N) fp32, ``conv`` (B, w-1, C)
    (under a "model" axis the rank's heads and conv channels)."""
    conv_ch, heads = ssm_mod.cache_widths(cfg)
    state = (batch, heads, cfg.ssm_headdim, cfg.ssm_state)
    return [{"state": torch.zeros(state, dtype=torch.float32, device=device),
             "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device)}
            for _ in range(n)]


def stacked_rec_cache(cfg: ModelConfig, n: int, batch: int, dtype: torch.dtype,
                      device=None) -> List[dict]:
    """``n`` zero RG-LRU caches: ``h`` (B, lru_width) fp32, ``conv`` (B, 3,
    lru_width) (under a "model" axis the rank's channels)."""
    w = rglru_mod.rank_width(cfg)
    return [{"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
             "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device)}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# hybrid stack (RecurrentGemma): the layers of cfg.pattern_for, in order
# ---------------------------------------------------------------------------


def hybrid_init(gen: torch.Generator, cfg: ModelConfig) -> List[dict]:
    """One block a layer, of the kind ``cfg.pattern_for(cfg.n_layers)`` names
    (the reference's 12 stacked super-blocks and 2 remainder layers,
    unrolled)."""
    return [block_init(gen, cfg, kind) for kind in cfg.pattern_for(cfg.n_layers)]


def hybrid_cache(cfg: ModelConfig, batch: int, cap: int, dtype: torch.dtype,
                 device=None) -> List[dict]:
    """One cache a layer: an RG-LRU state for ``rec``, a KV ring of ``cap``
    slots for ``attn``."""
    return [stacked_rec_cache(cfg, 1, batch, dtype, device)[0] if kind == "rec"
            else attn_mod.init_cache(cfg, batch, cap, dtype, device)
            for kind in cfg.pattern_for(cfg.n_layers)]


def apply_hybrid(
    cfg: ModelConfig,
    layers: List[dict],
    x: torch.Tensor,
    *,
    angles,
    mode: str,
    cache: Optional[List[dict]] = None,
    decode_pos: Optional[int] = None,
    cache_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[List[dict]], torch.Tensor]:
    """The hybrid stack: its attention layers run with ``cfg.local_window``."""
    return apply_stack(cfg, cfg.pattern_for(cfg.n_layers), layers, x, angles=angles,
                       window=cfg.local_window, mode=mode, cache=cache,
                       decode_pos=decode_pos, cache_capacity=cache_capacity)


def apply_stack(
    cfg: ModelConfig,
    kind: Union[str, Sequence[str]],
    layers: List[dict],
    x: torch.Tensor,
    *,
    angles=None,
    window=None,
    mode="train",
    cache: Optional[List[dict]] = None,
    decode_pos: Optional[int] = None,
    cache_capacity: Optional[int] = None,
    drops: Optional[moe_mod.DropTally] = None,
    enc_states: Optional[torch.Tensor] = None,
    stack: str = "layers",
) -> Tuple[torch.Tensor, Optional[List[dict]], torch.Tensor]:
    """Run the layers in order (the reference's scan over stacked params);
    ``kind`` is every layer's block kind, or one a layer; ``enc_states``
    reaches every decoder block's cross-attention; ``stack`` is the
    layers' key in the parameters (layer i's FSDP leaves are those at
    ``(stack, str(i))``).

    Returns (x, the per-layer caches, the summed load-balance loss): the
    caches built in ``prefill``, updated in ``decode`` (in place), None in
    ``train``; the loss an fp32 scalar, 0 for dense layers (summed from the
    first MoE layer's on: the reference's 0 + a₁ + … in the same bits).
    ``drops`` sums the MoE layers' dropped entries; it is not counted under a
    gradient, whose backward recomputes each block.
    """
    if mode == "decode" and (cache is None or len(cache) != len(layers)):
        raise ValueError("decode needs one cache a layer")
    recompute = mode == "train" and torch.is_grad_enabled()
    if recompute and drops is not None:
        raise ValueError("drops are counted outside a gradient (torch.no_grad)")
    kinds = [kind] * len(layers) if isinstance(kind, str) else kind
    aux, caches = None, []
    for i, p in enumerate(layers):
        prefix = (stack, str(i))
        if recompute:
            x, a = _recomputed_block(cfg, kinds[i], p, x, angles, window, enc_states, prefix)
        else:
            x, c, a = block_apply(
                cfg, kinds[i], gather_fsdp(cfg, p, prefix), x, angles=angles, window=window,
                mode=mode,
                cache=cache[i] if mode == "decode" else None, decode_pos=decode_pos,
                cache_capacity=cache_capacity, drops=drops, enc_states=enc_states,
            )
            caches.append(c)
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (caches if mode != "train" else None), aux


class _Recompute(torch.autograd.Function):
    """``fn(x, const, *params)`` that keeps only its inputs for the backward,
    which runs ``fn`` again and takes its vector-Jacobian product in ``x``
    and ``params`` (``const`` gets no gradient).

    Activation checkpointing for ``torch.func`` (``torch.utils.checkpoint``
    relies on saved-tensor hooks, which ``torch.func.grad`` refuses): the
    forward and the gradients are bitwise those of ``fn`` under plain
    autograd, for one more forward of ``fn`` a backward.  Every tensor
    ``fn`` reads is an input: a function under ``torch.func`` transforms
    must not capture tensors of an outer level.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, x, const, *params):
        return fn(x, const, *params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *tensors = inputs
        ctx.fn = fn
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grad_outs):
        x, const, *params = ctx.saved_tensors
        # torch.func.grad runs its backward with create_graph=True, which
        # would keep every block's recomputed activations alive until the
        # gradients die; no_grad keeps them to this block (the vjp inside
        # still differentiates: a transform ignores an outer no_grad)
        with torch.no_grad():
            _, vjp = torch.func.vjp(lambda h, *ps: ctx.fn(h, const, *ps), x, *params)
            grad_x, *grad_params = vjp(grad_outs if len(grad_outs) > 1 else grad_outs[0])
        return (None, grad_x, None, *grad_params)


def _recomputed_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, angles, window,
                      enc_states: Optional[torch.Tensor], prefix: Tuple[str, ...]):
    """One train-mode block whose activations are recomputed in the backward:
    a gradient step keeps each block's input, not its internals (a
    fine-tuning round at full width holds 10 clients × 64 × 128 tokens of
    them at once).  ``enc_states`` (a decoder block's) goes in after the
    parameters, so it gets its gradient (the encoder's leaves would get
    none as ``const``); ``prefix`` is the block's key path, whose FSDP
    leaves it gathers.  Returns (x', the block's load-balance loss or None)."""
    moe = "moe" in p
    extra = () if enc_states is None else (enc_states,)

    def fn(h, angles_, *leaves):
        it = iter(leaves)
        params = tree_map(lambda _: next(it), p)  # p's structure, fn's leaves
        y, _, aux = block_apply(cfg, kind, gather_fsdp(cfg, params, prefix), h,
                                angles=angles_, window=window, enc_states=next(it, None))
        return (y, aux) if moe else y

    out = _Recompute.apply(fn, x, angles, *tree_leaves(p), *extra)
    return out if moe else (out, None)
