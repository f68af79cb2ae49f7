"""Backbone stack of the dense and MoE paths: the ``"attn"`` block and its stack.

The port of the reference's ``models/transformer.py`` for decoder-only dense
and MoE models (an MoE block's FFN is :func:`repro_torch.models.moe.moe_apply`),
in its three modes: ``train`` (causal, no cache; also the feature
pass), ``prefill`` (build one KV ring cache a layer) and ``decode`` (one
token, consume and update the caches).  The reference stacks the layer
parameters and caches on a leading ``(n_layers, …)`` axis and scans over
it; here the stack is a list of per-layer parameter dicts, the caches a
list of per-layer cache dicts, and the scan a Python loop.  A block returns
its MoE load-balance loss (0 for a dense block) and the stack sums them.

SSM, hybrid and encoder-decoder stacks are later slices of the port
(ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.tree import tree_leaves, tree_map


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str = "attn") -> dict:
    if kind != "attn" or cfg.arch_type not in ("dense", "moe"):  # model.FAMILIES
        raise NotImplementedError(
            f"block kind {kind!r} of a {cfg.arch_type!r} model: the port has the dense and MoE "
            f"paths only"
        )
    p = {"norm1": norm_init(cfg, device=gen.device), "attn": attn_init(gen, cfg)}
    if cfg.arch_type == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    if not cfg.parallel_block:
        p["norm2"] = norm_init(cfg, device=gen.device)
    return p


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor, drops: Optional[moe_mod.DropTally]
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if "moe" in p:
        return moe_mod.moe_apply(cfg, p["moe"], h, drops)
    return mlp_apply(cfg, p["mlp"], h), None


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
) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Apply one block (pre-norm residual). Returns (x', the layer's cache,
    its MoE load-balance loss or None for a dense block); an MoE block adds
    its dropped entries to ``drops``."""
    if kind != "attn" or mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"block {kind!r} in mode {mode!r}: the port has the dense attn blocks only")
    h = norm_apply(cfg, p["norm1"], x)
    a, new_cache = attn_apply(
        cfg, p["attn"], h, angles=angles, window=window,
        cache=cache if mode == "decode" else None, decode_pos=decode_pos,
        build_cache=mode == "prefill", cache_capacity=cache_capacity,
    )
    if cfg.parallel_block:
        f, aux = _ffn(cfg, p, h, drops)
        return x + a + f, new_cache, aux
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


def apply_stack(
    cfg: ModelConfig,
    kind: str,
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
) -> Tuple[torch.Tensor, Optional[List[dict]], torch.Tensor]:
    """Run the layers in order (the reference's scan over stacked params).

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
    aux, caches = None, []
    for i, p in enumerate(layers):
        if recompute:
            x, a = _recomputed_block(cfg, kind, p, x, angles, window)
        else:
            x, c, a = block_apply(
                cfg, kind, p, x, angles=angles, window=window, mode=mode,
                cache=cache[i] if mode == "decode" else None, decode_pos=decode_pos,
                cache_capacity=cache_capacity, drops=drops,
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


def _recomputed_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, angles, window):
    """One train-mode block whose activations are recomputed in the backward:
    a gradient step keeps each block's input, not its internals (a
    fine-tuning round at full width holds 10 clients × 64 × 128 tokens of
    them at once).  Returns (x', the block's load-balance loss or None)."""
    moe = "moe" in p

    def fn(h, angles_, *leaves):
        it = iter(leaves)
        params = tree_map(lambda _: next(it), p)  # p's structure, fn's leaves
        y, _, aux = block_apply(cfg, kind, params, h, angles=angles_, window=window)
        return (y, aux) if moe else y

    out = _Recompute.apply(fn, x, angles, *tree_leaves(p))
    return out if moe else (out, None)
