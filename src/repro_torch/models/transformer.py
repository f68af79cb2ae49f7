"""Backbone stack of the dense path: the ``"attn"`` block and its stack.

The port of the reference's ``models/transformer.py`` for decoder-only dense
models, in its three modes: ``train`` (causal, no cache; also the feature
pass), ``prefill`` (build one KV ring cache a layer) and ``decode`` (one
token, consume and update the caches).  The reference stacks the layer
parameters and caches on a leading ``(n_layers, …)`` axis and scans over
it; here the stack is a list of per-layer parameter dicts, the caches a
list of per-layer cache dicts, and the scan a Python loop.

MoE, SSM, hybrid and encoder-decoder stacks are later slices of the port
(ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str = "attn") -> dict:
    if kind != "attn" or cfg.arch_type != "dense":
        raise NotImplementedError(
            f"block kind {kind!r} of a {cfg.arch_type!r} model: the port has the dense path only"
        )
    p = {"norm1": norm_init(cfg, device=gen.device), "attn": attn_init(gen, cfg)}
    p["mlp"] = mlp_init(gen, cfg)
    if not cfg.parallel_block:
        p["norm2"] = norm_init(cfg, device=gen.device)
    return p


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
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Apply one block (pre-norm residual). Returns (x', the layer's cache)."""
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
        return x + a + mlp_apply(cfg, p["mlp"], h), new_cache
    x = x + a
    h = norm_apply(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h), new_cache


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
) -> Tuple[torch.Tensor, Optional[List[dict]]]:
    """Run the layers in order (the reference's scan over stacked params).

    Returns (x, the per-layer caches): built in ``prefill``, updated in
    ``decode`` (in place), None in ``train``.
    """
    if mode == "decode" and (cache is None or len(cache) != len(layers)):
        raise ValueError("decode needs one cache a layer")
    if mode == "train" and torch.is_grad_enabled():
        for p in layers:
            x = _recomputed_block(cfg, kind, p, x, angles, window)
        return x, None
    caches = []
    for i, p in enumerate(layers):
        x, c = block_apply(
            cfg, kind, p, x, angles=angles, window=window, mode=mode,
            cache=cache[i] if mode == "decode" else None, decode_pos=decode_pos,
            cache_capacity=cache_capacity,
        )
        caches.append(c)
    return x, (caches if mode != "train" else None)


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
    def backward(ctx, grad_out):
        x, const, *params = ctx.saved_tensors
        # torch.func.grad runs its backward with create_graph=True, which
        # would keep every block's recomputed activations alive until the
        # gradients die; no_grad keeps them to this block (the vjp inside
        # still differentiates: a transform ignores an outer no_grad)
        with torch.no_grad():
            _, vjp = torch.func.vjp(lambda h, *ps: ctx.fn(h, const, *ps), x, *params)
            grad_x, *grad_params = vjp(grad_out)
        return (None, grad_x, None, *grad_params)


def _recomputed_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, angles, window):
    """One train-mode block whose activations are recomputed in the backward:
    a gradient step keeps each block's input, not its internals (a
    fine-tuning round at full width holds 10 clients × 64 × 128 tokens of
    them at once)."""
    paths = [(group, name) for group in p for name in p[group]]

    def fn(h, angles_, *leaves):
        params: dict = {}
        for (group, name), leaf in zip(paths, leaves):
            params.setdefault(group, {})[name] = leaf
        return block_apply(cfg, kind, params, h, angles=angles_, window=window)[0]

    return _Recompute.apply(fn, x, angles, *(p[group][name] for group, name in paths))
