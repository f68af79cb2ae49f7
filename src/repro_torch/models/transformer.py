"""Backbone stack of the dense path: the ``"attn"`` block and its stack.

The port of the reference's ``models/transformer.py`` for decoder-only dense
models in train / feature mode.  The reference stacks the layer parameters
on a leading ``(n_layers, …)`` axis and scans over it; here the stack is a
list of per-layer parameter dicts and the scan is a Python loop.

MoE, SSM, hybrid and encoder-decoder stacks, caches and decode are later
slices of the port.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
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
) -> torch.Tensor:
    """Apply one block (pre-norm residual). Returns x'."""
    if kind != "attn" or mode != "train":
        raise NotImplementedError(f"block {kind!r} in mode {mode!r}: the port has train-mode attn blocks only")
    h = norm_apply(cfg, p["norm1"], x)
    a = attn_apply(cfg, p["attn"], h, angles=angles, window=window)
    if cfg.parallel_block:
        return x + a + mlp_apply(cfg, p["mlp"], h)
    x = x + a
    h = norm_apply(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h)


def stacked_block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int) -> List[dict]:
    return [block_init(gen, cfg, kind) for _ in range(n)]


def apply_stack(
    cfg: ModelConfig,
    kind: str,
    layers: List[dict],
    x: torch.Tensor,
    *,
    angles=None,
    window=None,
    mode="train",
) -> torch.Tensor:
    """Run the layers in order (the reference's scan over stacked params)."""
    for p in layers:
        x = block_apply(cfg, kind, p, x, angles=angles, window=window, mode=mode)
    return x
