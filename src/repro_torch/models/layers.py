"""Common layers of the dense path: norms, MLPs, embeddings, rotary.

The port of the reference's ``models/layers.py``, with its conventions:

* activations: ``(batch, seq, d_model)`` in ``cfg.dtype`` (bf16 by default);
* parameters: fp32, cast to the activation dtype at every product;
* every layer is a pair ``<layer>_init(gen, cfg, ...) -> params`` and
  ``<layer>_apply(params, x, ...) -> y`` over plain dicts of tensors, with
  the reference's parameter names and layouts.

Randomness comes from a ``torch.Generator``; the draws match the
reference's in distribution, not in bits.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0) -> torch.Tensor:
    """Fan-in truncated-normal initializer (maxtext-style), fp32."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return std * torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, d: Optional[int] = None, device=None) -> dict:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in fp32, returned in input dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    """Gated (swiglu/geglu) or plain (gelu) MLP parameters."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, f)),
            "w_up": dense_init(gen, (d, f)),
            "w_down": dense_init(gen, (f, d)),
        }
    return {
        "w_up": dense_init(gen, (d, f)),
        "b_up": torch.zeros((f,), dtype=torch.float32, device=gen.device),
        "w_down": dense_init(gen, (f, d)),
        "b_down": torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        g = act(x @ p["w_gate"].to(dt))
        u = x @ p["w_up"].to(dt)
        return (g * u) @ p["w_down"].to(dt)
    h = _gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary half-dims: (head_dim//2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2), fp32."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate half-split pairs. x: (B, S, H, hd); angles: (B, S, hd//2) or (S, hd//2)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]  # (B, S, 1, hd//2)
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_apply(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["embedding"][tokens.long()].to(dtype)


def unembed_apply(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocab logits (tied or separate head).

    The table is padded to ``cfg.padded_vocab``; padded columns are masked
    to −1e30 so softmax/CE semantics are unchanged.
    """
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(x.dtype)
    if cfg.attn_logit_softcap:  # reuse as final-logit softcap when configured
        cap = cfg.attn_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if cfg.padded_vocab > cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(
            col < cfg.vocab_size, logits, torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
        )
    return logits
