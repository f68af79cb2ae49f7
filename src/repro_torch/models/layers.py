"""Common layers: norms, MLPs, embeddings, rotary (and M-RoPE), sinusoidal
positions, causal conv.

The port of the reference's ``models/layers.py``, with its conventions:

* activations: ``(batch, seq, d_model)`` in ``cfg.dtype`` (bf16 by default);
* parameters: fp32, cast to the activation dtype at every product;
* every layer is a pair ``<layer>_init(gen, cfg, ...) -> params`` and
  ``<layer>_apply(params, x, ...) -> y`` over plain dicts of tensors, with
  the reference's parameter names and layouts.

Randomness comes from a ``torch.Generator``; the draws match the
reference's in distribution, not in bits.

Under an ambient mesh with a ``"model"`` axis larger than 1
(:mod:`repro_torch.sharding.hints`) the MLP runs column-parallel up and
row-parallel down; the embedding looks up its vocab rows or its d_model
columns, and the LM head produces the rank's vocab columns or its partial
logits over its d_model rows; each holds only its block of its parameters.
The causal conv runs on whatever channels it is given (a rank's block).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import hints

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


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """The MLP of hidden width ``cfg.d_ff``.  Under a "model" axis its
    hidden axis is split (``w_gate``/``w_up`` by columns, ``w_down`` by
    rows) and the rank's partial sums are all-reduced; without ``reduce``
    the rank's partial sum is returned (see ``hints.finish``)."""
    if hints.model_size() == 1:
        return _mlp(cfg, p, x, bias_down=True)
    split = hints.layout("mlp/w_up", (cfg.d_model, cfg.d_ff))[1] == "model"
    # b_down is replicated: it joins one rank's partial sum only
    y = _mlp(cfg, p, x, bias_down=not split or hints.model_rank() == 0)
    return hints.finish(y, partial=split, reduce=reduce)


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, bias_down: bool) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else gelu
        g = act(x @ p["w_gate"].to(dt))
        u = x @ p["w_up"].to(dt)
        return (g * u) @ p["w_down"].to(dt)
    h = gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    y = h @ p["w_down"].to(dt)
    return y + p["b_down"].to(dt) if bias_down else y


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


def mrope_angles(positions_3d: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): three position streams share the rotary dims.

    positions_3d: (3, ..., S) — temporal / height / width position ids;
    sections: how many of the head_dim//2 rotary dims each stream owns, e.g.
    (16, 24, 24) for head_dim 128.  Returns angles (..., S, head_dim//2),
    fp32, which :func:`apply_rope` takes as it takes :func:`rope_angles`'.
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim//2 = "
                         f"{head_dim // 2}")
    inv = rope_frequencies(head_dim, theta, positions_3d.device)
    ang = positions_3d.to(torch.float32)[..., None] * inv  # (3, ..., S, hd//2)
    pieces, start = [], 0
    for i, sec in enumerate(sections):
        pieces.append(ang[i, ..., start:start + sec])
        start += sec
    return torch.cat(pieces, dim=-1)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n_pos, d), fp32: the first half
    sines, the second cosines, of position · exp(−log(10⁴)/(d/2 − 1) · i)."""
    half = d // 2
    log_timescale = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32, device=device))
    scaled = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# causal depthwise conv (Mamba2 / RG-LRU temporal conv)
# ---------------------------------------------------------------------------


def causal_conv1d_init(gen: torch.Generator, channels: int, width: int) -> dict:
    return {
        "kernel": dense_init(gen, (width, channels), in_axis=0),
        "bias": torch.zeros((channels,), dtype=torch.float32, device=gen.device),
    }


def causal_conv1d_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's dtype. x: (B, S, C) -> (B, S, C)."""
    width = p["kernel"].shape[0]
    dt, S = x.dtype, x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    ker = p["kernel"].to(dt)
    out = torch.zeros_like(x)
    for i in range(width):  # width is small (4): unrolled taps
        out = out + pad[:, i:i + S, :] * ker[i]
    return out + p["bias"].to(dt)


def causal_conv1d_step(p: dict, conv_state: torch.Tensor, x_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. conv_state: (B, width-1, C), shifted IN PLACE by one
    token; x_t: (B, C).  Returns (conv_state, y_t (B, C))."""
    dt = x_t.dtype
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, width, C)
    y = torch.einsum("bwc,wc->bc", window, p["kernel"].to(dt)) + p["bias"].to(dt)
    conv_state.copy_(window[:, 1:, :])
    return conv_state, y


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_apply(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # F.embedding, not table[tokens]: the same gather, but its backward sums
    # each row's gradients in a fixed order, where indexing's backward
    # (index_put_ with accumulate) is not repeatable across runs
    return F.embedding(tokens.long(), p["embedding"]).to(dtype)


def table_split(cfg: ModelConfig, tied_table: bool) -> Optional[str]:
    """How the embedding table (``tied_table``) or the LM head is split
    under the ambient mesh: ``"vocab"``, ``"d_model"`` or None (whole)."""
    V, d = cfg.padded_vocab, cfg.d_model
    if tied_table:
        spec, vocab_dim = hints.layout("embed/embedding", (V, d)), 0
    else:
        spec, vocab_dim = hints.layout("lm_head/kernel", (d, V)), 1
    if spec.is_replicated():
        return None
    return "vocab" if spec[vocab_dim] == "model" else "d_model"


def embed_tokens(cfg: ModelConfig, p: dict, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """:func:`embed_apply` of ``cfg``'s table.  Under a "model" axis that
    splits the vocab, the rank looks up its own rows, zeroes the others and
    the ranks' rows are summed (exact: one rank holds each row); where it
    splits d_model, the rank looks up its columns of every row and the
    ranks' columns are gathered."""
    split = None if hints.model_size() == 1 else table_split(cfg, tied_table=True)
    if split is None:
        return embed_apply(p, tokens, dtype)
    table = p["embedding"]
    if split == "d_model":  # the fp32 columns, gathered exactly
        return hints.gather_model(F.embedding(tokens.long(), table), -1).to(dtype)
    n = table.shape[0]
    local = tokens.long() - hints.model_rank() * n
    hit = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    rows = torch.where(hit[..., None], rows, 0.0)  # a scalar: no host-to-device copy
    return hints.reduce_model(rows).to(dtype)  # the fp32 rows, summed exactly


def unembed_apply(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocab logits (tied or separate head).

    The table is padded to ``cfg.padded_vocab``; padded columns are masked
    to −1e30 so softmax/CE semantics are unchanged.  Under a "model" axis
    that splits the vocab each rank computes its own columns (masked by
    their global index) and the ranks' columns are concatenated; where it
    splits d_model each rank multiplies its columns of x by its block of
    the table and the partial logits are all-reduced.
    """
    split = None if hints.model_size() == 1 else table_split(cfg, cfg.tie_embeddings)
    xs = hints.model_block(x, -1) if split == "d_model" else x
    if cfg.tie_embeddings:
        logits = xs @ params["embed"]["embedding"].to(x.dtype).T
    else:
        logits = xs @ params["lm_head"]["kernel"].to(x.dtype)
    if split == "d_model":
        logits = hints.reduce_model(logits)
    if cfg.attn_logit_softcap:  # reuse as final-logit softcap when configured
        cap = cfg.attn_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if cfg.padded_vocab > cfg.vocab_size:
        n = logits.shape[-1]
        col0 = hints.model_rank() * n if split == "vocab" else 0
        col = torch.arange(col0, col0 + n, device=logits.device)
        # a Python scalar: a tensor built here would be a blocking host-to-device copy
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return hints.gather_model(logits, -1) if split == "vocab" else logits
