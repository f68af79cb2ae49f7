"""Attention of the dense path: GQA/MHA with position-based masking.

The port of the reference's ``models/attention.py`` without caches (train
and feature extraction only).  Layout: q ``(B, Sq, H, hd)``, k/v
``(B, Sk, KV, hd)``; projection weights ``wq`` (d, H, hd), ``wk``/``wv``
(d, KV, hd), ``wo`` (H, hd, d), as in the reference.

Masking is position-based: a query at position p attends to key slots with
``0 <= k_pos <= p`` and, with a sliding window W, ``k_pos > p - W``.  Scores
are computed in the activation dtype, scaled, then taken to fp32, masked
with −1e30 and soft-maxed; the probabilities go back to the query dtype
before the value product — the reference's rounding points.  Queries longer
than ``2·Q_CHUNK`` run chunk by chunk (the same rows, less memory).

KV caches, prefill and decode are a later slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

Q_CHUNK = 1024  # query-chunk size of long sequences

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """QKV/O projection parameters."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (d, H, hd)),
        "wk": dense_init(gen, (d, KV, hd)),
        "wv": dense_init(gen, (d, KV, hd)),
        "wo": dense_init(gen, (H, hd, d), in_axis=0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=torch.float32, device=gen.device)
        p["bk"] = torch.zeros((KV, hd), dtype=torch.float32, device=gen.device)
        p["bv"] = torch.zeros((KV, hd), dtype=torch.float32, device=gen.device)
    return p


def _scores_softmax_values(q, k, v, q_pos, k_pos, window, bidirectional):
    """Exact attention for one q block against a key range.

    q: (B, Sq, KV, G, hd)   k/v: (B, Sk, KV, hd)
    q_pos: (Sq,) int        k_pos: (Sk,) int (−1 = empty slot)
    returns (B, Sq, KV, G, hd)
    """
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * hd ** -0.5  # (B,KV,G,Sq,Sk)
    scores = scores.to(torch.float32)
    valid = k_pos[None, :] >= 0  # (1, Sk)
    if not bidirectional:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(valid, scores, torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    bidirectional: bool = False,
) -> torch.Tensor:
    """Exact GQA attention, query-chunked beyond ``2·Q_CHUNK``.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); q_pos: (Sq,); k_pos: (Sk,).
    Returns (B, Sq, H, hd).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)

    if Sq <= 2 * Q_CHUNK:
        out = _scores_softmax_values(qg, k, v, q_pos, k_pos, window, bidirectional)
        return out.reshape(B, Sq, H, hd)

    if Sq % Q_CHUNK:
        raise ValueError(f"Sq={Sq} not divisible by Q_CHUNK={Q_CHUNK}")
    # With a sliding window each q chunk only needs keys in
    # [chunk_start - window + 1, chunk_end); slice that range (static length).
    use_slice = window is not None and not bidirectional and Sk > window + Q_CHUNK
    slice_len = min(Sk, window + Q_CHUNK) if use_slice else Sk
    outs = []
    for s0 in range(0, Sq, Q_CHUNK):
        qc, pc = qg[:, s0 : s0 + Q_CHUNK], q_pos[s0 : s0 + Q_CHUNK]
        kc, vc, kpc = k, v, k_pos
        if use_slice:
            start = min(max(int(pc[0]) - (window - 1), 0), Sk - slice_len)
            kc = k[:, start : start + slice_len]
            vc = v[:, start : start + slice_len]
            kpc = k_pos[start : start + slice_len]
        outs.append(_scores_softmax_values(qc, kc, vc, pc, kpc, window, bidirectional))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") with the fp32 weight cast to x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def attn_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    angles: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    bidirectional: bool = False,
) -> torch.Tensor:
    """Self-attention layer over a whole sequence (train / feature mode)."""
    S = x.shape[1]
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    pos = torch.arange(S, device=x.device)
    y = multihead_attention(q, k, v, pos, pos, window=window, bidirectional=bidirectional)
    H, hd, d = p["wo"].shape
    return y.reshape(*y.shape[:2], H * hd) @ p["wo"].to(x.dtype).reshape(H * hd, d)
