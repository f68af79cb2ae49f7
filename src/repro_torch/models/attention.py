"""Attention: GQA/MHA/MQA, position masks, sliding windows, KV ring caches.

The port of the reference's ``models/attention.py``.  Layout: q
``(B, Sq, H, hd)``, k/v ``(B, Sk, KV, hd)``; projection weights ``wq``
(d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d), as in the
reference.

Masking is position-based: a query at position p attends to key slots with
``0 <= k_pos <= p`` and, with a sliding window W, ``k_pos > p - W``.  Scores
are computed in the activation dtype, scaled, then taken to fp32, masked
with −1e30 and soft-maxed; the probabilities go back to the query dtype
before the value product — the reference's rounding points.  Queries longer
than ``2·Q_CHUNK`` run chunk by chunk (the same rows, less memory).

Modes of :func:`attn_apply`:

* train / feature: the plain attention above (the FED3R feature pass);
* prefill: the attention over positions 0..S−1 goes through
  ``ops.flash_attention`` (the CUDA kernel on the card, once a layer), and
  the keys and values fill a KV ring cache;
* decode: one query against the ring buffer (``k_pos`` −1 on empty slots)
  through the plain attention, as in the reference.

The KV cache is a ring buffer of capacity ``Scap`` (the window for
sliding-window configs): slot j holds the latest position p with
p % Scap == j; RoPE is applied to keys before they are written.  With
``kv_cache_quant`` it holds int8 values and one fp32 scale per (batch,
token, head).  Unlike the reference's functional updates, prefill fills
fresh buffers and decode writes its token into the cache IN PLACE (one slot
a layer instead of a copy of the whole cache a step); both return the cache.
No step makes a device tensor from host data (``torch.tensor(..., device=)``
blocks the host until the card drains its queue): positions are filled on
the card and the mask value is a scalar.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

Q_CHUNK = 1024  # query-chunk size of long sequences

NEG_INF = -1e30
# the int8 cache's scale is absmax · fl(1/127): the reference runs its cache
# updates compiled, and XLA folds the division by the constant 127 into that
# product (as in kernels/ref.py::quantize_tiles_ref)
_INV_QMAX = 1.0 / 127.0


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
    scores = torch.where(valid, scores, NEG_INF)  # a scalar: no host-to-device copy
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


# ---------------------------------------------------------------------------
# KV cache (ring buffer, optionally int8-quantized)
# ---------------------------------------------------------------------------


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(batch, token, head) int8 quantization over hd."""
    xf = x.to(torch.float32)
    inv = torch.full((), _INV_QMAX, dtype=torch.float32, device=x.device)  # fl(1/127)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) * inv, 1e-8)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(cache: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Read k/v back to compute dtype (a cast for unquantized caches)."""
    arr = cache[name]
    if arr.dtype == torch.int8:
        return (arr.to(torch.float32) * cache[name + "_scale"]).to(dtype)
    return arr.to(dtype)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype: torch.dtype,
               device=None) -> dict:
    """An empty ring cache: zeros, every slot's position −1."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    shape = (batch, capacity, KV, hd)
    pos = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    if cfg.kv_cache_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, capacity, KV, 1), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, capacity, KV, 1), dtype=torch.float32, device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def fill_cache_from_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> dict:
    """Scatter the last ``capacity`` keys of a prefill into their ring slots (in place)."""
    cap = cache["k"].shape[1]
    keep = min(seq_len, cap)
    ps = torch.arange(seq_len - keep, seq_len, dtype=torch.int32, device=k.device)
    slots = (ps % cap).long()
    k_w, v_w = k[:, seq_len - keep:], v[:, seq_len - keep:]
    cache["pos"][slots] = ps
    if cache["k"].dtype == torch.int8:
        kq, ks = _quantize(k_w)
        vq, vs = _quantize(v_w)
        cache["k"][:, slots] = kq
        cache["v"][:, slots] = vq
        cache["k_scale"][:, slots] = ks
        cache["v_scale"][:, slots] = vs
    else:
        cache["k"][:, slots] = k_w.to(cache["k"].dtype)
        cache["v"][:, slots] = v_w.to(cache["v"].dtype)
    return cache


def cache_decode_update(cache: dict, k_t: torch.Tensor, v_t: torch.Tensor, pos: int) -> dict:
    """Write one token (k_t/v_t: (B, 1, KV, hd)) at ring slot pos % cap (in place)."""
    slot = pos % cache["k"].shape[1]
    cache["pos"][slot:slot + 1].fill_(pos)  # `[slot] = pos` would copy from the host
    if cache["k"].dtype == torch.int8:
        kq, ks = _quantize(k_t)
        vq, vs = _quantize(v_t)
        cache["k"][:, slot:slot + 1] = kq
        cache["v"][:, slot:slot + 1] = vq
        cache["k_scale"][:, slot:slot + 1] = ks
        cache["v_scale"][:, slot:slot + 1] = vs
    else:
        cache["k"][:, slot:slot + 1] = k_t.to(cache["k"].dtype)
        cache["v"][:, slot:slot + 1] = v_t.to(cache["v"].dtype)
    return cache


# ---------------------------------------------------------------------------
# full attention layer (projections + rope + cache + attention + out-proj)
# ---------------------------------------------------------------------------


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
    cache: Optional[dict] = None,
    decode_pos: Optional[int] = None,
    build_cache: bool = False,
    cache_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention layer.

    Modes:
      * train/feature: ``cache=None, build_cache=False`` -> (y, None), plain
        attention;
      * prefill: ``build_cache=True`` -> (y, filled cache), the attention
        through ``ops.flash_attention``;
      * decode: ``cache`` set, x is (B, 1, d), ``decode_pos`` the token's
        absolute position -> (y, the cache updated in place).
    """
    B, S, _ = x.shape
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

    if cache is not None:  # decode: one new token against the ring buffer
        if S != 1 or decode_pos is None:
            raise ValueError(f"decode takes one token and its position, got S={S}, "
                             f"decode_pos={decode_pos}")
        cache = cache_decode_update(cache, k, v, decode_pos)
        q_pos = torch.full((1,), decode_pos, dtype=torch.int32, device=x.device)
        y = multihead_attention(
            q, dequantize_kv(cache, "k", x.dtype), dequantize_kv(cache, "v", x.dtype),
            q_pos, cache["pos"], window=window, bidirectional=False,
        )
    elif build_cache:  # prefill
        if bidirectional:
            raise ValueError("prefill is causal")
        y = ops.flash_attention(q, k, v, causal=True, window=window)
        cap = cache_capacity or (window if window else S)
        cache = fill_cache_from_prefill(init_cache(cfg, B, cap, k.dtype, x.device), k, v, S)
    else:
        pos = torch.arange(S, device=x.device)
        y = multihead_attention(q, k, v, pos, pos, window=window, bidirectional=bidirectional)

    H, hd, d = p["wo"].shape
    return y.reshape(*y.shape[:2], H * hd) @ p["wo"].to(x.dtype).reshape(H * hd, d), cache
