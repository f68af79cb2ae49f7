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
  the keys and values fill a KV ring cache; an encoder's bidirectional
  prefill goes through the kernel with causal off and keeps no cache
  (the reference runs its encoder through the plain attention even in a
  prefill);
* decode: one query against the ring buffer (``k_pos`` −1 on empty slots)
  through the plain attention, as in the reference.

:func:`cross_attn_apply` is Whisper's decoder-over-encoder attention: the
plain bidirectional attention of Sq decoder tokens over the encoder's
frames (the kernel takes Sq = Sk only), its k and v projected from the
encoder states once, in the prefill, and read from the cache in decode.

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

Under an ambient mesh with a ``"model"`` axis larger than 1
(:mod:`repro_torch.sharding.hints`), each rank holds its block of the
projections in the layout ``param_specs`` picks (:func:`tp_layout`): q, k
and v column-parallel over their head axes, or row-parallel over d_model
where the heads do not divide (the rank's slice of x times its rows, then
an all-reduce, and the rank's q heads read their own kv heads, in runs of
uniform group size where the rank's q heads and the kv group do not
divide one another: :func:`kv_runs`); ``wo`` row-parallel over the heads
(one all-reduce), or split over d_model where the heads do not divide.
The prefill runs the kernel on the rank's heads, once a run.
The KV cache is laid out as ``cache_specs`` lays it out
(:func:`cache_block`): the rank's kv heads; or, where the kv heads do not
divide and the slots do, the rank's contiguous block of the slots with
every kv head (the sequence layout, context-parallel: the prefill and
decode write only the slots a rank owns, every rank keeps every slot's
position, and decode gathers q's heads, attends them over the rank's
slots and combines the ranks' softmax pieces in fp32, :func:`_cp_combine`);
or all of it where the rules replicate it.  Whisper's cross-attention
(k, v) follow the same rule over the encoder's frames: where they split, a
rank attends its frames with every q head and the ranks' pieces combine
as the ring's do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.sharding import hints
from repro_torch.sharding.specs import kv_cache_layout

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


def _valid(q_pos, k_pos, window, bidirectional) -> torch.Tensor:
    """(Sq, Sk) bool: the key slots each query attends (−1: an empty slot)."""
    valid = k_pos[None, :] >= 0  # (1, Sk)
    if not bidirectional:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    return valid


def _scores_softmax_values(q, k, v, q_pos, k_pos, window, bidirectional):
    """Exact attention for one q block against a key range.

    q: (B, Sq, KV, G, hd)   k/v: (B, Sk, KV, hd)
    q_pos: (Sq,) int        k_pos: (Sk,) int (−1 = empty slot)
    returns (B, Sq, KV, G, hd)
    """
    hd = q.shape[-1]
    # the scale rounded to q's dtype first, as JAX multiplies by a weakly
    # typed Python scalar (a Python scalar: no host-to-device copy)
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale  # (B,KV,G,Sq,Sk)
    scores = scores.to(torch.float32)
    valid = _valid(q_pos, k_pos, window, bidirectional)
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
    Returns (B, Sq, H, hd).  Queries that run chunk by chunk sit at
    ``q_pos == arange(Sq)``, as every caller builds them: a windowed chunk's
    key range starts from the chunk's offset, a Python int (reading it off
    ``q_pos`` on the card would block the host once a chunk).
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
            start = min(max(s0 - (window - 1), 0), Sk - slice_len)
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


def cache_block(cfg: ModelConfig, batch: int, capacity: int) -> Tuple[int, int]:
    """(slots, kv heads) of a rank's ring of ``capacity`` slots for its
    ``batch`` rows: all of both without a "model" axis, else as
    ``cache_specs`` lays the cache out: the rank's kv heads, its block of
    the slots (the sequence layout), or all of both where it replicates."""
    m = hints.model_size()
    if m == 1:
        return capacity, cfg.n_kv_heads
    layout = kv_cache_layout(batch * hints.data_shards(), capacity, cfg.n_kv_heads, cfg.hd,
                             hints.data_axes(), hints.axis_sizes())
    if layout == "heads":
        return capacity, cfg.n_kv_heads // m
    if layout == "sequence":
        return capacity // m, cfg.n_kv_heads
    return capacity, cfg.n_kv_heads


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype: torch.dtype,
               device=None) -> dict:
    """An empty ring cache: zeros, every slot's position −1 (under a "model"
    axis, the rank's block of k and v: :func:`cache_block`; the positions
    of every slot)."""
    slots, KV = cache_block(cfg, batch, capacity)
    shape = (batch, slots, KV, cfg.hd)
    pos = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    if cfg.kv_cache_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, slots, KV, 1), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, slots, KV, 1), dtype=torch.float32, device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def slot_range(cache: dict) -> Tuple[int, int]:
    """[lo, hi): the ring slots whose k and v this rank's cache holds (every
    slot but in the sequence layout)."""
    n, cap = cache["k"].shape[1], cache["pos"].shape[0]
    if n == cap:
        return 0, cap
    lo = hints.model_rank() * n
    return lo, lo + n


def _ring_runs(first: int, n: int, cap: int, lo: int, hi: int):
    """Positions first .. first + n − 1 (n <= cap) land in ring slots p % cap:
    the (slot j0, slot j1, position of j0) runs of them inside [lo, hi)."""
    s = first % cap
    head = min(n, cap - s)
    runs = []
    for slot0, p0, length in ((s, first, head), (0, first + head, n - head)):
        j0, j1 = max(slot0, lo), min(slot0 + length, hi)
        if length > 0 and j0 < j1:
            runs.append((j0, j1, p0 + j0 - slot0))
    return runs


def _write(cache: dict, start: int, k_w: torch.Tensor, v_w: torch.Tensor) -> None:
    """k_w/v_w (B, n, KV, hd) into the cache's slots start .. start + n − 1."""
    end = start + k_w.shape[1]
    if cache["k"].dtype == torch.int8:
        kq, ks = _quantize(k_w)
        vq, vs = _quantize(v_w)
        cache["k"][:, start:end] = kq
        cache["v"][:, start:end] = vq
        cache["k_scale"][:, start:end] = ks
        cache["v_scale"][:, start:end] = vs
    else:
        cache["k"][:, start:end] = k_w.to(cache["k"].dtype)
        cache["v"][:, start:end] = v_w.to(cache["v"].dtype)


def fill_cache_from_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> dict:
    """Write the last ``capacity`` keys of a prefill into their ring slots (in
    place, as contiguous runs at Python-int slices); in the sequence layout,
    the keys of the rank's slots only."""
    cap = cache["pos"].shape[0]
    keep = min(seq_len, cap)
    ps = torch.arange(seq_len - keep, seq_len, dtype=torch.int32, device=k.device)
    slots = (ps % cap).long()
    cache["pos"][slots] = ps
    lo, hi = slot_range(cache)
    for j0, j1, p0 in _ring_runs(seq_len - keep, keep, cap, lo, hi):
        _write(cache, j0 - lo, k[:, p0:p0 + j1 - j0], v[:, p0:p0 + j1 - j0])
    return cache


def cache_decode_update(cache: dict, k_t: torch.Tensor, v_t: torch.Tensor, pos: int) -> dict:
    """Write one token (k_t/v_t: (B, 1, KV, hd)) at ring slot pos % cap (in
    place); in the sequence layout only the rank that owns the slot writes
    k and v, and every rank its position."""
    slot = pos % cache["pos"].shape[0]
    cache["pos"][slot:slot + 1].fill_(pos)  # `[slot] = pos` would copy from the host
    lo, hi = slot_range(cache)
    if lo <= slot < hi:
        _write(cache, slot - lo, k_t, v_t)
    return cache


def _cp_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """softmax · v over every rank's keys from each rank's pieces over its
    own: ``m`` its rows' max score, ``l`` the sum of exp(s − m) and ``o`` of
    exp(s − m)·v (fp32, (..., 1), (..., 1), (..., hd)).  Each rank's pieces
    are rescaled by exp(m − the ranks' max), then l and o are summed in one
    all-reduce.  A rank whose slots are all empty has m = −1e30 and l = o =
    0, and a rank whose keys all score far below the max a scale that
    underflows to 0: it adds nothing, no NaN.  ``m`` is a constant shift
    (no gradient: the result does not depend on it); the sum's backward is
    the same all-reduce."""
    c = torch.exp(m - hints.max_model(m))
    lo = hints.reduce_model(torch.cat([l * c, o * c], dim=-1))
    return lo[..., 1:] / lo[..., :1]


def _context_parallel(tp: "TPLayout", q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention over keys split over "model" (a sequence-sharded ring's
    slots, or the encoder's frames): q's heads gathered over "model", every
    head attends the rank's keys ``k``/``v`` (B, Sk_r, KV, hd) in fp32
    (``valid``, (Sq, Sk_r) or None for every key: the masks of
    :func:`_valid`), the ranks' pieces combined (:func:`_cp_combine`), and
    the rank's heads of the result kept for its ``wo``."""
    dtype = q.dtype
    if tp.q == "heads":
        q = hints.gather_model(q, 2)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scale = torch.tensor(hd ** -0.5, dtype=dtype).item()
    s = (torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(dtype)) * scale).to(torch.float32)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.detach().amax(dim=-1, keepdim=True)  # (B, KV, G, Sq, 1)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.to(torch.float32))
    y = _cp_combine(m, p.sum(dim=-1, keepdim=True), o)  # (B, KV, G, Sq, hd)
    y = y.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(dtype)
    return hints.model_block(y, 2) if tp.q == "heads" else y


def _context_parallel_decode(tp: "TPLayout", q: torch.Tensor, cache: dict, q_pos: torch.Tensor,
                             window: Optional[int]) -> torch.Tensor:
    """Decode attention over a sequence-sharded ring: :func:`_context_parallel`
    over the rank's slots, with the masks of their positions."""
    lo, hi = slot_range(cache)
    k, v = dequantize_kv(cache, "k", q.dtype), dequantize_kv(cache, "v", q.dtype)
    return _context_parallel(tp, q, k, v, _valid(q_pos, cache["pos"][lo:hi], window, False))


# ---------------------------------------------------------------------------
# full attention layer (projections + rope + cache + attention + out-proj)
# ---------------------------------------------------------------------------


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") with the fp32 weight cast to x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p: dict, x: torch.Tensor) -> torch.Tensor:
    q = _project(x, p["wq"])
    return q + p["bq"].to(x.dtype) if "bq" in p else q


def _project_kv(p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    k, v = _project(x, p["wk"]), _project(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"].to(x.dtype), v + p["bv"].to(x.dtype)
    return k, v


def _out_project(p: dict, y: torch.Tensor) -> torch.Tensor:
    H, hd, d = p["wo"].shape
    return y.reshape(*y.shape[:2], H * hd) @ p["wo"].to(y.dtype).reshape(H * hd, d)


class TPLayout(NamedTuple):
    """How a rank's attention runs under a "model" axis: each projection
    ``"heads"`` (split over its head axis), ``"rows"`` (over d_model: a
    partial sum) or ``"full"`` (replicated); ``wo`` ``"heads"``, ``"cols"``
    (its d_model outputs split) or ``"full"``; ``kv_runs`` how the rank's
    q heads read the kv heads it holds (None: q and kv as they are): runs
    of (q heads, kv heads) slices, each a uniform GQA group size, the q
    heads of a run in order (:func:`kv_runs`)."""

    q: str
    kv: str
    o: str
    kv_runs: Optional[Tuple[Tuple[slice, slice], ...]]


def kv_runs(H: int, KV: int, m: int, r: int) -> Tuple[Tuple[slice, slice], ...]:
    """Model rank ``r`` of ``m`` holds q heads h0 … h0 + H/m − 1 (h0 =
    r·H/m) and every kv head: its q head h reads kv head h // G (G = H/KV).
    Returns runs of (its q heads, the kv heads they read) in which every
    kv head serves the same number of q heads, so that each run is one
    uniform GQA call.  Where H/m and G divide one another that is one run
    (the rank's whole groups, or its part of one group); else a kv head
    that the rank shares with a neighbour starts or ends a run of its own
    (12 q / 3 kv heads at "model" 2: rank 0 reads kv 0 four times, then kv
    1 twice)."""
    Hl, G = H // m, H // KV
    h0 = r * Hl
    reads: list = []  # [kv head, q heads reading it]
    for h in range(h0, h0 + Hl):
        if reads and reads[-1][0] == h // G:
            reads[-1][1] += 1
        else:
            reads.append([h // G, 1])
    runs: list = []  # [first q, first kv, end kv, q heads a kv head]
    q0 = 0
    for j, n in reads:
        if runs and runs[-1][3] == n:
            runs[-1][2] = j + 1
        else:
            runs.append([q0, j, j + 1, n])
        q0 += n
    return tuple((slice(q, q + (k1 - k0) * n), slice(k0, k1)) for q, k0, k1, n in runs)


def tp_layout(cfg: ModelConfig) -> Optional[TPLayout]:
    """The rank's attention layout under the ambient mesh (None without a
    "model" axis), from the rules of ``param_specs``."""
    m = hints.model_size()
    if m == 1:
        return None
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def proj(name, heads):
        spec = hints.layout(f"attn/{name}", (d, heads, hd))
        return "heads" if spec[1] == "model" else "rows" if spec[0] == "model" else "full"

    q, kv = proj("wq", H), proj("wk", KV)
    wo = hints.layout("attn/wo", (H, hd, d))
    o = "heads" if wo[0] == "model" else "cols" if wo[2] == "model" else "full"
    runs = None
    if q == "heads" and kv != "heads":  # every kv head here: its q heads read their own
        runs = kv_runs(H, KV, m, hints.model_rank())
    return TPLayout(q, kv, o, runs)


def _by_runs(tp: Optional[TPLayout], attend, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """``attend(q, k, v)`` (a GQA attention, (B, S, heads, hd) each) of the
    rank's q heads over the kv heads they read: one call a run of
    :attr:`TPLayout.kv_runs`, concatenated over the heads (``attend`` of
    q, k and v as they are without runs)."""
    if tp is None or tp.kv_runs is None:
        return attend(q, k, v)
    ys = [attend(q if len(tp.kv_runs) == 1 else q[:, :, qs].contiguous(),
                 k[:, :, ks].contiguous(), v[:, :, ks].contiguous())
          for qs, ks in tp.kv_runs]
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=2)


def _tp_project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], mode: str
                ) -> torch.Tensor:
    """A projection in ``mode``: a row-parallel one takes the rank's slice
    of x's d_model and all-reduces its partial product (then the replicated
    bias); otherwise the rank's (or every) head of it."""
    if mode == "rows":
        dl = w.shape[0]
        r = hints.model_rank()
        y = hints.reduce_model(_project(x[..., r * dl:(r + 1) * dl], w))
    else:
        y = _project(x, w)
    return y if b is None else y + b.to(x.dtype)


def _tp_out(tp: TPLayout, p: dict, y: torch.Tensor, reduce: bool) -> torch.Tensor:
    out = _out_project(p, y)
    if tp.o == "cols":  # this rank's d_model outputs, the others' zero in its sum
        return hints.finish(hints.pad_block(out, -1), partial=True, reduce=reduce)
    return hints.finish(out, partial=tp.o == "heads", reduce=reduce)


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
    reduce: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention layer.

    Modes:
      * train/feature: ``cache=None, build_cache=False`` -> (y, None), plain
        attention;
      * prefill: ``build_cache=True`` -> (y, filled cache), the attention
        through ``ops.flash_attention``; with ``bidirectional`` (an
        encoder's prefill) -> (y, None), the kernel with causal off;
      * decode: ``cache`` set, x is (B, 1, d), ``decode_pos`` the token's
        absolute position -> (y, the cache updated in place).

    Under a "model" axis, ``reduce=False`` returns the rank's partial sum
    of y (``hints.finish``) for a block that all-reduces several at once.
    """
    B, S, _ = x.shape
    tp = tp_layout(cfg)
    if tp is None:
        q = _project_q(p, x)
        k, v = _project_kv(p, x)
    else:
        q = _tp_project(x, p["wq"], p.get("bq"), tp.q)
        k = _tp_project(x, p["wk"], p.get("bk"), tp.kv)
        v = _tp_project(x, p["wv"], p.get("bv"), tp.kv)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)

    if cache is not None:  # decode: one new token against the ring buffer
        if S != 1 or decode_pos is None:
            raise ValueError(f"decode takes one token and its position, got S={S}, "
                             f"decode_pos={decode_pos}")
        cache = cache_decode_update(cache, k, v, decode_pos)
        q_pos = torch.full((1,), decode_pos, dtype=torch.int32, device=x.device)
        lo, hi = slot_range(cache)
        if hi - lo < cache["pos"].shape[0]:  # the sequence layout: context-parallel
            y = _context_parallel_decode(tp, q, cache, q_pos, window)
        else:
            y = _by_runs(tp, lambda q_, k_, v_: multihead_attention(
                q_, k_, v_, q_pos, cache["pos"], window=window, bidirectional=False),
                q, dequantize_kv(cache, "k", x.dtype), dequantize_kv(cache, "v", x.dtype))
    elif build_cache:  # prefill
        y = _by_runs(tp, lambda q_, k_, v_: ops.flash_attention(
            q_, k_, v_, causal=not bidirectional, window=window), q, k, v)
        if not bidirectional:  # an encoder's keys serve this pass only
            cap = cache_capacity or (window if window else S)
            cache = fill_cache_from_prefill(init_cache(cfg, B, cap, k.dtype, x.device), k, v, S)
    else:
        pos = torch.arange(S, device=x.device)
        y = _by_runs(tp, lambda q_, k_, v_: multihead_attention(
            q_, k_, v_, pos, pos, window=window, bidirectional=bidirectional), q, k, v)
    if tp is None:
        return _out_project(p, y), cache
    return _tp_out(tp, p, y, reduce), cache


def cross_attn_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    enc_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Encoder-decoder cross-attention (Whisper): x (B, Sq, d) over the
    encoder's frames, bidirectional, through the plain attention.

    Either ``enc_states`` (B, F, d) (the first pass: k and v projected with
    their biases, and returned for the cache) or ``enc_kv``, the cached
    (k, v) (B, F, KV, hd), read as they are.  Returns (y, (k, v)).  Under a
    "model" axis it runs in :func:`tp_layout`'s layout, as the
    self-attention does, and the (k, v) are the rank's block of them as
    ``cache_specs`` lays the cache out (:func:`cache_block` over the
    encoder's frames): its kv heads; its block of the frames (projected
    whole where k and v are row-parallel, then cut), over which every q
    head attends and the ranks' pieces combine (:func:`_context_parallel`);
    or all of both.
    """
    tp = tp_layout(cfg)
    if enc_kv is None:
        if enc_states is None:
            raise ValueError("cross-attention needs enc_states or the cached enc_kv")
        if tp is None:
            enc_kv = _project_kv(p, enc_states)
        else:
            k = _tp_project(enc_states, p["wk"], p.get("bk"), tp.kv)
            v = _tp_project(enc_states, p["wv"], p.get("bv"), tp.kv)
            frames, _ = cache_block(cfg, enc_states.shape[0], cfg.n_audio_frames)
            if frames != k.shape[1]:  # the rank's frames, a copy of their own for the cache
                k, v = hints.model_block(k, 1).clone(), hints.model_block(v, 1).clone()
            enc_kv = (k, v)
    k, v = enc_kv
    q = _project_q(p, x) if tp is None else _tp_project(x, p["wq"], p.get("bq"), tp.q)
    if tp is not None and k.shape[1] != cfg.n_audio_frames:  # the frames split over "model"
        return _tp_out(tp, p, _context_parallel(tp, q, k, v, None), True), enc_kv
    q_pos = torch.arange(x.shape[1], device=x.device)
    k_pos = torch.arange(k.shape[1], device=x.device)
    y = _by_runs(tp, lambda q_, k_, v_: multihead_attention(
        q_, k_.to(x.dtype), v_.to(x.dtype), q_pos, k_pos, bidirectional=True), q, k, v)
    if tp is None:
        return _out_project(p, y), enc_kv
    return _tp_out(tp, p, y, True), enc_kv
