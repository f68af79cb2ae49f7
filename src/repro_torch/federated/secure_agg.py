"""Secure aggregation of FED3R statistics (paper Appendix B), in PyTorch.

The port of the reference's ``federated/secure_agg.py``.  The server only
ever needs the SUM of the clients' (A_k, b_k), so Bonawitz et al.'s Secure
Aggregation applies directly.  This module implements the *masking algebra*
of that protocol (pairwise additive masks that cancel in the aggregate),
without the key-agreement crypto (the mask seeds are where X25519-derived
PRG seeds would plug in):

    client u sends  y_u = x_u + Σ_{v>u} m_{uv} − Σ_{v<u} m_{vu}
    Σ_u y_u = Σ_u x_u            (every mask appears with both signs)

Float masks (:func:`mask_statistics`) cancel to fp32 tolerance only.  A
QUANTIZED upload is an integer payload
(:func:`repro_torch.federated.compress.cohort_quantize_int8`), and there the
protocol-correct masking is integer masking mod 2³²: int32 masks uniform
over the ring cancel EXACTLY in the aggregate, bit for bit
(:func:`mask_quantized_payload` / :func:`secure_aggregate_quantized`).  The
ring arithmetic is explicit: sums are taken in int64 and wrapped back to
int32 (:func:`ring_add`, :func:`ring_sub`), so the result does not rest on
how a device's int32 addition overflows.

Masks come from a ``torch.Generator`` on the payload's device, seeded from
(seed, u, v) through numpy's ``SeedSequence``: the server re-derives the
orphaned masks of dropped clients from the same seeds
(:func:`recover_survivor_sum` / :func:`recover_survivor_sum_quantized`,
Bonawitz et al.'s unmasking round).  The masks are the port's own: the
reference's ``jax.random`` bits cannot be reproduced in PyTorch, and the
protocol needs only that both ends derive the same mask.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from repro_torch.core.fed3r import Fed3RStats

_FLOAT_MASK, _INT_MASK = 0, 1  # domain tags: the two mask kinds never share a stream
_RING = 2**32


def _map(fn: Callable[..., torch.Tensor], *trees: Any) -> Any:
    """Apply ``fn`` leaf-wise over tensors or NamedTuples/tuples of tensors."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    leaves = [fn(*xs) for xs in zip(*trees)]
    return first._make(leaves) if hasattr(first, "_make") else type(first)(leaves)


def _leaves(tree: Any) -> List[torch.Tensor]:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor folded onto the int32 ring (two's complement)."""
    return (torch.remainder(x + 2**31, _RING) - 2**31).to(torch.int32)


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2³² on int32 tensors, on any device."""
    return _wrap32(a.to(torch.int64) + b.to(torch.int64))


def ring_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a − b mod 2³² on int32 tensors, on any device."""
    return _wrap32(a.to(torch.int64) - b.to(torch.int64))


def _generator(seed: int, u: int, v: int, kind: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, kind, u, v]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[1]) << 32) | int(state[0]))
    return gen


def _pair_mask(seed: int, u: int, v: int, like: Any) -> Any:
    """Deterministic pairwise float mask m_{uv} (u < v), shaped like ``like``:
    N(0, 10²) entries."""
    leaves = _leaves(like)
    gen = _generator(seed, u, v, _FLOAT_MASK, leaves[0].device)
    return _map(lambda x: torch.randn(x.shape, generator=gen, dtype=torch.float32,
                                      device=x.device) * 10.0, like)


def _pair_mask_int(seed: int, u: int, v: int, like: Any) -> Any:
    """Deterministic pairwise int32 mask m_{uv} (u < v), uniform over the
    whole mod-2³² ring: int64 draws in [0, 2³²) wrapped to int32."""
    leaves = _leaves(like)
    gen = _generator(seed, u, v, _INT_MASK, leaves[0].device)

    def draw(x: torch.Tensor) -> torch.Tensor:
        return _wrap32(torch.randint(0, _RING, x.shape, generator=gen, dtype=torch.int64,
                                     device=x.device))

    return _map(draw, like)


def _check_int32(tree: Any, what: str) -> None:
    dtypes = [leaf.dtype for leaf in _leaves(tree)]
    if any(dt != torch.int32 for dt in dtypes):
        raise TypeError(
            f"{what} takes int32 payloads (see repro_torch.federated.compress."
            f"cohort_quantize_int8); got dtypes {[str(dt) for dt in dtypes]}"
        )


def mask_statistics(
    stats: Fed3RStats, client_id: int, cohort: Sequence[int], seed: int
) -> Fed3RStats:
    """Apply the pairwise float masking a client performs before upload."""
    out = stats
    for v in cohort:
        if v == client_id:
            continue
        u, w = sorted((client_id, v))
        m = _pair_mask(seed, u, w, stats)
        sign = 1.0 if client_id == u else -1.0
        out = _map(lambda a, b: a + sign * b, out, m)
    return out


def secure_aggregate(masked: List[Fed3RStats]) -> Fed3RStats:
    """Server-side sum of float-masked uploads: the masks cancel to fp32
    tolerance."""
    total = masked[0]
    for s in masked[1:]:
        total = _map(operator.add, total, s)
    return total


def mask_quantized_payload(payload: Any, client_id: int, cohort: Sequence[int], seed: int) -> Any:
    """Pairwise integer masking of a quantized upload (int32 leaves), in the
    mod-2³² ring: the aggregate cancellation is EXACT."""
    _check_int32(payload, "mask_quantized_payload")
    out = payload
    for v in cohort:
        if v == client_id:
            continue
        u, w = sorted((client_id, v))
        m = _pair_mask_int(seed, u, w, payload)
        out = _map(ring_add if client_id == u else ring_sub, out, m)
    return out


def secure_aggregate_quantized(masked: List[Any]) -> Any:
    """Mod-2³² sum of masked integer payloads: the masks cancel bit-exactly.

    The true cohort sum of int8-valued entries is far inside int32 range,
    so once the masks cancel the wrapped sum IS the plain integer sum;
    dequantize it with the cohort's shared scales
    (:func:`repro_torch.federated.compress.dequantize_int_sum`).
    """
    total = masked[0]
    for p in masked[1:]:
        total = _map(ring_add, total, p)
    return total


# ---------------------------------------------------------------------------
# Timeout-tolerant dropout recovery (Bonawitz et al. §unmasking round)
# ---------------------------------------------------------------------------
#
# When client j times out AFTER the cohort masked its uploads against j, the
# sum over the survivors S retains every pairwise mask with exactly one
# endpoint in S and the other among the dropped D:
#
#     Σ_{u∈S} y_u = Σ_{u∈S} x_u + Σ_{u∈S, j∈D} sign(u, j)·m_{uj}
#
# The survivors reveal their pairwise seeds with the dropped clients, and the
# server re-derives and subtracts that orphan total.  In the mod-2³² ring the
# subtraction cancels BIT-EXACTLY; in float to fp32 tolerance only.


def _orphan_total(
    survivors: Sequence[int], dropped: Sequence[int], seed: int, like: Any, mask_fn, add, sub
) -> Any:
    """Σ over survivor–dropped pairs of the signed orphaned masks."""
    total = _map(torch.zeros_like, like)
    for u in survivors:
        for j in dropped:
            a, c = sorted((int(u), int(j)))
            m = mask_fn(seed, a, c, like)
            total = _map(add if u == a else sub, total, m)
    return total


def _check_disjoint(survivors: Sequence[int], dropped: Sequence[int]) -> None:
    if set(survivors) & set(dropped):
        raise ValueError("survivors and dropped must be disjoint")


def dropout_mask_correction(
    survivors: Sequence[int], dropped: Sequence[int], seed: int, like: Fed3RStats
) -> Fed3RStats:
    """Float orphan-mask total stuck in the survivors' masked sum."""
    _check_disjoint(survivors, dropped)
    return _orphan_total(survivors, dropped, seed, like, _pair_mask, operator.add, operator.sub)


def recover_survivor_sum(
    masked_sum: Fed3RStats, survivors: Sequence[int], dropped: Sequence[int], seed: int
) -> Fed3RStats:
    """Survivor aggregate after dropout: masked sum minus the orphan total
    (fp32 tolerance; use the quantized variant for bit-exactness)."""
    corr = dropout_mask_correction(survivors, dropped, seed, masked_sum)
    return _map(operator.sub, masked_sum, corr)


def dropout_mask_correction_quantized(
    survivors: Sequence[int], dropped: Sequence[int], seed: int, like: Any
) -> Any:
    """Integer orphan-mask total (int32 leaves, mod-2³² arithmetic)."""
    _check_disjoint(survivors, dropped)
    _check_int32(like, "dropout_mask_correction_quantized")
    return _orphan_total(survivors, dropped, seed, like, _pair_mask_int, ring_add, ring_sub)


def recover_survivor_sum_quantized(
    masked_sum: Any, survivors: Sequence[int], dropped: Sequence[int], seed: int
) -> Any:
    """Survivor aggregate after dropout in the mod-2³² ring — BIT-EXACT for
    any 1..K−1 dropped clients."""
    corr = dropout_mask_correction_quantized(survivors, dropped, seed, masked_sum)
    return _map(ring_sub, masked_sum, corr)
