"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared experts.

The port of the reference's ``models/moe.py`` for its two MoE families:

* DeepSeekMoE 16B — 64 fine-grained routed experts, top-6, 2 shared experts
  (arXiv:2401.06066);
* Llama-4 Scout — 16 experts, top-1, 1 shared expert.

Parameters, with the reference's names and layouts: ``router`` (d, E),
``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d), and ``shared``, the S
shared SwiGLU experts fused into one MLP of hidden width S·f (the sum of S
SwiGLU experts is one SwiGLU with the gate/up matrices concatenated on the
hidden axis and the down matrices stacked: exact).

:func:`moe_apply` computes what the reference computes, drops included:

* routing in fp32 over a bf16 product; the top k taken by a stable
  descending sort, so tied probabilities come out lower expert first, as
  ``jax.lax.top_k`` returns them (``torch.topk`` promises no order);
* the Switch load-balance loss E·Σ(mean prob × dispatch fraction), fp32;
* capacity positions: a prefix count over the flattened (token, choice)
  order, token-major with the k choices in top-k order; an entry past an
  expert's C slots is dropped (``keep`` 0);
* dispatch into an (E, C + 1, d) buffer by a non-accumulating
  ``index_put_``: kept (expert, slot) pairs are unique and every dropped
  entry lands in the extra slot C, which is sliced off.  The reference's
  scatter-add of ``x · keep`` into (E, C, d) adds only zero rows to a kept
  slot, so the buffers agree;
* three batched expert products, each weight cast to the activation dtype
  at its product; the combine gathers each entry's row, times ``keep`` and
  its top-k probability in the activation dtype, summed over the k choices;
  then the shared MLP.

Nothing here waits on the host (no ``nonzero``, boolean indexing or
``.item()``), so a decode step through MoE layers stays sync-free.  A
:class:`DropTally` passed down from the model's forward sums the dropped
entries on the device; reading it is the caller's one host sync.

Groups: the reference computes capacity positions within G token groups,
G the mesh's ``"data"`` axis size (1 without a mesh).  The port's model code
has no mesh, so G = 1 here, as in the reference without one; the
group-local form and expert parallelism wait for ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {
        "router": dense_init(gen, (d, E)),
        "w_gate": dense_init(gen, (E, d, f), in_axis=1),
        "w_up": dense_init(gen, (E, d, f), in_axis=1),
        "w_down": dense_init(gen, (E, f, d), in_axis=1),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = mlp_init(gen, cfg, d_ff=cfg.n_shared_experts * cfg.d_expert)
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens (a multiple of 8)."""
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def route_top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) router probabilities -> their k largest and the experts', (T, k)
    each; equal probabilities lower expert first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@dataclass
class DropTally:
    """The (token, choice) entries the capacity dropped, summed on the
    device over the :func:`moe_apply` calls given this tally, and the
    entries routed."""

    dropped: Optional[torch.Tensor] = None  # 0-dim int64 on the activations' device
    routed: int = 0

    def add(self, kept: torch.Tensor) -> None:
        n = kept.numel() - kept.sum()
        self.dropped = n if self.dropped is None else self.dropped + n
        self.routed += kept.numel()

    def share(self) -> float:
        """Dropped / routed; reads the device count (one host sync)."""
        return float(self.dropped) / self.routed if self.routed else 0.0


def moe_apply(
    cfg: ModelConfig, p: dict, x: torch.Tensor, drops: Optional[DropTally] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), the load-balance loss, fp32 scalar);
    ``drops`` sums the entries this call dropped."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)

    # routing (fp32)
    logits = (xf @ p["router"].to(dt)).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = route_top_k(probs, k)  # (T, k)
    idx = top_idx.reshape(T * k)  # token-major, choices in top-k order

    # capacity positions: entry i's position is the count of earlier
    # entries routed to its expert.  The one-hot is (E, T·k), so the prefix
    # count runs along the innermost dim (a scan along dim 0 of (T·k, E)
    # walks T·k rows serially)
    onehot = torch.zeros((E, T * k), dtype=torch.int32, device=x.device)
    onehot.scatter_(0, idx[None, :], 1)
    pos = onehot.cumsum(1).gather(0, idx[None, :])[0] - 1  # (T·k,)
    C = _capacity(cfg, T)
    kept = pos < C

    # load-balance loss (Switch/Gshard form)
    me = probs.mean(dim=0)
    dispatch_frac = onehot.reshape(E, T, k).sum(dim=2).to(torch.float32).mean(dim=1) / k
    aux = E * torch.sum(me * dispatch_frac)
    if drops is not None:
        drops.add(kept)

    # dispatch: kept entries to their (expert, slot), dropped ones to slot C
    buf = torch.zeros((E, C + 1, d), dtype=dt, device=x.device)
    slot = torch.where(kept, pos, C)
    buf.index_put_((idx.reshape(T, k), slot.reshape(T, k)), xf[:, None, :])
    buf = buf[:, :C]

    # the experts: three batched products over (E, C, ·)
    g = F.silu(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    h = torch.bmm(g * u, p["w_down"].to(dt))  # (E, C, d)
    del buf, g, u

    # combine: each entry's row (dropped ones read slot C − 1, times 0)
    y_rep = h[idx, pos.clamp(max=C - 1)] * kept.to(dt)[:, None]  # (T·k, d)
    w = top_p.reshape(T * k).to(dt)[:, None]
    y = (y_rep * w).reshape(T, k, d).sum(dim=1)

    if "shared" in p:
        y = y + mlp_apply(cfg.replace(mlp_type="swiglu"), p["shared"], xf)
    return y.reshape(B, S, d), aux
