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

Groups: capacity positions are group-local, as in the reference: G token
groups, G the ambient mesh's ``"data"`` axis size (1 without a mesh),
halved while it does not divide the global token count; each group holds
Cg = max(8, ⌈C/G⌉) slots an expert, C taken from the global token count.
The groups are token-major, and a data rank's batch rows are its group, so
a rank counts positions over its own tokens only; where a group spans r
data ranks (the multi-pod mesh: G = 16 over 32 ranks), a rank's positions
start after the group's earlier ranks' counts, which it gathers (an (r·…,
E) count table over the data axes).  Under a ``"model"``
axis the experts are expert-parallel on the E axis (a rank dispatches to
and runs only its block of experts; where E does not divide, every rank
runs every expert on its slice of the hidden axis), the shared expert is
the MLP's column/row split, and y is all-reduced once over ``"model"``;
routing runs whole on every rank.  The load-balance loss averages the
router statistics over the data ranks, and :meth:`DropTally.share` sums
its counts over them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init
from repro_torch.sharding import hints


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
    mesh: Any = None  # the ambient mesh of the calls counted: shares sum its data ranks

    def add(self, kept: torch.Tensor) -> None:
        n = kept.numel() - kept.sum()
        self.dropped = n if self.dropped is None else self.dropped + n
        self.routed += kept.numel()
        self.mesh = hints.get_mesh()

    def share(self) -> float:
        """Dropped / routed, summed over the data ranks of the mesh the
        counts were taken under; reads the device count (one host sync)."""
        if not self.routed:
            return 0.0
        counts = torch.stack([self.dropped.to(torch.float64),
                              torch.full_like(self.dropped, self.routed, dtype=torch.float64)])
        dropped, routed = hints.reduce_data(counts, self.mesh).tolist()
        return dropped / routed


def moe_groups(n_tokens: int) -> Tuple[int, int]:
    """(G, the global token count) for a rank's ``n_tokens``: G the ambient
    "data" axis size, halved while it does not divide the global count (as
    the reference does); the global count is ``n_tokens`` times the data
    shards.  A group holds the tokens of one or more whole data ranks: the
    "data" axis size divides the data shards (its product with "pod"), so
    it divides the global count, the halving never runs, and every group
    is whole ranks."""
    dp = hints.data_shards()
    G = max(hints.mesh_axis_size("data"), 1)
    total = n_tokens * dp
    while total % G:
        G //= 2
    G = max(G, 1)
    assert dp % G == 0, (f"MoE capacity groups of {G} over {dp} data shards: the \"data\" axis "
                         f"divides the data shards, so a group is whole ranks")
    return G, total


def _group_offset(counts: torch.Tensor, G: int) -> Optional[torch.Tensor]:
    """(E,) the entries routed to each expert by the earlier data ranks of
    this rank's capacity group (None where a group is one rank): the ranks'
    ``counts`` gathered over the data axes, row-major."""
    dp = hints.data_shards()
    if G == dp:
        return None
    table = hints.gather_counts(counts)  # (dp, E)
    _, i = hints.data_block()
    return table[i - i % (dp // G):i].sum(dim=0)


def _expert_layout(cfg: ModelConfig) -> Tuple[str, int]:
    """("experts" | "hidden" | "full", the rank's first expert): how the
    routed experts are split under the ambient "model" axis."""
    if hints.model_size() == 1:
        return "full", 0
    spec = hints.layout("moe/w_gate", (cfg.n_experts, cfg.d_model, cfg.d_expert))
    if spec[0] == "model":
        return "experts", hints.model_rank() * (cfg.n_experts // hints.model_size())
    return ("hidden" if spec[2] == "model" else "full"), 0


def moe_apply(
    cfg: ModelConfig, p: dict, x: torch.Tensor, drops: Optional[DropTally] = None,
    reduce: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), the load-balance loss, fp32 scalar);
    ``drops`` sums the entries this call dropped.  Under a "model" axis,
    ``reduce=False`` returns the rank's partial sum of y (``hints.finish``)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)
    G, T_all = moe_groups(T)
    layout, e0 = _expert_layout(cfg)
    E_local = p["w_gate"].shape[0]

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
    offset = _group_offset(onehot.sum(dim=1), G)
    if offset is not None:  # after the group's earlier ranks' entries
        pos = pos + offset[idx]
    C = max(8, -(-_capacity(cfg, T_all) // G))  # a group's slots an expert
    kept = pos < C

    # load-balance loss (Switch/Gshard form), over every data rank's tokens
    me = probs.mean(dim=0)
    dispatch_frac = onehot.reshape(E, T, k).sum(dim=2).to(torch.float32).mean(dim=1) / k
    dp = hints.data_shards()
    if dp > 1:  # equal token counts a rank: the global means are the ranks' mean
        stats = hints.reduce_data(torch.stack([me, dispatch_frac])) / dp
        me, dispatch_frac = stats[0], stats[1]
    aux = E * torch.sum(me * dispatch_frac)
    if drops is not None:
        drops.add(kept)

    # dispatch: kept entries to their (expert, slot), dropped ones to slot C;
    # under expert parallelism another rank's entries land in slot C too
    here = kept
    eidx = idx
    if layout == "experts":
        eidx = idx - e0
        mine = (eidx >= 0) & (eidx < E_local)
        here = kept & mine
        eidx = torch.where(mine, eidx, 0)
    buf = torch.zeros((E_local, C + 1, d), dtype=dt, device=x.device)
    slot = torch.where(here, pos, C)
    buf.index_put_((eidx.reshape(T, k), slot.reshape(T, k)), xf[:, None, :])
    buf = buf[:, :C]

    # the experts: three batched products over (E, C, ·)
    g = F.silu(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    h = torch.bmm(g * u, p["w_down"].to(dt))  # (E, C, d)
    del buf, g, u

    # combine: each entry's row (dropped ones read slot C − 1, times 0)
    y_rep = h[eidx, pos.clamp(max=C - 1)] * here.to(dt)[:, None]  # (T·k, d)
    w = top_p.reshape(T * k).to(dt)[:, None]
    y = (y_rep * w).reshape(T, k, d).sum(dim=1)

    shared_cfg = cfg.replace(mlp_type="swiglu", d_ff=cfg.n_shared_experts * cfg.d_expert)
    # one all-reduce of the routed and shared partial sums (none without a model axis)
    y = hints.finish(y, partial=layout != "full", reduce=False)
    if "shared" in p:
        y = y + mlp_apply(shared_cfg, p["shared"], xf, reduce=False)
    return hints.finish(y, partial=True, reduce=reduce).reshape(B, S, d), aux
