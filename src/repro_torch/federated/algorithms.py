"""Gradient-based FL algorithms as pure state transitions, in PyTorch.

The port of the reference's ``federated/algorithms.py``.  FedAvg, FedAvgM,
FedProx, Scaffold, FedAdam and FedYogi share one pure ``local_update``
(built by :func:`make_local_update`):

* local SGD over padded client batches (padding batches are exact no-ops);
* optional proximal term (FedProx: + μ/2‖θ−θ_g‖²);
* optional Scaffold control-variate correction (g − c_k + c) and the
  Option-II variate update c_k' = c_k − c + (θ_g − θ_k)/(steps·lr);
* a ``freeze`` mask (a tree of 0/1 numbers) implementing the LP variants
  and the FED3R+FT strategies: FT (all 1), FT-LP (extractor 0), FT-FEAT
  (head 0).

``local_update`` takes its gradients with ``torch.func.grad`` and never
branches on a tensor's value, so the round engine
(:mod:`repro_torch.federated.round_engine`) maps it over the cohort with
``torch.func.vmap``.  The server is a :class:`ServerState` (params,
momentum buffer, adaptive m/v/t, the Scaffold server variate, the STACKED
per-client variates, round index) advanced by pure functions that build
new tensors and update none in place, so the state checkpoints through
:mod:`repro_torch.checkpoint` as a plain tree and training resumes at any
round boundary.

Server optimizers: weighted average of client deltas, then SGD (momentum
> 0 gives FedAvgM, Hsu et al. 2019) or Adam/Yogi treating the aggregated
delta as a pseudo-gradient (Reddi et al. 2021).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch

from repro_torch.federated.dist import resolve_device
from repro_torch.sharding import hints
from repro_torch.tree import tree_leaves, tree_map


class LocalResult(NamedTuple):
    delta: Any  # θ_k − θ_g (masked by freeze)
    n_samples: torch.Tensor  # effective client size (aggregation weight)
    new_cvar: Any  # updated client control variate (scaffold), else None


@dataclass(frozen=True)
class FLAlgorithm:
    name: str
    uses_cvar: bool  # scaffold
    prox_mu: float
    server_momentum: float
    server_opt: str = "sgd"  # sgd | adam | yogi (Reddi et al. 2021)

    @property
    def adaptive(self) -> bool:
        return self.server_opt in ("adam", "yogi")


def make_algorithm(
    name: str, *, prox_mu: float = 0.01, server_momentum: float = 0.9
) -> FLAlgorithm:
    name = name.lower()
    if name == "fedavg":
        return FLAlgorithm("fedavg", False, 0.0, 0.0)
    if name == "fedavgm":
        return FLAlgorithm("fedavgm", False, 0.0, server_momentum)
    if name == "fedprox":
        return FLAlgorithm("fedprox", False, prox_mu, 0.0)
    if name == "scaffold":
        return FLAlgorithm("scaffold", True, 0.0, 0.0)
    if name == "fedadam":
        return FLAlgorithm("fedadam", False, 0.0, 0.0, server_opt="adam")
    if name == "fedyogi":
        return FLAlgorithm("fedyogi", False, 0.0, 0.0, server_opt="yogi")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# client local update
# ---------------------------------------------------------------------------


def make_local_update(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor],
    algo: FLAlgorithm,
    *,
    lr: float,
    weight_decay: float = 0.0,
    replicated: Any = None,
) -> Callable[..., LocalResult]:
    """Build ``local_update(global_params, batches, freeze, c_server, c_client)``.

    Batches arrive padded to a fixed shape: ``batches`` is a dict of tensors
    with leading dims (n_steps, batch_size, ...) plus ``mask``
    (n_steps, batch_size).  Empty padding batches contribute exactly zero:
    their step is scaled by ``has`` = 0, a tensor, never a host branch.
    The steps run as a Python loop (the reference's ``lax.scan``).
    ``c_server`` and ``c_client`` are read by Scaffold only (pass None
    otherwise).  One client's update, or the cohort's under
    ``torch.func.vmap``.

    Under an ambient "model" axis (:mod:`repro_torch.sharding.hints`) the
    params are the rank's blocks and ``replicated`` (a tree of bools of
    their structure) flags those every model rank holds whole: the loss is
    seeded once over "model", and the flagged leaves' gradients are summed
    over it before the proximal term, the weight decay and Scaffold's
    correction, which are per leaf and already whole.
    """

    def masked_loss(params, batch):
        per = loss_fn(params, batch)  # (batch_size,) per-example losses
        m = batch["mask"].to(torch.float32)
        return hints.seed_loss((per * m).sum() / m.sum().clamp_min(1.0))

    grad = torch.func.grad(masked_loss)

    def local_update(global_params, batches, freeze, c_server, c_client) -> LocalResult:
        params = global_params
        for i in range(batches["mask"].shape[0]):
            batch = {k: v[i] for k, v in batches.items()}
            has = (batch["mask"].sum() > 0).to(torch.float32)
            grads = grad(params, batch)
            if hints.model_size() > 1:
                if replicated is None:
                    raise ValueError("under a 'model' axis the local update needs the "
                                     "replicated leaves (replicated=)")
                grads = hints.sum_replicated(grads, replicated)
            if algo.prox_mu > 0.0:
                grads = tree_map(
                    lambda g, p, p0: g + algo.prox_mu * (p - p0),
                    grads, params, global_params,
                )
            if weight_decay > 0.0:
                grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
            if algo.uses_cvar:
                grads = tree_map(lambda g, ck, cs: g - ck + cs, grads, c_client, c_server)
            # freeze mask + padding no-op
            params = tree_map(lambda p, g, f: p - lr * has * f * g, params, grads, freeze)

        delta = tree_map(lambda p, p0, f: (p - p0) * f, params, global_params, freeze)
        n_eff = batches["mask"].sum()

        new_c = None
        if algo.uses_cvar:
            # Scaffold Option II: c_k' = c_k − c + (θ_g − θ_k)/(steps·lr)
            steps = (batches["mask"].sum(dim=1) > 0).to(torch.float32).sum().clamp_min(1.0)
            new_c = tree_map(
                lambda ck, cs, dlt: ck - cs - dlt / (steps * lr),
                c_client, c_server, delta,
            )
        return LocalResult(delta=delta, n_samples=n_eff, new_cvar=new_c)

    return local_update


# ---------------------------------------------------------------------------
# server state + pure transitions
# ---------------------------------------------------------------------------


class ServerState(NamedTuple):
    """The complete FedAvg-family server as one checkpointable tree.

    Unused slots are ``None`` (e.g. ``momentum`` for plain FedAvg,
    ``cvars`` for everything but Scaffold), as in the reference;
    checkpoints tag them ``"none"``.
    """

    params: Any
    momentum: Any  # server momentum buffer (FedAvgM) or None
    opt_m: Any  # Adam/Yogi first moment or None
    opt_v: Any  # Adam/Yogi second moment or None
    opt_t: torch.Tensor  # () int32 adaptive step counter
    c_server: Any  # Scaffold server control variate or None
    cvars: Any  # STACKED (n_clients, ...) client variates or None
    round: torch.Tensor  # () int32 — rounds applied so far


def server_init(
    algo: FLAlgorithm, params0: Any, *, n_clients: int = 0
) -> ServerState:
    """Fresh server state on ``params0``'s device.  ``n_clients`` sizes the
    stacked Scaffold variates (required iff ``algo.uses_cvar``).

    ``params0`` is COPIED, so the state owns its tensors and no caller-held
    tensor aliases them.
    """
    if algo.uses_cvar and n_clients < 1:
        raise ValueError("scaffold needs n_clients to size the stacked cvars")
    dev = next(tree_leaves(params0)).device
    zeros = lambda: tree_map(torch.zeros_like, params0)  # noqa: E731
    scalar = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return ServerState(
        params=tree_map(torch.clone, params0),
        momentum=zeros() if algo.server_momentum > 0 else None,
        opt_m=zeros() if algo.adaptive else None,
        opt_v=tree_map(
            lambda p: torch.full(p.shape, 1e-6, dtype=torch.float32, device=p.device), params0
        ) if algo.adaptive else None,
        opt_t=scalar(),
        c_server=zeros() if algo.uses_cvar else None,
        cvars=tree_map(
            lambda p: torch.zeros((n_clients,) + tuple(p.shape), dtype=p.dtype, device=p.device),
            params0,
        ) if algo.uses_cvar else None,
        round=scalar(),
    )


def server_state_from_tree(
    tree: Dict[str, Any], device: Union[str, torch.device] = "cuda"
) -> ServerState:
    """Rewrap a checkpoint-restored dict (NamedTuples round-trip as dicts),
    its numpy leaves made tensors on ``device`` with their dtypes kept."""
    dev = resolve_device(device)

    def to(a):
        return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a), device=dev)

    return ServerState(**{f: tree_map(to, tree[f]) for f in ServerState._fields})


def server_optimizer_step(
    algo: FLAlgorithm,
    state: ServerState,
    avg_delta: Any,
    *,
    server_lr: float,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-3,
) -> ServerState:
    """Apply ONE server optimizer step to the weighted-average delta.

    Called inside the round engine's step and by the per-client reference
    loop.  Does not touch the Scaffold fields or the round counter (see
    :func:`scaffold_update` / the engine for those).
    """
    slr = server_lr
    if algo.adaptive:
        t = state.opt_t + 1
        m = tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d, state.opt_m, avg_delta)
        if algo.server_opt == "yogi":
            v = tree_map(
                lambda v_, d: v_ - (1 - b2) * d.square() * torch.sign(v_ - d.square()),
                state.opt_v, avg_delta,
            )
        else:
            v = tree_map(lambda v_, d: b2 * v_ + (1 - b2) * d.square(), state.opt_v, avg_delta)
        params = tree_map(
            lambda p, m_, v_: p + slr * m_ / (torch.sqrt(v_.clamp_min(0.0)) + eps),
            state.params, m, v,
        )
        return state._replace(params=params, opt_m=m, opt_v=v, opt_t=t)
    if algo.server_momentum > 0:
        momentum = tree_map(
            lambda m_, d: algo.server_momentum * m_ + d, state.momentum, avg_delta
        )
        params = tree_map(lambda p, s: p + slr * s, state.params, momentum)
        return state._replace(params=params, momentum=momentum)
    params = tree_map(lambda p, d: p + slr * d, state.params, avg_delta)
    return state._replace(params=params)


def _set_rows(table: torch.Tensor, ids: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``table`` with row ``ids[k]`` set to ``new[k]``, slots with id −1
    dropped: the reference's ``table.at[ids].set(new, mode="drop")``.

    Without a host sync (no boolean indexing, which would call ``nonzero``,
    and no indexing by a 0-d tensor, which would read it on the host) and
    without a race: a padded slot repeats the first real slot's write, row
    and value both, so every write a row receives carries the same bits (a
    clamped id alone would race a padded slot's garbage against the real
    write to row 0).  With no real slot, the padded slots write row 0 back
    unchanged.
    """
    valid = ids >= 0
    first = torch.argmax(valid.to(torch.int32)).view(1)  # the first real slot, 0 if none
    safe = ids.clamp(0, table.shape[0] - 1).long()
    first_row = safe.index_select(0, first)
    target = torch.where(valid, safe, first_row)
    rows = (1,) * (new.dim() - 1)
    fill = torch.where(valid.index_select(0, first).view((1,) + rows),
                       new.index_select(0, first), table.index_select(0, first_row))
    value = torch.where(valid.view((-1,) + rows), new, fill)
    return table.index_copy(0, target, value)


def scaffold_update(
    state: ServerState,
    cvar_delta_sum: Any,  # Σ_k (c_k' − c_k), zeros on padded cohort slots
    new_cvars: Any,  # (cohort, ...) updated client variates
    client_ids: torch.Tensor,  # (cohort,) int32, −1 = padded slot
    *,
    n_total_clients: int,
) -> ServerState:
    """Scaffold server-side bookkeeping, on the device end to end.

    ``c ← c + (1/N)·Σ_k (c_k' − c_k)``, and the per-client variates are
    scattered back into the stacked ``(n_clients, ...)`` table in one
    ``index_copy`` per leaf (padded slots dropped, :func:`_set_rows`).
    """
    c_server = tree_map(
        lambda c, d: c + d / n_total_clients, state.c_server, cvar_delta_sum
    )
    cvars = tree_map(lambda table, new: _set_rows(table, client_ids, new), state.cvars, new_cvars)
    return state._replace(c_server=c_server, cvars=cvars)
