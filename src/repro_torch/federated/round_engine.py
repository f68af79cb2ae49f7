"""Batched cohort round engine for gradient FL — the Fed3R+FT hot path.

The port of the reference's ``federated/round_engine.py``.  Where the
statistics engine folds a packed client selection into (A, b), this module
runs an ENTIRE FedAvg-family round — K sampled clients' local updates,
weighted delta aggregation, the server optimizer step, and the Scaffold
control-variate scatter — in one ``round_step`` on the device:

* the cohort arrives as a :class:`repro_torch.data.pipeline.PackedCohort`
  (stacked ``(cohort, n_steps, batch, ...)`` arrays with masks), moved to
  the state's device once (pass ``cohort.to(device)`` to keep the step free
  of host-to-device copies);
* ``local_update`` (the pure form from
  :mod:`repro_torch.federated.algorithms`) is mapped over the cohort axis
  with ``torch.func.vmap``: one batched local step a step of the round, for
  every client at once;
* aggregation weights stay on the device end to end — no ``float()`` host
  syncs, no Python-list delta sums: the weighted delta is one
  ``tensordot`` with the on-device sample counts;
* the Scaffold variates live in one stacked ``(n_clients, ...)`` table
  inside :class:`repro_torch.federated.algorithms.ServerState`: gathered by
  cohort ids on the way in, one ``index_copy`` a leaf on the way out.

:class:`ReferenceLoop` keeps the per-client shape (K local updates, host-side
aggregation with a ``float()`` a client, one server step) as the parity
oracle.

Scale-out (:mod:`repro_torch.federated.dist`): under ``DistConfig(
aggregation="psum", mesh=...)`` every rank steps the same state over the
same packed cohort (pack with ``pack_cohort_batches(..., mesh=mesh)`` so
the cohort divides), vmaps the local updates of its block of the cohort
only, and all-reduces the weighted delta tree and the weight sum once,
after the updates, as one buffer; the server step then runs on every rank
on the same sum.  Scaffold refuses psum, as in the reference: its cvar
scatter needs the whole cohort.  On a mesh with a "model" axis the params
are each rank's blocks and the layers read the model axis as the ambient
mesh (:mod:`repro_torch.sharding.hints`): ``replicated`` flags the leaves
whose gradients the local update sums over it, and the deltas are still
all-reduced over the data axes only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from repro_torch.data.pipeline import PackedCohort
from repro_torch.federated.algorithms import (
    FLAlgorithm,
    ServerState,
    make_local_update,
    scaffold_update,
    server_init,
    server_optimizer_step,
)
from repro_torch.federated.dist import DistConfig, DistContext, DistDispatchMixin
from repro_torch.tree import tree_leaves, tree_map

LossFn = Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]


@dataclass(frozen=True)
class RoundConfig:
    """Static round-engine configuration."""

    algo: FLAlgorithm
    client_lr: float
    server_lr: float = 1.0
    weight_decay: float = 0.0
    n_total_clients: int = 0  # sizes the Scaffold cvar table / 1/N update
    dist: DistConfig = field(default_factory=DistConfig)  # backend/mesh


def _cohort_on(cohort: PackedCohort, state: ServerState) -> PackedCohort:
    """The cohort on the state's device (a no-op for one already there)."""
    return cohort.to(next(tree_leaves(state.params)).device)


class RoundEngine(DistDispatchMixin):
    """Federated rounds over packed cohorts, each round one ``round_step``.

    ``loss_fn(params, batch) -> (batch_size,)`` per-example losses;
    ``freeze`` is the 0/1 trainability mask tree (FT / FT-LP / FT-FEAT);
    ``replicated`` the tree of bools of the leaves every model rank holds
    whole (needed under a "model" axis).
    """

    def __init__(self, cfg: RoundConfig, loss_fn: LossFn, freeze: Any, replicated: Any = None):
        if cfg.dist.aggregation == "psum" and cfg.algo.uses_cvar:
            raise ValueError(
                "scaffold needs the global cohort for the cvar scatter; "
                "use aggregation='merge' (GSPMD) for mesh runs"
            )
        self.cfg = cfg
        self.freeze = freeze
        self._local = make_local_update(
            loss_fn, cfg.algo, lr=cfg.client_lr, weight_decay=cfg.weight_decay,
            replicated=replicated,
        )
        self.dist = DistContext(cfg.dist, engine="rounds")

    def init(self, params0: Any) -> ServerState:
        return server_init(
            self.cfg.algo, params0, n_clients=self.cfg.n_total_clients
        )

    def _cohort_update(self, params, batches, c_server, c_client):
        """One client's local update as a tuple of tensors (what vmap maps):
        (delta, n_samples) and, for Scaffold, the new variate."""
        res = self._local(params, batches, self.freeze, c_server, c_client)
        if self.cfg.algo.uses_cvar:
            return res.delta, res.n_samples, res.new_cvar
        return res.delta, res.n_samples

    def round_step(
        self,
        state: ServerState,
        batches: Dict[str, torch.Tensor],  # leaves (cohort, n_steps, B, ...)
        client_ids: torch.Tensor,  # (cohort,) int32, -1 = padded slot
    ) -> ServerState:
        """One full FL round as a pure ServerState transition."""
        algo = self.cfg.algo
        if algo.uses_cvar:
            safe = client_ids.clamp(0, self.cfg.n_total_clients - 1).long()
            c_client = tree_map(lambda t: t[safe], state.cvars)
            delta, w, new_c = torch.func.vmap(
                self._cohort_update, in_dims=(None, 0, None, 0)
            )(state.params, batches, state.c_server, c_client)
        else:
            delta, w = torch.func.vmap(
                self._cohort_update, in_dims=(None, 0, None, None)
            )(state.params, batches, None, None)

        # weighted delta aggregation, entirely on the device: padded cohort
        # slots have an all-zero mask, hence weight 0 and a zero delta
        weighted = tree_map(lambda d: torch.tensordot(w, d, dims=1), delta)
        # identity under "merge"; under "psum" the ranks' weighted deltas
        # and weights summed once, after the vmapped local updates
        weighted, wsum = self.dist.all_reduce((weighted, w.sum()))
        wsum = wsum.clamp_min(1.0)
        avg_delta = tree_map(lambda d: d / wsum, weighted)

        state = server_optimizer_step(
            algo, state, avg_delta, server_lr=self.cfg.server_lr
        )

        if algo.uses_cvar:
            # padded slots produced new_c = c_k − c (not c_k): mask them out
            # of the 1/N sum; the scatter drops them
            valid = (client_ids >= 0).to(torch.float32)
            cvar_delta_sum = tree_map(
                lambda new, old: torch.tensordot(valid, new - old, dims=1), new_c, c_client,
            )
            state = scaffold_update(
                state, cvar_delta_sum, new_c, client_ids,
                n_total_clients=self.cfg.n_total_clients,
            )
        return state._replace(round=state.round + 1)

    # ---- host API ---------------------------------------------------------

    def step(self, state: ServerState, cohort: PackedCohort) -> ServerState:
        """Run one round over a packed cohort."""
        with self.dist.telemetry.span("round_step", engine="rounds"):
            self.dist.dispatch()
            cohort = _cohort_on(cohort, state)
            batches = {k: self.dist.local_block(v) for k, v in cohort.batches().items()}
            return self.round_step(state, batches, self.dist.local_block(cohort.client_ids))


class ReferenceLoop:
    """The per-client round: K local updates + host-side Python aggregation
    + one server step (K+1 dispatches a round).

    Kept as the parity oracle for the engine (same ``local_update`` math,
    same pure server transition), including the per-client ``float()`` host
    syncs the engine removes.
    """

    def __init__(self, cfg: RoundConfig, loss_fn: LossFn, freeze: Any):
        self.cfg = cfg
        self.freeze = freeze
        self._local = make_local_update(
            loss_fn, cfg.algo, lr=cfg.client_lr, weight_decay=cfg.weight_decay,
        )
        self.dispatches = 0

    def init(self, params0: Any) -> ServerState:
        return server_init(
            self.cfg.algo, params0, n_clients=self.cfg.n_total_clients
        )

    def step(self, state: ServerState, cohort: PackedCohort) -> ServerState:
        algo = self.cfg.algo
        cohort = _cohort_on(cohort, state)
        results, ids, cvar_olds = [], [], []
        for slot in range(cohort.cohort):
            cid = int(cohort.client_ids[slot])
            if cid < 0:
                continue
            batches = {k: v[slot] for k, v in cohort.batches().items()}
            c_client = tree_map(lambda t: t[cid], state.cvars) if algo.uses_cvar else None
            res = self._local(state.params, batches, self.freeze, state.c_server, c_client)
            self.dispatches += 1
            results.append(res)
            ids.append(cid)
            cvar_olds.append(c_client)

        # host-side aggregation (the shape the engine replaces)
        weights = [float(r.n_samples) for r in results]
        wsum = max(sum(weights), 1.0)
        avg = tree_map(
            lambda *ds: sum(wk * d for wk, d in zip(weights, ds)) / wsum,
            *[r.delta for r in results],
        )
        state = server_optimizer_step(algo, state, avg, server_lr=self.cfg.server_lr)
        self.dispatches += 1

        if algo.uses_cvar:
            cvar_delta_sum = tree_map(
                lambda *cs: sum(cs),
                *[
                    tree_map(lambda n, o: n - o, r.new_cvar, old)
                    for r, old in zip(results, cvar_olds)
                ],
            )
            c_server = tree_map(
                lambda c, d: c + d / self.cfg.n_total_clients,
                state.c_server, cvar_delta_sum,
            )
            cvars = tree_map(torch.clone, state.cvars)
            for cid, r in zip(ids, results):
                tree_map(lambda t, n, i=cid: t[i].copy_(n), cvars, r.new_cvar)
            state = state._replace(c_server=c_server, cvars=cvars)
        return state._replace(round=state.round + 1)
