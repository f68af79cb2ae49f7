"""Federated round-loop simulator on the batched cohort round engine.

The port of the reference's ``federated/simulator.py``.  Runs any
:mod:`repro_torch.federated.algorithms` algorithm over a
:class:`repro_torch.data.pipeline.FederatedDataset`.  Each round, the
sampled cohort is packed into stacked ``(cohort, n_steps, batch)`` arrays
(:func:`repro_torch.data.pipeline.pack_cohort_batches`), moved to the
device, and the WHOLE round — vmapped local updates, on-device weighted
aggregation, server optimizer step, Scaffold cvar scatter — runs through
:class:`repro_torch.federated.round_engine.RoundEngine`.

Rounds are resumable: cohorts and epoch shuffles are pure functions of
(seed, round, client id), and the full :class:`ServerState` checkpoints
through :mod:`repro_torch.checkpoint`, so a run stopped at any round
boundary and restarted with ``resume=True`` reproduces the uninterrupted
run exactly.  The device is the task's: its ``params0`` say where the
rounds run.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint, load_pytree, save_pytree
from repro_torch.configs.base import FederatedConfig
from repro_torch.data.pipeline import FederatedDataset, pack_cohort_batches
from repro_torch.federated.algorithms import make_algorithm, server_state_from_tree
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.round_engine import RoundConfig, RoundEngine
from repro_torch.federated.sampling import sample_round
from repro_torch.tree import tree_leaves


class FLTask(NamedTuple):
    """A federated optimization problem.

    ``per_example_loss(params, batch) -> (batch_size,)`` losses;
    ``batch`` = {"x": ..., "y": ..., "mask": ...}.
    ``freeze``: tree of {1.0: trainable, 0.0: frozen} matching params.
    """

    params0: Any
    per_example_loss: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]
    freeze: Any
    eval_fn: Optional[Callable[[Any], torch.Tensor]] = None


@dataclass
class FLHistory:
    rounds: List[int] = field(default_factory=list)
    accuracy: List[float] = field(default_factory=list)
    coverage: List[float] = field(default_factory=list)
    wall_time: List[float] = field(default_factory=list)

    def as_dict(self) -> Dict[str, list]:
        return {
            "rounds": self.rounds,
            "accuracy": self.accuracy,
            "coverage": self.coverage,
            "wall_time": self.wall_time,
        }


def make_round_engine(
    task: FLTask, dataset: FederatedDataset, cfg: FederatedConfig
) -> RoundEngine:
    """The simulator's engine (merge aggregation)."""
    algo = make_algorithm(
        cfg.algorithm, prox_mu=cfg.prox_mu, server_momentum=cfg.server_momentum
    )
    return RoundEngine(
        RoundConfig(
            algo=algo,
            client_lr=cfg.client_lr,
            server_lr=cfg.server_lr,
            weight_decay=cfg.client_weight_decay,
            n_total_clients=dataset.n_clients,
        ),
        task.per_example_loss,
        task.freeze,
    )


def pack_round(
    dataset: FederatedDataset,
    cfg: FederatedConfig,
    rnd: int,
    n_batches: int,
    mesh: Optional[object] = None,
    num_shards: Optional[int] = None,
):
    """The packed cohort of round ``rnd`` — a pure function of (cfg, rnd).

    Sampling and the per-client epoch shuffles both derive from
    (cfg.seed, rnd, client id), which is what makes stop/resume exact.
    ``mesh`` (or ``num_shards``) pads the cohort axis to a multiple of the
    mesh's data-parallel size — padded slots are exact no-ops.
    """
    chosen = sample_round(
        dataset.n_clients, cfg.clients_per_round, rnd,
        seed=cfg.seed, replacement=cfg.sample_with_replacement,
    )
    clients = [
        (dataset.client(int(k)).features, dataset.client(int(k)).labels)
        for k in chosen
    ]
    return chosen, pack_cohort_batches(
        clients, cfg.local_batch_size, n_batches, cfg.local_epochs,
        client_ids=chosen, seed=(cfg.seed + 7, rnd), mesh=mesh, num_shards=num_shards,
    )


def run_federated(
    task: FLTask,
    dataset: FederatedDataset,
    cfg: FederatedConfig,
    *,
    eval_every: int = 10,
    verbose: bool = False,
    ckpt_dir: Optional[str] = None,
    ckpt_every: Optional[int] = None,
    resume: bool = False,
) -> tuple:
    """Run cfg.n_rounds of federated training. Returns (params, FLHistory).

    With ``ckpt_dir`` the full :class:`ServerState` (params, momentum,
    adaptive m/v/t, stacked cvars, round index) is snapshotted every
    ``ckpt_every`` rounds (default: ``eval_every``) and after the last;
    ``resume=True`` picks up from the latest snapshot and reproduces the
    uninterrupted run.
    """
    engine = make_round_engine(task, dataset, cfg)
    dev = next(tree_leaves(task.params0)).device
    state, start_round = None, 0
    if resume and ckpt_dir:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            state = server_state_from_tree(load_pytree(path), dev)
            start_round = int(state.round)
    if state is None:
        state = engine.init(task.params0)

    max_nk = int(dataset.client_sizes().max())
    n_batches = -(-max_nk // cfg.local_batch_size)

    seen: set = set()
    for rnd in range(start_round):  # replay coverage of resumed rounds
        seen.update(
            int(k) for k in sample_round(
                dataset.n_clients, cfg.clients_per_round, rnd,
                seed=cfg.seed, replacement=cfg.sample_with_replacement,
            )
        )

    hist = FLHistory()
    t0 = time.time()
    for rnd in range(start_round, cfg.n_rounds):
        chosen, cohort = pack_round(dataset, cfg, rnd, n_batches)
        seen.update(int(k) for k in chosen)
        state = engine.step(state, cohort.to(dev))

        if ckpt_dir and (
            (rnd + 1) % (ckpt_every or eval_every) == 0 or rnd == cfg.n_rounds - 1
        ):
            save_pytree(os.path.join(ckpt_dir, f"ckpt_{rnd + 1}.npz"), state)

        if task.eval_fn is not None and ((rnd + 1) % eval_every == 0 or rnd == cfg.n_rounds - 1):
            acc = float(task.eval_fn(state.params))
            hist.rounds.append(rnd + 1)
            hist.accuracy.append(acc)
            hist.coverage.append(len(seen) / dataset.n_clients)
            hist.wall_time.append(time.time() - t0)
            if verbose:
                print(f"round {rnd+1:5d}  acc={acc:.4f}  coverage={len(seen)/dataset.n_clients:.2f}")
    return state.params, hist


# ---------------------------------------------------------------------------
# linear softmax-head task over fixed features (LP baselines of the paper)
# ---------------------------------------------------------------------------


def as_f32(x, device: torch.device) -> torch.Tensor:
    """An fp32 tensor on ``device`` from a tensor or a (possibly read-only)
    host array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def as_labels(y, device: torch.device) -> torch.Tensor:
    """Labels on ``device`` (a copy of a host array: it may be read-only)."""
    if isinstance(y, torch.Tensor):
        return y.to(device)
    return torch.as_tensor(np.array(y), device=device)


def softmax_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy in fp32: logsumexp − the label's logit."""
    picked = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def linear_head_task(
    d: int,
    n_classes: int,
    test_features,
    test_labels,
    *,
    W_init=None,
    gen: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = "cuda",
) -> FLTask:
    """FedAvg-LP etc.: train only a linear softmax head on frozen features.

    Without ``W_init`` the head is drawn 0.01·N(0, 1) from ``gen`` (a
    ``torch.Generator`` on ``device``, seeded 0 by default): the draw
    matches the reference's in distribution, not in bits, so parity tests
    pass ``W_init``.
    """
    dev = resolve_device(device)
    if W_init is None:
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        W_init = 0.01 * torch.randn((d, n_classes), generator=gen, device=dev)
    params0 = {"W": as_f32(W_init, dev),
               "bias": torch.zeros((n_classes,), dtype=torch.float32, device=dev)}

    def per_example_loss(params, batch):
        logits = batch["x"].to(torch.float32) @ params["W"] + params["bias"]
        return softmax_ce(logits, batch["y"])

    tf, tl = as_f32(test_features, dev), as_labels(test_labels, dev)

    @torch.no_grad()
    def eval_fn(params):
        logits = tf @ params["W"] + params["bias"]
        return (logits.argmax(-1) == tl).to(torch.float32).mean()

    freeze = {"W": 1.0, "bias": 1.0}
    return FLTask(params0=params0, per_example_loss=per_example_loss,
                  freeze=freeze, eval_fn=eval_fn)
