"""Federated training driver: FED3R (phase 1) then FED3R+FT (phase 2), in PyTorch.

The port of the reference's ``launch/train.py``.

Phase 1 (FED3R, Algorithm 1): a statistics pass over packed client shards
through the accumulation engine, backbone features extracted per shard and
each client's statistics computed by the ``fed3r_stats`` kernel; then the
ridge solve, test accuracy and softmax temperature calibration of the
classifier (:func:`fed3r_phase`).

Phase 2 (FED3R+FT, §4.4, ``rounds > 0``): federated fine-tuning through the
cohort round engine (:mod:`repro_torch.federated.round_engine`) — each
round's sampled cohort is packed into stacked ``(cohort, n_steps, batch)``
token arrays, moved to the device, and the round (local updates vmapped
over the cohort, on-device weighted aggregation, server optimizer step)
runs as one ``round_step`` (:func:`ft_phase`).  The head starts from the
calibrated classifier; ``--ft-strategy`` picks what trains (full, lp:
head only, feat: backbone only).  The full :class:`ServerState` —
backbone+head params, optimizer buffers, round index — checkpoints every
5 rounds and after the last; ``--resume`` continues from the latest
snapshot and reproduces the uninterrupted run (cohorts and shuffles are
pure functions of the round index).

Scale-out: started by ``torchrun`` with more than one rank, the driver
joins the world over the backend ``--backend`` names (``nccl``: one card a
rank; ``gloo``: any number of ranks, sharing cards), lays a host mesh
(:func:`repro_torch.launch.mesh.make_host_mesh`) over it and runs both
phases under ``DistConfig(aggregation="psum", mesh=...)``: phase 1's shards
and phase 2's cohort are split over the ranks, the statistics and the
weighted deltas all-reduced.  Rank 0's parameters are broadcast first, so
every rank starts from the same weights; only rank 0 prints and writes
checkpoints.  With one rank the driver runs as a single process.  With
``--model-parallel`` > 1 the mesh has a "model" axis and both phases run
tensor-parallel over it (each rank its block of the backbone,
:mod:`repro_torch.sharding.hints`): phase 1's feature pass, and phase 2's
local steps, forward and backward, and its evaluation.  A checkpoint holds
the whole leaves, gathered over "model", in the reference's layout; a
resume cuts them into the rank's blocks again.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch fed3r-mnv2-proxy \\
      --clients 100 --per-round 10 --seq-len 128 --rounds 3 --device cuda \\
      [--algorithm fedavg] [--ft-strategy feat] [--ckpt-dir DIR [--resume]]
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --backend gloo --arch fed3r-mnv2-proxy ...
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_checkpoint, load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration, fed3r
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import PackedCohort, pack_client_shards, pack_cohort_batches
from repro_torch.data.synthetic import TokenDataset, make_token_dataset
from repro_torch.federated.algorithms import make_algorithm, server_state_from_tree
from repro_torch.federated.dist import DistConfig, broadcast_tree, resolve_device
from repro_torch.federated.engine import AccumulationEngine, EngineConfig
from repro_torch.federated.round_engine import RoundConfig, RoundEngine
from repro_torch.federated.sampling import sample_round
from repro_torch.launch.mesh import axis_size, make_host_mesh
from repro_torch.launch.steps import make_cls_per_example_loss
from repro_torch.launch.world import BACKENDS, init_world
from repro_torch.models import build_model
from repro_torch.sharding import hints
from repro_torch.sharding.shard import gather_params, replicated_leaves, shard_params
from repro_torch.tree import tree_map

RIDGE_LAMBDA = 0.01
_FT_SEED = 3  # phase-2 sampling/shuffle seed (pure function of the round)
CKPT_EVERY = 5  # phase 2 evaluates and checkpoints every this many rounds


def _partition(labels_np: np.ndarray, n_clients: int):
    """The one-class-per-client split both phases use."""
    return dirichlet_partition(np.random.default_rng(2), labels_np, n_clients, alpha=0.0)


def _dist(mesh: Any) -> DistConfig:
    """The engines' backend: merge in one process, psum over ``mesh``."""
    return DistConfig() if mesh is None else DistConfig(aggregation="psum", mesh=mesh)


def _model_parallel(mesh: Any) -> int:
    return 1 if mesh is None or "model" not in mesh.mesh_dim_names else axis_size(mesh, "model")


def _writer(mesh: Any) -> bool:
    """Whether this process owns the checkpoints: the one process, or
    global rank 0 of a mesh."""
    return mesh is None or dist.get_rank() == 0


def _resume_path(ckpt_dir: Optional[str], resume: bool, mesh: Any) -> Optional[str]:
    """The checkpoint to resume from, as global rank 0 finds it: only rank
    0 reads ``ckpt_dir``, and every rank gets its answer."""
    path = latest_checkpoint(ckpt_dir) if (resume and ckpt_dir and _writer(mesh)) else None
    if mesh is not None:
        box = [path]
        dist.broadcast_object_list(box, src=0)
        path = box[0]
    return path


def fed3r_phase(
    cfg: ModelConfig,
    params: dict,
    ds: TokenDataset,
    *,
    n_clients: int,
    clients_per_round: int,
    device: Union[str, torch.device] = "cuda",
    mesh: Any = None,
    verbose: bool = True,
) -> dict:
    """Phase 1 on given backbone params and token dataset.

    Every client contributes exactly once: the clients (a one-class-per-
    client split of ``ds``) are packed ``clients_per_round`` to a shard and
    folded by the engine (with ``mesh``, each rank folds its block of the
    shards and the statistics are all-reduced; with a "model" axis the
    features are extracted tensor-parallel, each rank from its block of
    ``params``).  The first fifth of ``ds`` is the test set; the
    temperature is calibrated on the next 512 samples.  Returns the
    classifier, its calibrated form, the statistics and what was measured.
    """
    kw = dict(n_clients=n_clients, clients_per_round=clients_per_round, device=device,
              mesh=mesh, verbose=verbose)
    if _model_parallel(mesh) > 1:  # the feature pass on the "model" axis alone: the data
        with hints.use_mesh(mesh["model"]):  # shards stay apart, as one process folds them
            return _fed3r_phase(cfg, shard_params(cfg, params, mesh), ds, **kw)
    return _fed3r_phase(cfg, params, ds, **kw)


def _fed3r_phase(cfg: ModelConfig, params: dict, ds: TokenDataset, *, n_clients: int,
                 clients_per_round: int, device, mesh: Any, verbose: bool) -> dict:
    dev = resolve_device(device)
    model = build_model(cfg)
    tokens_np = ds.tokens.cpu().numpy()
    labels_np = ds.labels.cpu().numpy()
    parts = _partition(labels_np, n_clients)
    n_test = len(labels_np) // 5
    tokens, labels = ds.tokens.to(dev), ds.labels.to(dev)

    t0 = time.time()
    engine = AccumulationEngine(
        EngineConfig(n_classes=ds.n_classes, dist=_dist(mesh)),
        feature_fn=lambda p, toks: model.extract_features(p, {"tokens": toks}),
        device=dev,
    )
    packed = pack_client_shards(
        [(tokens_np[parts[k]], labels_np[parts[k]]) for k in range(n_clients)],
        clients_per_shard=clients_per_round, mesh=mesh,
    )
    acc = engine.accumulate(engine.init(cfg.d_feat), packed, params)
    W = fed3r.solve(acc.stats, RIDGE_LAMBDA)
    with torch.no_grad():
        feats_test = model.extract_features(params, {"tokens": tokens[:n_test]})
        cal = slice(n_test, n_test + 512)
        scores = fed3r.predict(W, model.extract_features(params, {"tokens": tokens[cal]}))
    test_acc = float(fed3r.accuracy(W, feats_test, labels[:n_test]))
    temp, _ = calibration.calibrate_temperature(scores, labels[cal])
    W_head = calibration.fold_temperature(W, temp)
    seconds = time.time() - t0
    if verbose:
        ranks = "" if mesh is None else f" over {dist.get_world_size()} ranks"
        print(f"[fed3r] classifier in {n_clients} client visits{ranks} "
              f"({seconds:.1f}s)  acc={test_acc:.4f}  T={float(temp):.2f}")
    return {
        "W": W, "W_head": W_head, "stats": acc.stats, "fed3r_acc": test_acc,
        "temperature": float(temp), "seconds": seconds, "n_test": n_test,
        "n_slots": packed.n_slots, "max_n": packed.inputs.shape[2],
    }


def ft_engine(
    cfg: ModelConfig,
    params: dict,
    *,
    n_clients: int,
    lr: float = 0.05,
    algorithm: str = "fedavg",
    ft_strategy: str = "feat",
    mesh: Any = None,
) -> RoundEngine:
    """Phase 2's round engine over ``{"backbone": params, "head": {"W", "b"}}``:
    the classification loss, and the freeze mask of ``ft_strategy`` (full:
    everything trains; lp: the head only; feat: the backbone only); with
    ``mesh``, the psum backend over it, and with a "model" axis the
    backbone's replicated leaves and the head flagged for the local
    update's gradient sum."""
    if ft_strategy not in ("full", "lp", "feat"):
        raise ValueError(f"unknown ft_strategy {ft_strategy!r}")
    head = 0.0 if ft_strategy == "feat" else 1.0
    freeze = {
        "backbone": tree_map(lambda _: 0.0 if ft_strategy == "lp" else 1.0, params),
        "head": {"W": head, "b": head},
    }
    m = _model_parallel(mesh)
    replicated = None if m == 1 else {"backbone": replicated_leaves(cfg, m),
                                      "head": {"W": True, "b": True}}
    return RoundEngine(
        RoundConfig(algo=make_algorithm(algorithm), client_lr=lr, n_total_clients=n_clients,
                    dist=_dist(mesh)),
        make_cls_per_example_loss(cfg),
        freeze,
        replicated,
    )


class FtClients:
    """The one-class split of a token dataset, as both phases see it, and
    phase 2's cohort of a round: ``clients_per_round`` clients from
    ``sample_round`` (seed ``_FT_SEED``), each padded to the largest
    client's ``local_batch_size`` batches and shuffled from
    ``(_FT_SEED, round, client id)`` — a pure function of the round."""

    def __init__(self, ds: TokenDataset, n_clients: int, clients_per_round: int,
                 local_batch_size: int):
        self.tokens = ds.tokens.cpu().numpy()
        self.labels = ds.labels.cpu().numpy()
        self.parts = _partition(self.labels, n_clients)
        self.n_clients, self.clients_per_round = n_clients, clients_per_round
        self.local_batch_size = local_batch_size
        self.n_batches = -(-max(len(p) for p in self.parts) // local_batch_size)

    def cohort(self, rnd: int, mesh: Any = None) -> PackedCohort:
        """Round ``rnd``'s packed cohort (padded to divide ``mesh``)."""
        chosen = sample_round(self.n_clients, self.clients_per_round, rnd, seed=_FT_SEED)
        return pack_cohort_batches(
            [(self.tokens[self.parts[int(k)]], self.labels[self.parts[int(k)]]) for k in chosen],
            self.local_batch_size, self.n_batches, client_ids=chosen, seed=(_FT_SEED, rnd),
            mesh=mesh,
        )


def ft_phase(
    cfg: ModelConfig,
    params: dict,
    ds: TokenDataset,
    W_head: torch.Tensor,
    *,
    n_clients: int,
    clients_per_round: int,
    rounds: int,
    lr: float = 0.05,
    local_batch_size: int = 64,
    algorithm: str = "fedavg",
    ft_strategy: str = "feat",
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    device: Union[str, torch.device] = "cuda",
    mesh: Any = None,
    verbose: bool = True,
) -> dict:
    """Phase 2 on given backbone params, token dataset and head init.

    Fine-tunes ``{"backbone": params, "head": {"W": W_head, "b": 0}}`` for
    ``rounds`` rounds (from the latest checkpoint's round with ``resume``)
    over :class:`FtClients`' cohorts.  Returns the final ``ServerState``,
    the test accuracies at every checkpoint round, and each round's
    host-clock ms around ``RoundEngine.step`` (ending in a device
    synchronize) with the real tokens its local training read.  With
    ``mesh`` each rank trains its block of the cohort, and only global rank
    0 reads and writes checkpoints: a resumed state travels from it by
    broadcast.  With a "model" axis in ``mesh`` the layers read that axis
    alone as the ambient mesh (each client's batch stays whole on its data
    rank, as in one process), each rank trains its blocks of the backbone
    (``params`` is whole; the head is replicated) and the returned
    ``"state"`` holds the rank's blocks; a checkpoint holds the whole
    leaves, gathered over "model".
    """
    kw = dict(n_clients=n_clients, clients_per_round=clients_per_round, rounds=rounds, lr=lr,
              local_batch_size=local_batch_size, algorithm=algorithm, ft_strategy=ft_strategy,
              ckpt_dir=ckpt_dir, resume=resume, device=device, mesh=mesh, verbose=verbose)
    if _model_parallel(mesh) > 1:
        with hints.use_mesh(mesh["model"]):
            return _ft_phase(cfg, shard_params(cfg, params, mesh), ds, W_head, **kw)
    return _ft_phase(cfg, params, ds, W_head, **kw)


_PARAM_TREES = ("params", "momentum", "opt_m", "opt_v")  # ServerState's param-shaped fields


def _map_backbones(state: Any, fn) -> Any:
    """``state`` with ``fn`` applied to the backbone of each param-shaped field."""
    return state._replace(**{f: {**getattr(state, f), "backbone": fn(getattr(state, f)["backbone"])}
                             for f in _PARAM_TREES if getattr(state, f) is not None})


def _whole_state(cfg: ModelConfig, state: Any, mesh: Any) -> Any:
    """``state`` with every backbone gathered over "model" into whole leaves
    (a collective every rank joins; ``state`` itself without a model axis)."""
    if _model_parallel(mesh) == 1:
        return state
    return _map_backbones(state, lambda b: gather_params(cfg, b, mesh))


def _rank_state(cfg: ModelConfig, state: Any, mesh: Any) -> Any:
    """The rank's blocks of a whole ``state`` (:func:`_whole_state`'s inverse)."""
    if _model_parallel(mesh) == 1:
        return state
    return _map_backbones(state, lambda b: shard_params(cfg, b, mesh))


def _ft_phase(cfg: ModelConfig, params: dict, ds: TokenDataset, W_head: torch.Tensor, *,
              n_clients: int, clients_per_round: int, rounds: int, lr: float,
              local_batch_size: int, algorithm: str, ft_strategy: str, ckpt_dir: Optional[str],
              resume: bool, device, mesh: Any, verbose: bool) -> dict:
    dev = resolve_device(device)
    model = build_model(cfg)
    clients = FtClients(ds, n_clients, clients_per_round, local_batch_size)
    n_test = len(clients.labels) // 5
    test_tokens, test_labels = ds.tokens[:n_test].to(dev), ds.labels[:n_test].to(dev)

    engine = ft_engine(cfg, params, n_clients=n_clients, lr=lr, algorithm=algorithm,
                       ft_strategy=ft_strategy, mesh=mesh)
    writer = _writer(mesh)
    head = {"W": W_head, "b": torch.zeros((ds.n_classes,), dtype=torch.float32, device=dev)}
    state = engine.init({"backbone": params, "head": head})
    start_round = 0
    resume_path = _resume_path(ckpt_dir, resume, mesh)
    if resume_path is not None:
        whole = _whole_state(cfg, state, mesh)  # the snapshot's shapes on every rank
        if writer:  # the snapshot's leaves in the live state's order
            whole = tree_map(lambda _, x: x, whole,
                             server_state_from_tree(load_pytree(resume_path), dev))
        if mesh is not None:  # rank 0's snapshot on every rank
            whole = broadcast_tree(whole, src=0)
        state = _rank_state(cfg, whole, mesh)
        start_round = int(state.round)
        if verbose:
            print(f"[ft:{ft_strategy}] resuming from {resume_path} (round {start_round})")

    @torch.no_grad()
    def evaluate(p) -> float:
        feats = model.extract_features(p["backbone"], {"tokens": test_tokens})
        logits = feats @ p["head"]["W"] + p["head"]["b"]
        return float((logits.argmax(-1) == test_labels).to(torch.float32).mean())

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    log = {"rounds": [], "ft_acc": [], "round_ms": [], "round_tokens": [], "n_test": n_test}
    for rnd in range(start_round, rounds):
        cohort = clients.cohort(rnd, mesh)
        log["round_tokens"].append(cohort.n_samples * clients.tokens.shape[1])
        cohort = cohort.to(dev)
        sync()
        t0 = time.perf_counter()
        state = engine.step(state, cohort)
        sync()
        log["round_ms"].append(1e3 * (time.perf_counter() - t0))
        if (rnd + 1) % CKPT_EVERY == 0 or rnd == rounds - 1:
            acc = evaluate(state.params)
            log["rounds"].append(rnd + 1)
            log["ft_acc"].append(acc)
            if verbose:
                print(f"[ft:{ft_strategy}] round {rnd + 1:4d}  acc={acc:.4f}  "
                      f"({log['round_ms'][-1]:.1f} ms the last round)")
            if ckpt_dir:
                # round-resumable: the FULL server state, not just the head
                whole = _whole_state(cfg, state, mesh)
                if writer:
                    save_pytree(os.path.join(ckpt_dir, f"ckpt_{rnd + 1}.npz"), whole)
    log["state"] = state
    return log


def run(
    arch: str,
    *,
    n_classes: int = 16,
    n_clients: int = 40,
    clients_per_round: int = 8,
    rounds: int = 0,
    seq_len: int = 32,
    n_samples: int = 2048,
    lr: float = 0.05,
    local_batch_size: int = 64,
    algorithm: str = "fedavg",
    ft_strategy: str = "feat",
    use_fed3r_init: bool = True,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    device: Union[str, torch.device] = "cuda",
    mesh: Any = None,
    verbose: bool = True,
) -> dict:
    """Random backbone params (seed 0) and a synthetic token dataset (seed
    1), then phase 1 and, with ``rounds > 0``, phase 2 (under ``"ft"``);
    with ``mesh`` (a host mesh over an initialized world) both phases run
    under the psum backend, from rank 0's parameters.  The draws are made
    on the host and moved to ``device``, so every device starts from the
    same numbers.

    Phase 1 is skipped without ``use_fed3r_init`` (the head is then drawn
    0.01·N(0, 1) from a ``torch.Generator`` seeded 0) and when phase 2
    resumes from a checkpoint, whose state overwrites any head it would
    produce.
    """
    dev = resolve_device(device)
    cfg = get_config(arch)
    params = tree_map(lambda t: t.to(dev), build_model(cfg).init(seed=0, device="cpu"))
    if mesh is not None:
        params = broadcast_tree(params, src=0)
    gen = torch.Generator()
    gen.manual_seed(1)
    ds = make_token_dataset(gen, n_samples, seq_len, cfg.vocab_size, n_classes)
    ds = ds._replace(tokens=ds.tokens.to(dev), labels=ds.labels.to(dev),
                     lm_labels=ds.lm_labels.to(dev))
    resuming = rounds > 0 and _resume_path(ckpt_dir, resume, mesh) is not None
    out: dict = {"params0": params}
    if use_fed3r_init and not resuming:
        out.update(fed3r_phase(
            cfg, params, ds, n_clients=n_clients, clients_per_round=clients_per_round,
            device=dev, mesh=mesh, verbose=verbose,
        ))
    if rounds > 0:
        W_head = out.get("W_head")
        if W_head is None:
            gen.manual_seed(0)
            W_head = (0.01 * torch.randn((cfg.d_feat, n_classes), generator=gen)).to(dev)
        out["ft"] = ft_phase(
            cfg, params, ds, W_head, n_clients=n_clients, clients_per_round=clients_per_round,
            rounds=rounds, lr=lr, local_batch_size=local_batch_size, algorithm=algorithm,
            ft_strategy=ft_strategy, ckpt_dir=ckpt_dir, resume=resume, device=dev,
            mesh=mesh, verbose=verbose,
        )
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fed3r-mnv2-proxy-smoke")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--per-round", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--local-batch", type=int, default=64)
    ap.add_argument("--algorithm", default="fedavg",
                    choices=["fedavg", "fedavgm", "fedprox", "scaffold", "fedadam", "fedyogi"])
    ap.add_argument("--ft-strategy", default="feat", choices=["full", "lp", "feat"])
    ap.add_argument("--no-fed3r-init", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="collective backend when torchrun starts more than one rank")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the mesh's 'model' axis (both phases run over it)")
    args = ap.parse_args()
    device, mesh, verbose = args.device, None, True
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.backend is None:
            ap.error("more than one rank: name the collective backend with --backend")
        device = init_world(args.backend, args.device)
        mesh = make_host_mesh(args.model_parallel, device_type=device.type)
        verbose = dist.get_rank() == 0
    try:
        run(
            args.arch, rounds=args.rounds, n_clients=args.clients,
            clients_per_round=args.per_round, seq_len=args.seq_len,
            local_batch_size=args.local_batch, algorithm=args.algorithm,
            ft_strategy=args.ft_strategy, use_fed3r_init=not args.no_fed3r_init,
            ckpt_dir=args.ckpt_dir, resume=args.resume, device=device, mesh=mesh,
            verbose=verbose,
        )
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
