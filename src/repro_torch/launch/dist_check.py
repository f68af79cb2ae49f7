"""Rank programs that hold the dist layer's psum backend against merge.

Each program runs inside one rank of a ``torch.distributed`` world (spawn
it with :func:`repro_torch.launch.world.run_world`, or call it in a
:func:`repro_torch.launch.world.single_rank_world`), builds the same
inputs from numpy seeds on every rank, runs each engine under
``DistConfig(aggregation="psum", mesh=...)`` and, beside it, the same
engine on the merge backend over the whole input (no collective), and
returns both as numpy arrays.  The caller checks that psum equals merge —
bitwise on grid-exact inputs, where any summation order is exact — and that
every rank returned the same bits.  They are the reference's ``tests/
test_dist.py``, ``tests/test_tiers.py`` (mesh trees) and
``tests/test_round_engine.py`` (psum round) scenarios at the reference
tests' sizes, made to run on the port's one-process-a-rank model.

* :func:`layer_program` — meshes and what they refuse, ``DistConfig``
  validation, the two-stage psum against a flat one, ``aggregate_mesh``,
  and the shard-count invariance inputs (:func:`invariance_program`).
* :func:`engines_program` — the statistics, streaming, round,
  personalization and async engines, sharded against merge (flat psum and
  through ``mesh_tree`` trees), the int8 wire's psum form, and the pod mesh.
* :func:`train_program` — ``launch/train.py``'s ``run`` over the world's
  host mesh: phase 1, one FT round and its checkpoint, then a resume.
* :func:`tp_program` — models of every family tensor-, expert- and
  context-parallel over a ``(data, model)`` host mesh: the train forward,
  the features, a prefill and teacher-forced decode steps, ``serve`` with
  its times and peak memory, planted faults, phase 1 of ``train.run``,
  what stays refused (Scaffold under psum) and the cross-attention split
  over the frames.
* :func:`fsdp_program` — FSDP: the gradient against the unsharded one
  (and planted faults), ``make_train_step``, prefill and decode logits
  against the TP-only layout, and the dry run's rank program
  (``launch/dryrun.py``) on real ranks, which a dry run over a fake world
  is held against; and any job of :func:`tp_job` or the context-parallel
  combine (:func:`combine_job`) beside them.
* :func:`tp_train_program` — the backward under a ``"model"`` axis: each
  family's ``lm_loss`` gradient gathered over "model" (or held, leaf by
  leaf on each rank, against the unsharded gradient the ranks computed
  first, one at a time),
  planted faults of the gradient convention, one ``RoundEngine.step``, and
  ``train.run``'s phase 2 with its checkpoint and resume.

The programs import nothing of the reference package: spawned ranks import
this module by name.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fed3r
from repro_torch.data.pipeline import (
    FederatedDataset,
    pack_arrival_waves,
    pack_client_shards,
    pack_cohort_batches,
    pack_personal_cohort,
)
from repro_torch.federated.algorithms import make_algorithm
from repro_torch.federated.arrivals import UploadEvent
from repro_torch.federated.async_engine import AsyncConfig, AsyncRoundEngine
from repro_torch.federated.compress import WireFormat
from repro_torch.federated.dist import DistConfig, DistContext, two_stage_psum
from repro_torch.federated.engine import AccumulationEngine, EngineConfig
from repro_torch.federated.personalization import PersonalizationEngine, PersonalizeConfig
from repro_torch.federated.round_engine import RoundConfig, RoundEngine
from repro_torch.federated.simulator import linear_head_task, pack_round
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine
from repro_torch.federated.tiers import TierSpec, AggregationTree, mesh_tree
from repro_torch.configs.base import FederatedConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import (
    data_axes,
    data_parallel_size,
    make_host_mesh,
    make_tier_host_mesh,
    n_chips,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import table_split
from repro_torch.models.model import compute_dtype
from repro_torch.models.moe import DropTally
from repro_torch.sharding import hints
from repro_torch.sharding.specs import map_with_path
from repro_torch.sharding.shard import (
    fsdp_leaves,
    full_params,
    gather_params,
    leaf_specs,
    local_rows,
    replicated_leaves,
    seeded_factory,
    shard_params,
    shard_params_from,
)
from repro_torch.tree import tree_leaves, tree_map

D, C, LAM = 16, 5, 0.1  # the reference tests' sizes
ROUND_CLIENTS, ROUND_D, ROUND_C = 12, 8, 4  # tests/test_round_engine.py's task
TRAIN_ARCH = "fed3r-mnv2-proxy-smoke"
SSM_ARCH = "mamba2-1.3b-smoke"  # layer_program's backward under "model" 2
# train.run at the smoke width: 2 phase-1 shards and a cohort of 4 clients
TRAIN = dict(n_clients=8, clients_per_round=4, n_samples=160, seq_len=16, n_classes=8,
             local_batch_size=8)


def grid(rng: np.random.Generator, shape) -> np.ndarray:
    """Features on a 1/8 grid in [-2, 2]: every Gram product lands on a
    1/64 grid and every partial sum stays far below 2^24/64, so fp32
    accumulation is EXACT in any order."""
    return (rng.integers(-16, 17, size=shape) / 8.0).astype(np.float32)


def grid_clients(seed: int, sizes: Sequence[int], d: int = D, n_classes: int = C):
    """The reference tests' ``_grid_clients``: one (features, labels) a size."""
    rng = np.random.default_rng(seed)
    return [(grid(rng, (n, d)), rng.integers(0, n_classes, size=n).astype(np.int32))
            for n in sizes]


def personal_clients(seed: int = 5, k: int = 8, n: int = 12):
    """Strongly label-skewed tenants (tenant k only sees class k mod C), so
    the α sweep's score gaps dwarf any batched-solve rounding."""
    rng = np.random.default_rng(seed)
    return [(grid(rng, (n, D)), np.full((n,), i % C, dtype=np.int32)) for i in range(k)]


def round_data(seed: int = 0):
    """A small federation for the psum round: 12 clients of Gaussian class
    clusters (numpy), its test split, and the head init."""
    rng = np.random.default_rng(seed)
    n = 600
    means = rng.normal(size=(ROUND_C, ROUND_D)).astype(np.float32) * 2.0
    labels = rng.integers(0, ROUND_C, size=n).astype(np.int32)
    feats = (means[labels] + 1.5 * rng.normal(size=(n, ROUND_D))).astype(np.float32)
    idx = np.arange(n)
    parts = [idx[k::ROUND_CLIENTS] for k in range(ROUND_CLIENTS)]
    W0 = (0.01 * rng.normal(size=(ROUND_D, ROUND_C))).astype(np.float32)
    test = (feats[:100], labels[:100])
    return FederatedDataset(feats, labels, parts, ROUND_C), test, W0


def round_fc() -> FederatedConfig:
    """tests/test_round_engine.py's ``_fc()``: 4 clients a round, batch 16."""
    return FederatedConfig(n_clients=ROUND_CLIENTS, clients_per_round=4, n_rounds=3,
                           local_epochs=1, local_batch_size=16, client_lr=0.1,
                           algorithm="fedavg", seed=0)


def np_(x: Any) -> Any:
    """Tensors (and trees of them) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: np_(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_(v) for v in x) if not hasattr(x, "_fields") else type(x)(
            *(np_(v) for v in x))
    return x


def _raises(fn, *args, **kw) -> Tuple[str, str]:
    """(exception type name, message) of ``fn(*args, **kw)``, or ("", "")."""
    try:
        fn(*args, **kw)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return "", ""


def psum_config(mesh, **kw) -> DistConfig:
    """The psum backend over ``mesh`` (``tree=`` routes it)."""
    return DistConfig(aggregation="psum", mesh=mesh, **kw)


def run_accumulate(packed, dist_cfg=None, wire=None, dev="cpu"):
    """One ``accumulate`` of ``packed`` from zero: A, b, n, class counts,
    dispatches and (fp32 wire) the solved W."""
    cfg = EngineConfig(n_classes=C, dist=dist_cfg or DistConfig(),
                       wire=wire or WireFormat())
    eng = AccumulationEngine(cfg, device=dev)
    acc = eng.accumulate(eng.init(D), packed)
    out = {"A": acc.stats.A, "b": acc.stats.b, "n": acc.stats.n, "counts": acc.class_counts,
           "dispatches": eng.dispatches}
    if eng.wire.kind == "fp32":
        out["W"] = fed3r.solve(acc.stats, LAM)
    return out


def run_stream(packed, dist_cfg=None, dev="cpu", wire=None):
    """One ``absorb`` of the timeline from zero: L, W, n, the refresh trace."""
    cfg = StreamConfig(n_classes=C, ridge_lambda=LAM, dist=dist_cfg or DistConfig(),
                       wire=wire or WireFormat())
    eng = StreamingEngine(cfg, device=dev)
    st, trace = eng.absorb(eng.init(D), packed)
    return {"L": st.L, "W": st.W, "n": st.n, "refreshed": trace.refreshed,
            "dispatches": eng.dispatches}


def invariance_program(rank: int, world: int, device: torch.device) -> dict:
    """The same packed arrays (padded for 4 shards) through the statistics
    and streaming engines under psum at this world's data-parallel size:
    A, b, L and W must not depend on it."""
    mesh = make_host_mesh(device_type=device.type)
    packed = pack_client_shards(grid_clients(6, [7, 13, 5, 9, 11, 3, 8, 6]), 2, max_n=16,
                                num_shards=4)
    arrivals = pack_arrival_waves([grid_clients(20 + t, [8] * 4) for t in range(3)],
                                  num_shards=4)
    acc = run_accumulate(packed, psum_config(mesh), dev=device)
    st = run_stream(arrivals, psum_config(mesh), dev=device)
    return np_({"A": acc["A"], "b": acc["b"], "W": acc["W"], "L": st["L"], "Ws": st["W"]})


def layer_program(rank: int, world: int, device: torch.device) -> dict:
    """Meshes, ``DistConfig``, the two-stage psum and ``aggregate_mesh``
    (``world`` must be 4: the pod mesh is (2, 2))."""
    dt = device.type
    out: Dict[str, Any] = {}
    out["raises"] = {
        "model_parallel=world+1": _raises(make_host_mesh, world + 1, device_type=dt),
        "model_parallel=0": _raises(make_host_mesh, 0, device_type=dt),
        "pods=0": _raises(make_host_mesh, pods=0, device_type=dt),
        "pods=world+1": _raises(make_host_mesh, pods=world + 1, device_type=dt),
        "tier shape": _raises(make_tier_host_mesh, (world + 1,), device_type=dt),
        "tier model name": _raises(make_tier_host_mesh, (world,), ("model",), device_type=dt),
        "tier names": _raises(make_tier_host_mesh, (2, world // 2), ("edge",), device_type=dt),
    }
    mesh = make_host_mesh(device_type=dt)
    pods = make_host_mesh(pods=2, device_type=dt)
    tiers = make_tier_host_mesh((2, world // 2), device_type=dt)
    # a "model" axis of 2: the meshes build, an SSM's backward runs over it
    # (its gradient gathered), and a cross-attention whose (k, v) the rules
    # split over the frames runs under it
    tp = make_host_mesh(2, device_type=dt)
    tp_tiers = make_tier_host_mesh((world // 2,), (), 2, device_type=dt)
    out["model_parallel=2"] = {
        "host": (tp.mesh_dim_names, data_axes(tp), tuple(tp.mesh.shape)),
        "tiers": (tp_tiers.mesh_dim_names, data_axes(tp_tiers), tuple(tp_tiers.mesh.shape)),
        "ssm gradient": gathered_gradient(get_config(SSM_ARCH).replace(dtype="float32"),
                                          loss_gradient(SSM_ARCH, tp, device), tp),
        "cross-attention split": tp_refusals(rank, device)["cross-attention split"],
    }
    out["layouts"] = {
        "host": (mesh.mesh_dim_names, data_axes(mesh), data_parallel_size(mesh),
                 tuple(mesh.mesh.shape)),
        "pods": (pods.mesh_dim_names, data_axes(pods), data_parallel_size(pods),
                 tuple(pods.mesh.shape)),
        "tiers": (tiers.mesh_dim_names, data_axes(tiers), data_parallel_size(tiers),
                  tuple(tiers.mesh.shape)),
        "n_chips": (n_chips(mesh), n_chips(pods), n_chips(tiers)),
    }
    cfg = psum_config(mesh)
    out["config"] = {
        "axis_names": cfg.axis_names, "data_shards": cfg.data_shards,
        "merge+mesh": _raises(DistConfig, aggregation="merge", mesh=mesh),
    }

    # the two-stage psum against one flat all-reduce over the world
    dp = data_parallel_size(pods)
    x = grid(np.random.default_rng(0), (dp, 8))
    ctx = DistContext(psum_config(pods))
    row = torch.from_numpy(x).to(device)[ctx.shard_index]
    two = two_stage_psum({"v": row}, pods, ("pod", "data"))["v"]
    flat = row.clone()
    dist.all_reduce(flat)
    out["two_stage"] = np_({"two": two, "flat": flat, "rows": torch.from_numpy(x)})

    # aggregate_mesh: each rank's block of samples, summed over "data"
    rng = np.random.default_rng(1)
    n, d, c = 4 * world, 8, 3
    feats = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    ctx = DistContext(cfg)
    f = torch.from_numpy(ctx.local_block(feats)).to(device)
    y = torch.from_numpy(ctx.local_block(labels)).to(device)
    agg = fed3r.aggregate_mesh(fed3r.client_stats(f, y, c), ("data",), mesh)
    full = fed3r.client_stats(torch.from_numpy(feats).to(device),
                              torch.from_numpy(labels).to(device), c)
    out["aggregate_mesh"] = np_({"agg": tuple(agg), "full": tuple(full)})
    out["invariance"] = invariance_program(rank, world, device)
    return out


def linear_loss(params, batch):
    """tests/test_dist.py's linear softmax loss on the grid clients (no bias)."""
    logits = batch["x"].to(torch.float32) @ params["W"]
    return torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, batch["y"].long()[:, None])[:, 0]


def run_round(cohort, dist_cfg, params0, freeze, loss, n_total):
    """One FedAvg round (client lr 0.1) from ``params0``: (params, dispatches)."""
    rc = RoundConfig(algo=make_algorithm("fedavg"), client_lr=0.1, n_total_clients=n_total,
                     dist=dist_cfg or DistConfig())
    eng = RoundEngine(rc, loss, freeze)
    st = eng.step(eng.init(params0), cohort)
    return {k: v for k, v in st.params.items()}, eng.dispatches


def run_async(payloads, K, dist_cfg, dev, order_seed=3) -> dict:
    """One async round of ``K`` clients delivered in a seeded order, the
    live classifier before its close, then drained: W, L, live, statuses."""
    cfg = AsyncConfig(n_classes=C, ridge_lambda=LAM, cohort=K, dist=dist_cfg or DistConfig())
    eng = AsyncRoundEngine(cfg, device=dev)
    st = eng.init(D)
    eng.begin_round(0, list(range(K)), 0.0)
    status = []
    for i, c in enumerate(np.random.default_rng(order_seed).permutation(K)):
        st, s = eng.deliver(st, UploadEvent(0.1 * i, 0, int(c), 0), payloads[int(c)])
        status.append(s)
    live = eng.live_classifier(st)
    st = eng.close_round(st, 0, now=1.0)
    st = eng.drain(st)
    return {"W": st.W, "L": st.L, "live": live, "status": status, "folded": eng.folded}


def engines_program(rank: int, world: int, device: torch.device) -> dict:
    """Every engine sharded against merge (``world`` must be 4)."""
    dt, dev = device.type, device
    mesh = make_host_mesh(device_type=dt)
    psum = psum_config(mesh)
    out: Dict[str, Any] = {}

    # statistics engine, fp32 and the int8 wire's psum form
    packed = pack_client_shards(grid_clients(3, [9, 3, 14, 6, 1, 11, 8, 4]), 2, max_n=16,
                                mesh=mesh)
    out["accumulate"] = np_({"psum": run_accumulate(packed, psum, dev=dev), "merge": run_accumulate(packed, dev=dev)})
    int8 = WireFormat(kind="int8", tile=8)
    got = run_accumulate(packed, psum, wire=int8, dev=dev)
    out["accumulate_int8"] = np_({"A": got["A"], "b": got["b"]})

    # streaming engine
    waves = pack_arrival_waves([grid_clients(10 + t, [8] * (2 + t % 2)) for t in range(5)],
                               mesh=mesh)
    out["stream"] = np_({"psum": run_stream(waves, psum, dev=dev), "merge": run_stream(waves, dev=dev)})
    out["stream_int8"] = np_(run_stream(waves, psum, dev=dev, wire=int8))
    out["absorb_stats under mesh"] = _raises(
        StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=LAM, dist=psum),
                        device=dev).absorb_stats,
        None, None, None, None)

    # round engine: tests/test_dist.py's grid cohort and tests/
    # test_round_engine.py's linear-head task on a packed round
    cohort = pack_cohort_batches(grid_clients(4, [24, 18, 30, 12]), 8, 3, mesh=mesh)
    params0 = {"W": torch.zeros((D, C), dtype=torch.float32, device=dev)}
    freeze = {"W": 1.0}
    got, disp = run_round(cohort, psum, params0, freeze, linear_loss, 4)
    want, _ = run_round(cohort, None, params0, freeze, linear_loss, 4)
    out["round_grid"] = np_({"psum": got, "merge": want, "dispatches": disp})
    fed, (tf, tl), W0 = round_data()
    task = linear_head_task(ROUND_D, ROUND_C, tf, tl, W_init=W0, device=dev)
    _, plain = pack_round(fed, round_fc(), 0, n_batches=4)
    _, padded = pack_round(fed, round_fc(), 0, n_batches=4, mesh=mesh)
    got, _ = run_round(padded, psum, task.params0, task.freeze, task.per_example_loss,
                    ROUND_CLIENTS)
    want, _ = run_round(plain, None, task.params0, task.freeze, task.per_example_loss,
                     ROUND_CLIENTS)
    out["round_task"] = np_({"psum": got, "merge": want})
    out["scaffold under psum"] = _raises(
        RoundEngine, RoundConfig(algo=make_algorithm("scaffold"), client_lr=0.1,
                                 n_total_clients=4, dist=psum), linear_loss, freeze)

    # personalization: the cohort sharded, heads gathered back
    clients = personal_clients()
    cohort_p = pack_personal_cohort(clients, mesh=mesh)
    fac = fed3r.factored_update(
        fed3r.init_factored(D, C, LAM, dev),
        torch.from_numpy(np.concatenate([x for x, _ in clients])).to(dev),
        torch.from_numpy(np.concatenate([y for _, y in clients])).to(dev))
    eng_p = PersonalizationEngine(PersonalizeConfig(n_classes=C, dist=psum), device=dev)
    eng_m = PersonalizationEngine(PersonalizeConfig(n_classes=C), device=dev)
    hp, hm = eng_p.solve_heads(fac, cohort_p), eng_m.solve_heads(fac, cohort_p)
    ap, am = eng_p.solve_at(fac, cohort_p, hm.alpha), eng_m.solve_at(fac, cohort_p, hm.alpha)
    out["personalization"] = np_({
        "psum": {"W": hp.W, "alpha": hp.alpha, "score": hp.score, "W_at": ap.W},
        "merge": {"W": hm.W, "alpha": hm.alpha, "score": hm.score, "W_at": am.W},
        "dispatches": eng_p.dispatches,
    })

    # the pod mesh: the wave statistics reduce intra-pod, then across pods
    pods = make_host_mesh(pods=2, device_type=dt)
    waves_p = pack_arrival_waves([grid_clients(30 + t, [8] * 4) for t in range(3)], mesh=pods)
    out["pod_stream"] = np_({"psum": run_stream(waves_p, psum_config(pods), dev=dev),
                             "merge": run_stream(waves_p, dev=dev)})

    # mesh trees: a 1-axis tier mesh routes the statistics engine; a 2-tier
    # mesh routes the stream (tree = flat = merge) and the async ring
    edge = make_tier_host_mesh((world,), device_type=dt)
    tree1 = mesh_tree(edge)
    packed_e = pack_client_shards(grid_clients(7, [8] * (2 * world)), 2, mesh=edge)
    out["tree_accumulate"] = np_({
        "axes": tree1.axes,
        "tree": run_accumulate(packed_e, psum_config(edge, tree=tree1), dev=dev),
        "merge": run_accumulate(packed_e, dev=dev),
    })
    tmesh = make_tier_host_mesh((2, world // 2), device_type=dt)
    tree2 = mesh_tree(tmesh)
    rng = np.random.default_rng(1)
    waves_t = pack_arrival_waves(
        [[(grid(rng, (8, D)), rng.integers(0, C, size=8).astype(np.int32))
          for _ in range(world)] for _ in range(2)], mesh=tmesh)
    out["tree_stream"] = np_({
        "axes": tree2.axes, "fan_in": tuple(t.fan_in for t in tree2.tiers),
        "tree": run_stream(waves_t, psum_config(tmesh, tree=tree2), dev=dev)["W"],
        "flat": run_stream(waves_t, psum_config(tmesh), dev=dev)["W"],
        "merge": run_stream(waves_t, dev=dev)["W"],
    })
    rng = np.random.default_rng(2)
    payloads = {c: fed3r.client_stats(torch.from_numpy(grid(rng, (8, D))).to(dev),
                                      torch.from_numpy(rng.integers(0, C, size=8)).to(dev), C)
                for c in range(world)}
    out["async"] = np_({
        "tree": run_async(payloads, world, psum_config(tmesh, tree=tree2), dev),
        "flat": run_async(payloads, world, psum_config(mesh), dev),
        "merge": run_async(payloads, world, None, dev),
        "K=3": _raises(AsyncRoundEngine, AsyncConfig(n_classes=C, ridge_lambda=LAM, cohort=3,
                                                     dist=psum_config(tmesh, tree=tree2)), device=dev),
        "secure": _raises(AsyncRoundEngine, AsyncConfig(n_classes=C, ridge_lambda=LAM,
                                                        cohort=world, secure=True,
                                                        dist=psum_config(mesh)), device=dev),
    })
    # an int8 top tier: each rank's edge sum crosses the region tier
    # roundtripped once, matching the same crossing emulated in rank order
    lossy = AggregationTree((TierSpec("edge", fan_in=world // 2, axis="edge"),
                             TierSpec("region", fan_in=2, wire=int8, axis="region")))
    got = run_accumulate(packed_e, psum_config(tmesh, tree=lossy), dev=dev)
    out["tree_int8"] = np_({"A": got["A"], "b": got["b"], "lossy": lossy.lossy_wire.kind})
    return out


def train_program(rank: int, world: int, device: torch.device, root: str) -> dict:
    """``train.run`` under the psum backend over the host mesh of the world:
    phase 1 alone; then one FT round from the seeded head, checkpointed
    into ``root/rank<r>`` (each rank is given a directory of its own, so
    that what each wrote shows), and a ``resume`` to round 2.  Returns the
    statistics, the classifier, both rounds' parameters, the resumed run's
    log and the files in this rank's directory."""
    mesh = make_host_mesh(device_type=device.type)
    ckpt = os.path.join(root, f"rank{rank}")
    kw = dict(TRAIN, device=device, mesh=mesh, verbose=False)
    phase1 = train.run(TRAIN_ARCH, **kw)
    first = train.run(TRAIN_ARCH, rounds=1, use_fed3r_init=False, ckpt_dir=ckpt, **kw)
    resumed = train.run(TRAIN_ARCH, rounds=2, resume=True, ckpt_dir=ckpt, **kw)
    return {
        **np_({"A": phase1["stats"].A, "b": phase1["stats"].b, "W": phase1["W"],
               "theta1": first["ft"]["state"].params, "theta2": resumed["ft"]["state"].params}),
        "fed3r_acc": phase1["fed3r_acc"],
        "ft_acc": (first["ft"]["ft_acc"], resumed["ft"]["ft_acc"]),
        "resumed_rounds": resumed["ft"]["rounds"],
        "files": sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else [],
    }


def digest(tree: Any) -> List[bytes]:
    """The bytes of every array leaf (for equal-bits checks across ranks)."""
    return [np.ascontiguousarray(x).tobytes() for x in tree_leaves(tree)
            if isinstance(x, np.ndarray)]


# ---------------------------------------------------------------------------
# tensor and expert parallelism
# ---------------------------------------------------------------------------


def _expert_offset_factory(factory, model_rank: int):
    """``factory`` with the expert blocks of one model rank cut one expert
    late (a planted fault: that rank runs its neighbour's experts)."""
    def planted(path, shape, index, device):
        if hints.model_rank() == model_rank and path.endswith(("moe/w_gate", "moe/w_up",
                                                               "moe/w_down")):
            e = index[0]
            lo = (e.start or 0) + 1
            if lo + (e.stop - e.start) <= shape[0]:
                index = (slice(lo, lo + e.stop - e.start),) + tuple(index[1:])
        return factory(path, shape, index, device)

    return planted


def _embed_columns_swapped_factory(factory):
    """``factory`` with model ranks 1 and 2 holding each other's d_model
    columns of the embedding table (a planted fault of the d_model split)."""
    def planted(path, shape, index, device):
        r = hints.model_rank()
        if (path == "embed/embedding" and r in (1, 2) and hints.model_size() > 2
                and index[1] != slice(None)):
            n = index[1].stop - index[1].start
            other = 3 - r
            index = (index[0], slice(other * n, (other + 1) * n))
        return factory(path, shape, index, device)

    return planted


def _unscaled_combine(m, l, o):
    """attention._cp_combine without its max rescale (a planted fault): each
    rank's pieces summed as if every rank's row max were the same."""
    lo = hints.reduce_model(torch.cat([l, o], dim=-1))
    return lo[..., 1:] / lo[..., :1]


def _heads_offset(real, model_rank: int):
    """ssm._rank_heads with one model rank's heads one to the right (a
    planted fault: it runs its neighbour's first head with its own A, Δ
    bias and D)."""
    def planted(H):
        got = real(H)
        if hints.model_rank() != model_rank:
            return got
        return slice(got.start + 1, got.stop + 1)

    return planted


def _width_blocks_swapped(real):
    """rglru._gather_width with the blocks of model ranks 1 and 2 swapped
    in the gathered activation (a planted fault of the width gather)."""
    def planted(x):
        full = real(x)
        if hints.model_size() < 3:
            return full
        n = full.shape[-1] // hints.model_size()
        b1, b2 = full[..., n:2 * n].clone(), full[..., 2 * n:3 * n].clone()
        full[..., n:2 * n], full[..., 2 * n:3 * n] = b2, b1
        return full

    return planted


# the runtime faults a job can plant: (module, attribute, its replacement
# made from the real one)
_RUNTIME_FAULTS = {
    "combine unscaled": (attn_mod, "_cp_combine", lambda real: _unscaled_combine),
    "ssd heads offset": (ssm_mod, "_rank_heads", lambda real: _heads_offset(real, 1)),
    "rglru width blocks swapped": (rglru_mod, "_gather_width", _width_blocks_swapped),
}


@contextlib.contextmanager
def _planted(fault):
    """A runtime fault of :data:`_RUNTIME_FAULTS` in place for the block."""
    if fault not in _RUNTIME_FAULTS:
        yield
        return
    module, name, make = _RUNTIME_FAULTS[fault]
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _tp_params(cfg, mesh, dev, params_np, seed, fault, fsdp=False):
    if params_np is not None:
        return shard_params(cfg, params_from_jax(cfg, params_np, dev), mesh, fsdp)
    factory = seeded_factory(seed)
    planted = {"experts offset": lambda f: _expert_offset_factory(f, 1),
               "embed columns swapped": _embed_columns_swapped_factory}.get(fault)
    if planted is not None:
        with hints.use_mesh(mesh):  # the factory reads the rank's model coordinate
            return shard_params_from(cfg, planted(factory), mesh, dev)
    return shard_params_from(cfg, factory, mesh, dev, fsdp=fsdp)


def _offset(cfg) -> int:
    """The positions a VLM's patches take before its text."""
    return cfg.n_patches if cfg.arch_type == "vlm" else 0


def forced(cfg, params, prompts, decode, extra, capacity) -> Dict[str, Any]:
    """A prefill of ``prompts`` (with the batch's ``extra`` inputs: patches,
    frames) into caches of ``capacity`` slots and one decode step a column
    of ``decode`` (teacher-forced): the logits, gathered over the vocab, the
    prefill's drop share, the shape of every cache leaf (the rank's block),
    the layouts read off them (:func:`layouts`), the first ring's slot
    positions after the prefill (``ring_pos``) and the flash launches of
    the prefill (0 on the CPU, where the plain version runs)."""
    T = 0 if decode is None else decode.shape[1]
    S, off = prompts.shape[1], _offset(cfg)
    drops = DropTally() if cfg.arch_type == "moe" else None
    n0 = ops.flash_attention.launches
    logits, cache = steps.make_prefill_step(cfg, cache_capacity=capacity)(
        params, {"tokens": prompts, **extra}, drops)
    flash = ops.flash_attention.launches - n0
    share = None if drops is None else drops.share()
    shapes, pos = {}, []
    map_with_path(cache, lambda path, leaf: shapes.__setitem__("/".join(path), tuple(leaf.shape)))
    map_with_path(cache, lambda path, leaf: pos.append(leaf.clone()) if path[-1] == "pos" else None)
    dec = []
    step = steps.make_decode_step(cfg)
    for t in range(T):
        lg, cache = step(params, cache, decode[:, t:t + 1], off + S + t)
        dec.append(lg)
    return {"prefill": logits, "decode": torch.stack(dec) if dec else None,
            "drop_share": share, "cache_shapes": shapes, "layouts": layouts(cfg, shapes),
            "ring_pos": pos[0] if pos else None, "prefill_flash_launches": flash}


def layouts(cfg, cache_shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Any]:
    """The layouts the ambient mesh gave ``cfg``, each None where whole: the
    embedding's and the LM head's split, and the KV rings' as the cache a
    prefill built holds them (``cache_shapes``, path -> a leaf's shape):
    ``"sequence"`` where a ring's k holds fewer slots than its ``pos``,
    ``"heads"`` where fewer kv heads than ``cfg``'s, else ``"replicated"``
    (rings laid out apart named together, comma-separated)."""
    if hints.model_size() == 1:
        return {"embed": None, "head": None, "kv cache": None}
    rings = set()
    for path, shape in cache_shapes.items():
        head, _, last = path.rpartition("/")
        if last == "k":
            slots = cache_shapes["/".join(filter(None, (head, "pos")))][0]
            rings.add("sequence" if shape[1] < slots else
                      "heads" if shape[2] < cfg.n_kv_heads else "replicated")
    return {"embed": table_split(cfg, True), "head": table_split(cfg, cfg.tie_embeddings),
            "kv cache": ",".join(sorted(rings)) or None}


def tp_job(rank: int, device: torch.device, *, arch: str, data: int, model: int,
           overrides: Dict[str, Any] = None, params: Any = None, seed: int = 0,
           tokens: np.ndarray = None, prompts: np.ndarray = None, decode: np.ndarray = None,
           inputs: Dict[str, np.ndarray] = None, serve: Dict[str, Any] = None,
           fault: str = None, capacity: int = None, on_cpu: bool = False) -> dict:
    """One model on a ``(data, model)`` host mesh of the world: its blocks
    of the reference's weights (``params``, numpy, through
    ``params_from_jax``) or of ``seeded_factory(seed)``; the rank's rows of
    ``tokens`` (the train forward's logits, its features and load-balance
    loss, under ``torch.no_grad``) and of ``prompts`` (a prefill, then the
    columns of ``decode`` teacher-forced; after ``serve`` too), each with the rank's rows of
    ``inputs`` (a VLM's ``patch_embeds``, an audio model's
    ``audio_frames``); with ``serve`` (``gen`` and ``dtype``),
    ``launch/serve.py``'s ``serve`` on the whole ``prompts``, timed after a
    warm-up call (its times, flash launches, peak memory, greedy tokens and
    logits, ``served``); with ``fault``, a planted fault in place (a
    factory's or a runtime one).  The rings hold ``capacity`` slots (by
    default serve's, or the prompt's and the forced steps').  Returns numpy
    arrays (the rank's rows, logits whole), the layouts the prefill's cache
    and the embedding ran in, and a digest of the arrays."""
    dev = torch.device("cpu") if on_cpu else device
    mesh = make_host_mesh(model, device_type=dev.type)
    if hints.axis_sizes(mesh)["data"] != data:
        raise ValueError(f"a world of {dist.get_world_size()} ranks has no (data {data}, "
                         f"model {model}) mesh")
    cfg = get_config(arch).replace(**(overrides or {}))
    blocks = _tp_params(cfg, mesh, dev, params, seed, fault)
    mdl = build_model(cfg)
    inputs = inputs or {}
    out: Dict[str, Any] = {"coords": hints.coords(mesh)}

    def rows(x):
        return local_rows(torch.as_tensor(x, device=dev), mesh)

    extra = {k: rows(v) for k, v in inputs.items()}
    # the rings' slots: serve's (its prompt and gen), or the forced steps'
    if prompts is not None and capacity is None:
        capacity = _offset(cfg) + prompts.shape[1] + (
            serve["gen"] if serve is not None else 0 if decode is None else decode.shape[1])
    with hints.use_mesh(mesh), torch.no_grad(), _planted(fault):
        if tokens is not None:
            batch = {"tokens": rows(tokens), **extra}
            fw = mdl.forward(blocks, batch)
            out["logits"], out["aux"] = fw.logits, fw.aux_loss
            out["features"] = mdl.extract_features(blocks, batch)
        if prompts is not None and serve is None:
            out.update(forced(cfg, blocks, rows(prompts),
                               None if decode is None else rows(decode), extra, capacity))
    if serve is not None:
        run = functools.partial(serve_mod.serve, arch, verbose=False, device=dev,
                                dtype=serve.get("dtype"), params=blocks,
                                prompts=torch.as_tensor(prompts, device=dev), mesh=mesh,
                                overrides=overrides,
                                **{k: torch.as_tensor(v, device=dev) for k, v in inputs.items()})
        run(gen=2)  # a rank's first call loads the card's libraries and kernels: not timed
        res = run(gen=serve["gen"])
        out["served"] = res.logits
        out["serve"] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                        "prefill_launches": res.prefill_launches,
                        "decode_launches": res.decode_launches, "peak_bytes": res.peak_bytes,
                        "drop_share": res.prefill_drop_share}
        out["tokens"] = res.tokens
        with hints.use_mesh(mesh), torch.no_grad():
            out.update(forced(cfg.replace(dtype=serve.get("dtype") or cfg.dtype), blocks,
                               rows(prompts), None if decode is None else rows(decode), extra,
                               capacity))
    del blocks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = np_({k: (v.float() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
               for k, v in out.items()})
    out["digest"] = digest({k: v for k, v in out.items()
                            if k not in ("serve", "coords", "layouts", "cache_shapes")})
    return out


# the cross-attention whose (k, v) the rules split over the encoder's
# frames at "model" 2 and 4: Whisper's smoke with 3 kv heads (neither 2 nor
# 4 divides them; its 32 frames split)
CROSS_SPLIT = dict(arch="whisper-large-v3-smoke",
                   overrides={"n_heads": 3, "n_kv_heads": 3, "dtype": "float32"}, B=4, S0=8, T=3)


def cross_split_batch(seed: int = 17) -> Dict[str, np.ndarray]:
    """:data:`CROSS_SPLIT`'s seeded batch: tokens (B, S0 + T) and the
    encoder's 0.1·N(0, 1) frames."""
    cfg = get_config(CROSS_SPLIT["arch"]).replace(**CROSS_SPLIT["overrides"])
    rng = np.random.default_rng(seed)
    B, S = CROSS_SPLIT["B"], CROSS_SPLIT["S0"] + CROSS_SPLIT["T"]
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
            "audio_frames": (0.1 * rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
                             ).astype(np.float32)}


def tp_refusals(rank: int, device: torch.device) -> dict:
    """What stays refused under "model" 2, as (exception type, message):
    Scaffold's rounds under the psum backend (its cvar scatter needs the
    whole cohort, as in the reference); and the layout refused until the
    sharded cross-attention learned it, which now runs: :data:`CROSS_SPLIT`
    from ``seeded_factory(0)`` on :func:`cross_split_batch` over (data
    world / 2, model 2), its (k, v) split over the frames (:func:`tp_job`'s
    prefill and teacher-forced decode; every rank's result, in rank order,
    on every rank)."""
    mesh2 = make_host_mesh(2, device_type=device.type)
    batch = cross_split_batch()
    S0 = CROSS_SPLIT["S0"]
    split = tp_job(rank, device, arch=CROSS_SPLIT["arch"], data=dist.get_world_size() // 2,
                   model=2, overrides=CROSS_SPLIT["overrides"], seed=0,
                   prompts=batch["tokens"][:, :S0], decode=batch["tokens"][:, S0:],
                   inputs={"audio_frames": batch["audio_frames"]})
    everyone: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, split)
    return {
        "scaffold under psum": _raises(train.run, TRAIN_ARCH, rounds=1, use_fed3r_init=False,
                                       algorithm="scaffold", device=device, mesh=mesh2,
                                       verbose=False, **TRAIN),
        "cross-attention split": everyone,
    }


def tp_train_phase1(rank: int, device: torch.device, model: int) -> dict:
    """``train.run``'s phase 1 over a host mesh with a "model" axis: the
    feature pass tensor-parallel, the statistics over the data axis."""
    mesh = make_host_mesh(model, device_type=device.type)
    got = train.run(TRAIN_ARCH, device=device, mesh=mesh, verbose=False, **TRAIN)
    return np_({"A": got["stats"].A, "b": got["stats"].b, "W": got["W"],
                "acc": got["fed3r_acc"]})


def tp_program(rank: int, world: int, device: torch.device, jobs: Sequence[dict],
               refusals: bool = False, train_model: int = 0) -> dict:
    """Each job of ``jobs`` (keyword arguments of :func:`tp_job`, plus its
    ``name``) on this rank (rank 0 prints each job's seconds); with
    ``refusals`` :func:`tp_refusals`, with ``train_model`` > 0
    :func:`tp_train_phase1` at that model axis."""
    out: Dict[str, Any] = {}
    for job in jobs:
        job = dict(job)
        name = job.pop("name")
        t0 = time.perf_counter()
        out[name] = tp_job(rank, device, **job)
        if rank == 0:
            print(f"[tp] rank 0: {name} in {time.perf_counter() - t0:.1f}s", flush=True)
    if refusals:
        out["refusals"] = tp_refusals(rank, device)
    if train_model:
        out["train"] = tp_train_phase1(rank, device, train_model)
    return out


# ---------------------------------------------------------------------------
# the backward under a "model" axis
# ---------------------------------------------------------------------------

# planted faults of the gradient convention (sharding/hints.py, pieces 1-3)
GRAD_FAULTS = ("reduce backward identity in the last layer", "replicated sum skipped",
               "loss seeded on every rank")
# planted faults of FSDP's gradient: the gather's backward keeps the rank's
# block of the cotangent unsummed over the data ranks; an FSDP leaf's
# gradient, already their sum, all-reduced and divided over them again
FSDP_FAULTS = ("reduce-scatter keeps the block unsummed", "FSDP leaf averaged twice over data")


class _SumNoBackward(torch.autograd.Function):
    """``real(x)`` (an all-reduce) forward, the identity backward: a
    planted fault of piece 1."""

    @staticmethod
    def forward(x, real):
        return real(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


def _n_blocks(cfg) -> int:
    return cfg.n_layers + (cfg.n_encoder_layers if cfg.arch_type == "audio" else 0)


@contextlib.contextmanager
def _last_layer_reduce_identity(cfg):
    """Over one gradient of the whole model: the last layer's recompute
    (call N of ``block_apply`` after the forward's N, the first block the
    backward runs) with ``hints.reduce_model``'s backward the identity."""
    real_block, real_reduce = tfm_mod.block_apply, hints.reduce_model
    calls = [0]

    def planted(*args, **kw):
        calls[0] += 1
        if calls[0] != _n_blocks(cfg) + 1:
            return real_block(*args, **kw)
        hints.reduce_model = lambda x: _SumNoBackward.apply(x, real_reduce)
        try:
            return real_block(*args, **kw)
        finally:
            hints.reduce_model = real_reduce

    tfm_mod.block_apply = planted
    try:
        yield
    finally:
        tfm_mod.block_apply = real_block


@contextlib.contextmanager
def _unsummed_reduce_scatter():
    """Over the block: the FSDP gather's backward narrows the cotangent to
    the rank's block without summing it over the data ranks."""
    real = hints._reduce_scatter

    def planted(g, dim, axes):
        n, i = hints._axes_block(axes)
        k = g.shape[dim] // n
        return g.narrow(dim, i * k, k).clone()

    hints._reduce_scatter = planted
    try:
        yield
    finally:
        hints._reduce_scatter = real


# the faults planted after the loss gradient: a run with one of them
# finishes the sound run's loss gradient (the same bits) with the fault
_AFTER_GRAD = (GRAD_FAULTS[1], FSDP_FAULTS[1])


def loss_grad(cfg, blocks: Any, batch: Dict[str, torch.Tensor], fault: str = None) -> Any:
    """The rank's gradient of ``cfg``'s ``lm_loss`` over the global batch
    under the ambient mesh (``blocks`` the rank's blocks, ``batch`` its
    rows; under FSDP the FSDP layout's), the loss seeded once over
    "model", before any sum of a leaf over the ranks; with ``fault`` (one
    of :data:`GRAD_FAULTS` or :data:`FSDP_FAULTS` not in ``_AFTER_GRAD``)
    planted."""
    model = build_model(cfg)

    def loss(p):
        value = model.loss(p, batch)
        return value if fault == GRAD_FAULTS[2] else hints.seed_loss(value)

    with (_last_layer_reduce_identity(cfg) if fault == GRAD_FAULTS[0]
          else _unsummed_reduce_scatter() if fault == FSDP_FAULTS[0]
          else contextlib.nullcontext()):
        return torch.func.grad(loss)(blocks)


def finish_gradient(cfg, grads: Any, fault: str = None) -> Any:
    """:func:`loss_grad`'s ``grads`` with the replicated leaves' gradients
    summed over "model", then the mean over the data ranks (an FSDP leaf's
    only divided); with ``fault`` (one of ``_AFTER_GRAD``) planted.
    ``grads`` is not written."""
    if fault != GRAD_FAULTS[1]:
        grads = hints.sum_replicated(grads, replicated_leaves(cfg, hints.model_size()))
    summed = None
    if hints.fsdp_axes() and fault != FSDP_FAULTS[1]:
        summed = fsdp_leaves(cfg, hints.axis_sizes())
    return hints.mean_data(grads, summed)


def grad_batch(cfg, seed: int = 0, B: int = 2, S: int = 8) -> Dict[str, np.ndarray]:
    """A seeded batch of ``lm_loss``: tokens, their next tokens as labels, a
    VLM's 0.1·N(0, 1) patches or an audio model's frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = (0.1 * rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                               ).astype(np.float32)
    if cfg.arch_type == "audio":
        out["audio_frames"] = (0.1 * rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
                               ).astype(np.float32)
    return out


def _rows(batch: Dict[str, np.ndarray], mesh, dev) -> Dict[str, torch.Tensor]:
    return {k: local_rows(torch.as_tensor(v, device=dev), mesh) for k, v in batch.items()}


def loss_gradient(arch: str, mesh: Any, device: torch.device, params: Any = None,
                  **kw) -> Any:
    """The rank's gradient of ``arch``'s ``lm_loss`` in fp32 under ``mesh``
    (:func:`loss_grad`, then :func:`finish_gradient`): its blocks of the
    reference's weights ``params``, numpy, or of ``seeded_factory(0)``, on
    :func:`grad_batch`'s batch (``kw``: its seed, B and S)."""
    cfg = get_config(arch).replace(dtype="float32")
    params = _tp_params(cfg, mesh, device, params, 0, None)
    with hints.use_mesh(mesh):
        return finish_gradient(cfg, loss_grad(cfg, params, _rows(grad_batch(cfg, **kw), mesh,
                                                                  device)))


def gathered_gradient(cfg, grads: Any, mesh: Any, fsdp: bool = False) -> Any:
    """A rank's gradient (or parameters) gathered over "model" (and under
    ``fsdp`` the data axes) into whole leaves, numpy (a collective every
    rank joins)."""
    return np_(gather_params(cfg, grads, mesh, fsdp))


def _unsharded_blocks(cfg, seed: int, batch: Dict[str, np.ndarray], mesh,
                      dev, fsdp: bool = False) -> Tuple[Dict[tuple, torch.Tensor], dict]:
    """({key path: this rank's block of the unsharded gradient, on the
    host}, its ms and peak on global rank 0): rank 0 alone makes
    ``seeded_factory(seed)``'s weights whole on ``dev``, takes the plain
    gradient of ``lm_loss`` on the whole batch, keeps it on the host and
    frees the device; then it scatters each leaf's blocks (under ``fsdp``
    the FSDP layout's) to the ranks that hold them (gloo takes host
    tensors)."""
    sizes, rank = hints.axis_sizes(mesh), dist.get_rank()
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, hints.coords(mesh))
    meta, specs = leaf_specs(cfg, sizes, fsdp)
    whole, info = {}, {}
    if rank == 0:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = full_params(cfg, seeded_factory(seed), dev)
        model = build_model(cfg)
        grads = torch.func.grad(lambda p: model.loss(
            p, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}))(params)
        del params
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        info = {"ms": 1e3 * (time.perf_counter() - t0),
                "peak_bytes": torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None}
        map_with_path(grads, lambda path, g: whole.__setitem__(path, g.cpu()))
        del grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    blocks = {}

    def scatter(path, leaf):
        index = [specs[path].index(tuple(leaf.shape), w, sizes) for w in where]
        blocks[path] = torch.empty(leaf[index[rank]].shape, dtype=leaf.dtype)
        dist.scatter(blocks[path], [whole[path][i].contiguous() for i in index]
                     if rank == 0 else None, src=0)

    map_with_path(meta, scatter)
    return blocks, info


def _gaps(grads: Any, ref: Dict[tuple, torch.Tensor]) -> Dict[str, Any]:
    """{path: (max|g - g₀|, max|g₀|)} of every leaf over the world: each
    rank compares its block ``grads`` with its block ``ref`` of the
    unsharded gradient on its device, and one all-reduce takes the
    maxima."""
    paths, found = [], []
    map_with_path(grads, lambda path, g: (paths.append(path), found.append(g)))
    stats = torch.zeros((2, len(paths)), dtype=torch.float64)
    for i, (path, g) in enumerate(zip(paths, found)):
        # one copy of the block on the device, the difference taken in place
        want = ref[path].to(g.device, copy=True)
        stats[1, i] = float(torch.linalg.vector_norm(want, math.inf))
        stats[0, i] = float(torch.linalg.vector_norm(want.sub_(g), math.inf))
        del want
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    return {"/".join(p): (float(stats[0, i]), float(stats[1, i])) for i, p in enumerate(paths)}


def tp_grad_job(rank: int, device: torch.device, *, arch: str, data: int, model: int,
                overrides: Dict[str, Any] = None, params: Any = None, seed: int = 0,
                batch: Dict[str, np.ndarray] = None, faults: Sequence[str] = (),
                reference: bool = False, fsdp: bool = False) -> dict:
    """``lm_loss``'s gradient of one model on a ``(data, model)`` host mesh:
    its blocks of the reference's weights (``params``, numpy) or of
    ``seeded_factory(seed)``, the rank's rows of ``batch``; then again with
    each of ``faults`` planted (those planted after the loss gradient
    finish the sound run's).  Returns, for the sound run and each fault,
    the gradient gathered over "model" (``"grads"``, numpy, on global rank
    0; a digest on every rank), or with ``reference`` the leaf-by-leaf gaps
    to the unsharded gradient, which rank 0 computed first and scattered
    (``gaps``, each (max|Δ|, max|g|)), each run's ms and every rank's peak
    memory (allocated and reserved).  With ``fsdp`` the blocks and the
    gradient are the FSDP layout's."""
    cfg = get_config(arch).replace(**(overrides or {}))
    mesh = make_host_mesh(model, device_type=device.type)
    if hints.axis_sizes(mesh)["data"] != data:
        raise ValueError(f"a world of {dist.get_world_size()} ranks has no (data {data}, "
                         f"model {model}) mesh")
    out: Dict[str, Any] = {"coords": hints.coords(mesh)}
    ref = None
    if reference:  # before any rank holds a block
        ref, out["unsharded"] = _unsharded_blocks(cfg, seed, batch, mesh, device, fsdp)
    blocks = _tp_params(cfg, mesh, device, params, seed, None, fsdp)
    rows = _rows(batch, mesh, device)
    # the faults that finish the sound run's loss gradient run first, so
    # that it is dropped before any other run takes its own
    faults = sorted(faults, key=lambda f: f not in _AFTER_GRAD)
    n_after = sum(f in _AFTER_GRAD for f in faults)
    sound = None  # the sound run's loss gradient, which the _AFTER_GRAD faults finish
    for i, fault in enumerate([None] + faults):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with hints.use_mesh(mesh, fsdp=fsdp):
            raw = sound if fault in _AFTER_GRAD else loss_grad(cfg, blocks, rows, fault)
            if fault is None and n_after:
                sound = raw
            grads = finish_gradient(cfg, raw, fault)
            del raw
            if i == n_after:
                sound = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        cuda = device.type == "cuda"
        run = {"ms": 1e3 * (time.perf_counter() - t0),
               "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
               "reserved_bytes": torch.cuda.max_memory_reserved(device) if cuda else None}
        if reference:
            t0 = time.perf_counter()
            run["gaps"] = _gaps(grads, ref)
            run["gaps_ms"] = 1e3 * (time.perf_counter() - t0)
        else:
            gathered = gathered_gradient(cfg, grads, mesh, fsdp)
            run["digest"] = digest(gathered)
            run["grads"] = gathered if rank == 0 else None
        out[fault or "sound"] = run
        del grads
    del blocks, ref, sound
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _counting_vmap_rule():
    """Counts, over the block, the calls of the collectives' ``vmap`` rule
    (``hints._Sum.vmap``): in all, and those made inside a block
    recompute's backward (``transformer._Recompute.backward``)."""
    calls = {"all": 0, "in a recompute": 0}
    inside = [0]
    real_rule, real_backward = hints._Sum.vmap, tfm_mod._Recompute.backward

    def rule(info, in_dims, *args):
        calls["all"] += 1
        calls["in a recompute"] += inside[0] > 0
        return real_rule(info, in_dims, *args)

    def backward(ctx, *grads):
        inside[0] += 1
        try:
            return real_backward(ctx, *grads)
        finally:
            inside[0] -= 1

    hints._Sum.vmap, tfm_mod._Recompute.backward = staticmethod(rule), staticmethod(backward)
    try:
        yield calls
    finally:
        hints._Sum.vmap = staticmethod(real_rule)
        tfm_mod._Recompute.backward = staticmethod(real_backward)


def tp_round_job(rank: int, device: torch.device, *, arch: str, model: int, params: Any,
                 head: Dict[str, np.ndarray], clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                 client_ids: np.ndarray, algorithm: str, lr: float, local_batch_size: int,
                 n_batches: int, seed: Tuple[int, int], n_clients: int,
                 overrides: Dict[str, Any] = None) -> dict:
    """One ``RoundEngine.step`` of FT (everything trains) on a
    ``(data, model)`` host mesh, as ``launch/train.py`` runs it: the rank's
    blocks of the reference's weights (``params``, numpy) and the head
    replicated, the layers on the "model" axis, the cohort's clients packed
    from ``clients`` and split over "data".  Returns the new backbone
    gathered over "model" and the head (numpy, on global rank 0), a digest
    of the leaves every model rank holds whole, and the calls of the
    collectives' ``vmap`` rule the round made (:func:`_counting_vmap_rule`)."""
    mesh = make_host_mesh(model, device_type=device.type)
    cfg = get_config(arch).replace(**(overrides or {}))
    blocks = shard_params(cfg, params_from_jax(cfg, params, device), mesh)
    engine = train.ft_engine(cfg, blocks, n_clients=n_clients, lr=lr, algorithm=algorithm,
                             ft_strategy="full", mesh=mesh)
    state = engine.init({"backbone": blocks,
                         "head": {k: torch.as_tensor(v, device=device) for k, v in head.items()}})
    cohort = pack_cohort_batches(clients, local_batch_size, n_batches, client_ids=client_ids,
                                 seed=seed, mesh=mesh)
    with hints.use_mesh(mesh["model"]), _counting_vmap_rule() as calls:
        state = engine.step(state, cohort)
    backbone = gathered_gradient(cfg, state.params["backbone"], mesh)
    rep = []
    tree_map(lambda x, r: rep.append(x) if r else None, state.params,
             {"backbone": replicated_leaves(cfg, model), "head": {"W": True, "b": True}})
    return {"coords": hints.coords(mesh), "replicated": digest(np_(rep)), "vmap_rule": calls,
            "params": {"backbone": backbone, "head": np_(state.params["head"])}
            if rank == 0 else None}


def tp_ft_job(rank: int, device: torch.device, *, arch: str, model: int, run: Dict[str, Any],
              root: str = None) -> dict:
    """``launch/train.py``'s ``run`` over the world's host mesh with a
    "model" axis of ``model``: phase 1 alone first (its statistics, numpy
    on global rank 0, and fed3r_stats launches); then ``run`` (its FT rounds):
    each round's ms, every rank's peak memory, the final backbone gathered
    over "model" and the head (numpy, on global rank 0), a digest of the
    leaves every model rank holds whole; with ``root``, a run of one round
    checkpointed into ``root`` (by global rank 0) and its resume to
    ``run["rounds"]``: whether the resumed state equals the uninterrupted
    one bitwise on this rank, and the checkpoint's backbone shapes."""
    mesh = make_host_mesh(model, device_type=device.type)
    cfg = get_config(arch)
    kw = dict(run, device=device, mesh=mesh, verbose=False)
    out: Dict[str, Any] = {"coords": hints.coords(mesh)}
    launches = ops.fed3r_stats.launches
    stats = train.run(arch, **dict(kw, rounds=0, use_fed3r_init=True))["stats"]
    out["fed3r_launches"] = ops.fed3r_stats.launches - launches
    out["stats"] = np_({"A": stats.A, "b": stats.b}) if rank == 0 else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    got = train.run(arch, **kw)
    state = got["ft"]["state"]
    out["round_ms"] = got["ft"]["round_ms"]
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                         else None)
    rep = []
    tree_map(lambda x, r: rep.append(x) if r else None, state.params,
             {"backbone": replicated_leaves(cfg, model), "head": {"W": True, "b": True}})
    out["replicated"] = digest(np_(rep))
    backbone = gathered_gradient(cfg, state.params["backbone"], mesh)
    if rank == 0:
        out["params"] = {"backbone": backbone, "head": np_(state.params["head"])}
    if root is not None:
        train.run(arch, **dict(kw, rounds=1), ckpt_dir=root)
        resumed = train.run(arch, **kw, ckpt_dir=root, resume=True)["ft"]
        out["resume_bitwise"] = all(torch.equal(a, b) for a, b in
                                    zip(tree_leaves(state), tree_leaves(resumed["state"])))
        out["resumed_rounds"] = len(resumed["round_ms"])
        if rank == 0:
            from repro_torch.checkpoint import load_pytree

            snap = load_pytree(os.path.join(root, "ckpt_1.npz"))
            shapes = {}
            map_with_path(snap["params"]["backbone"],
                          lambda path, x: shapes.__setitem__("/".join(path), tuple(x.shape)))
            out["checkpoint_shapes"] = shapes
    return out


def tp_step_job(rank: int, device: torch.device, *, arch: str, model: int, params: Any,
                batch: Dict[str, np.ndarray], lr: float, num_microbatches: int,
                overrides: Dict[str, Any] = None, fsdp: bool = False) -> dict:
    """One ``steps.make_train_step`` step on a ``(data, model)`` host mesh:
    the rank's blocks of the reference's weights (``params``, numpy; in the
    FSDP layout with ``fsdp``) and its rows of ``batch``.  Returns the new
    parameters gathered whole (numpy, on global rank 0) and the loss."""
    mesh = make_host_mesh(model, device_type=device.type)
    cfg = get_config(arch).replace(**(overrides or {}))
    blocks = shard_params(cfg, params_from_jax(cfg, params, device), mesh, fsdp)
    step = steps.make_train_step(cfg, lr=lr, num_microbatches=num_microbatches)
    with hints.use_mesh(mesh, fsdp=fsdp):
        new, loss = step(blocks, _rows(batch, mesh, device))
    whole = gathered_gradient(cfg, new, mesh, fsdp)
    return {"loss": float(loss), "params": whole if rank == 0 else None}


def tp_train_program(rank: int, world: int, device: torch.device, grads: Sequence[dict] = (),
                     rounds: Sequence[dict] = (), ft: Sequence[dict] = (),
                     train_steps: Sequence[dict] = (), refusals: bool = False) -> dict:
    """Each job of ``grads`` (keyword arguments of :func:`tp_grad_job`),
    ``rounds`` (of :func:`tp_round_job`), ``ft`` (of :func:`tp_ft_job`) and
    ``train_steps`` (of :func:`tp_step_job`), each with its ``name`` (rank 0
    prints each job's seconds as it ends); with ``refusals``
    :func:`tp_refusals`."""
    out: Dict[str, Any] = {}
    for fn, jobs in ((tp_grad_job, grads), (tp_round_job, rounds), (tp_ft_job, ft),
                     (tp_step_job, train_steps)):
        for job in jobs:
            job = dict(job)
            name = job.pop("name")
            t0 = time.perf_counter()
            out[name] = fn(rank, device, **job)
            if rank == 0:
                print(f"[tp-train] rank 0: {name} in {time.perf_counter() - t0:.1f}s",
                      flush=True)
    if refusals:
        out["refusals"] = tp_refusals(rank, device)
    return out


# ---------------------------------------------------------------------------
# FSDP, and the dry run's rank program on real ranks
# ---------------------------------------------------------------------------


def fsdp_serve_job(rank: int, device: torch.device, *, arch: str, data: int, model: int,
                   overrides: Dict[str, Any] = None, seed: int = 0, prompts: np.ndarray,
                   decode: np.ndarray, inputs: Dict[str, np.ndarray] = None) -> dict:
    """A prefill of ``prompts`` (with the rank's rows of ``inputs``: a VLM's
    ``patch_embeds``, an audio model's ``audio_frames``) and ``decode``'s
    columns teacher-forced on a ``(data, model)`` host mesh, in the TP-only
    layout and in the FSDP layout, each from ``seeded_factory(seed)``'s
    blocks cast to the compute dtype (bf16 weights serve a bf16 model, as
    the dry run's serving steps hold them): both runs' logits (the rank's
    rows, numpy fp32), the collectives of each, their flash_attention
    launches and the ms of each run."""
    mesh = make_host_mesh(model, device_type=device.type)
    if hints.axis_sizes(mesh)["data"] != data:
        raise ValueError(f"a world of {dist.get_world_size()} ranks has no (data {data}, "
                         f"model {model}) mesh")
    cfg = get_config(arch).replace(**(overrides or {}))
    rows = _rows({"prompts": prompts, "decode": decode}, mesh, device)
    extra = _rows(inputs or {}, mesh, device)
    capacity = _offset(cfg) + prompts.shape[1] + decode.shape[1]
    dt, out = compute_dtype(cfg), {}
    for fsdp in (False, True):
        name = "fsdp" if fsdp else "tp"
        blocks = tree_map(lambda t: t.to(dt), _tp_params(cfg, mesh, device, None, seed, None, fsdp))
        launches = ops.flash_attention.launches
        t0 = time.perf_counter()
        with hints.use_mesh(mesh, fsdp=fsdp), torch.no_grad(), hints.census() as recs:
            got = forced(cfg, blocks, rows["prompts"], rows["decode"], extra, capacity)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[f"ms {name}"] = 1e3 * (time.perf_counter() - t0)
        out[f"flash {name}"] = ops.flash_attention.launches - launches
        out[name] = np_({k: got[k].float() for k in ("prefill", "decode")})  # bf16 exactly
        out[f"census {name}"] = [tuple(r) for r in recs]
        del blocks, got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _dryrun_on(mesh: Any, device: torch.device, *, arch: str, shape: Dict[str, Any],
               kind: str = None, overrides: Dict[str, Any] = None, fsdp: bool = None) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    shp = ShapeConfig(**shape)
    rec = dryrun.plan(arch, shp, hints.axis_sizes(mesh), kind, overrides, fsdp)
    cfg = rec.pop("cfg")
    prog = dryrun.rank_program(cfg, rec["kind"], shp, mesh, device, rec["fsdp"],
                               rec["num_microbatches"], count=False)
    prog["census"] = [tuple(r) for r in prog["census"]]
    return dict(prog, plan=rec)


def dryrun_job(rank: int, device: torch.device, *, data: int, model: int, **job) -> dict:
    """The dry run's rank program (``launch/dryrun.py::rank_program``) of
    one combination on a real ``(data, model)`` host mesh: what a dry run
    over a fake world is held against.  ``job``: ``arch``, ``shape`` (a
    ``ShapeConfig``'s fields), and optionally ``kind``, ``overrides`` and
    ``fsdp``, as ``dryrun.plan`` takes them.  Returns its census (as
    tuples), peak memory, times and kernel launches, and the plan's
    decisions."""
    mesh = make_host_mesh(model, device_type=device.type)
    if hints.axis_sizes(mesh)["data"] != data:
        raise ValueError(f"a world of {dist.get_world_size()} ranks has no (data {data}, "
                         f"model {model}) mesh")
    return _dryrun_on(mesh, device, **job)


def fake_world_jobs(sizes: Dict[str, int], ranks: Sequence[int], jobs: Sequence[dict],
                    device: str = "cpu") -> Dict[int, dict]:
    """The dry run itself, in this process: for each of ``ranks``, that rank
    of a fake world of axis ``sizes`` (``make_dryrun_mesh``) runs each job
    (its ``name`` and :func:`dryrun_job`'s ``job`` keywords); the world is
    torn down after each rank.  Returns {rank: {name: the job's result}}."""
    from repro_torch.launch.mesh import make_dryrun_mesh

    dev = torch.device(device)
    out: Dict[int, dict] = {}
    for r in ranks:
        mesh = make_dryrun_mesh(rank=r, device_type=dev.type, sizes=sizes)
        try:
            out[r] = {job["name"]: _dryrun_on(mesh, dev, **{k: v for k, v in job.items()
                                                          if k != "name"})
                      for job in jobs}
        finally:
            dist.destroy_process_group()
    return out


def moe_groups_job(rank: int, device: torch.device, *, arch: str, params: Any,
                   tokens: np.ndarray, overrides: Dict[str, Any] = None) -> dict:
    """An MoE model's train forward on the multi-pod host mesh (pod 2, data
    world / 4, model 1) from the reference's weights (``params``, numpy)
    on the rank's rows of ``tokens``: G = the "data" axis capacity groups
    over 2·G data ranks, so a group spans two ranks and the second's
    positions start after the first's counts.  Returns the logits (the
    rank's rows) and the drop share over the data ranks."""
    mesh = make_host_mesh(1, pods=2, device_type=device.type)
    cfg = get_config(arch).replace(**(overrides or {}))
    blocks = shard_params(cfg, params_from_jax(cfg, params, device), mesh)
    drops = DropTally()
    with hints.use_mesh(mesh), torch.no_grad():
        fw = build_model(cfg).forward(blocks, {"tokens": _rows({"t": tokens}, mesh, device)["t"]},
                                      drops=drops)
    return {"logits": np_(fw.logits), "drop_share": drops.share()}


def gather_vmap_job(rank: int, device: torch.device, *, model: int) -> dict:
    """``hints.gather_data`` and its gradient under ``torch.func.vmap`` on a
    ``(data, model)`` host mesh under FSDP: a batch of 3 rank-specific
    blocks gathered along dim 1, mapped and looped (numpy), and the
    gradient of a sum of squares through it, mapped and looped."""
    mesh = make_host_mesh(model, device_type=device.type)
    x = torch.arange(3 * 2 * 4, dtype=torch.float32, device=device).reshape(3, 2, 4) + 100 * rank

    def loss(t):
        return (hints.gather_data(t, 1) ** 2).sum()

    with hints.use_mesh(mesh, fsdp=True):
        out = {"looped": torch.stack([hints.gather_data(t, 1) for t in x]),
               "mapped": torch.func.vmap(lambda t: hints.gather_data(t, 1))(x),
               "grad looped": torch.stack([torch.func.grad(loss)(t) for t in x]),
               "grad mapped": torch.func.vmap(torch.func.grad(loss))(x)}
    return np_(out)


def combine_job(rank: int, device: torch.device, *, model: int, seed: int = 0,
                below: float = 1e4) -> dict:
    """``attention._cp_combine`` on a ``(data, model)`` host mesh against
    the whole softmax · v: every rank draws the same scores (2, 3, 8·model)
    and values (2, 8·model, 16) from ``seed``, model rank 1's keys scored
    ``below`` under the others' (its scale underflows to 0), takes its
    block of the keys, and combines its pieces with the others'.  Returns
    the combined and the whole result (numpy) and whether the combine is
    finite."""
    mesh = make_host_mesh(model, device_type=device.type)
    gen = torch.Generator().manual_seed(seed)
    n = 8
    s = torch.randn((2, 3, n * model), generator=gen)
    v = torch.randn((2, n * model, 16), generator=gen)
    s[..., n:2 * n] -= below
    s, v = s.to(device), v.to(device)
    want = torch.softmax(s, dim=-1) @ v
    r = hints.coords(mesh)["model"]
    sr, vr = s[..., r * n:(r + 1) * n], v[:, r * n:(r + 1) * n]
    m = sr.amax(dim=-1, keepdim=True)
    p = torch.exp(sr - m)
    with hints.use_mesh(mesh):
        got = attn_mod._cp_combine(m, p.sum(dim=-1, keepdim=True), p @ vr)
    return {"got": np_(got), "want": np_(want), "finite": bool(torch.isfinite(got).all())}


_FSDP_JOBS = {"grad": tp_grad_job, "step": tp_step_job, "serve": fsdp_serve_job,
              "dryrun": dryrun_job, "moe_groups": moe_groups_job, "gather_vmap": gather_vmap_job,
              "tp": tp_job, "combine": combine_job}


def fsdp_program(rank: int, world: int, device: torch.device, jobs: Sequence[dict],
                 card_share: Sequence[float] = None) -> dict:
    """Each job of ``jobs`` on this rank: its ``name``, its ``job`` (a key
    of ``_FSDP_JOBS``: "grad" :func:`tp_grad_job`, "step"
    :func:`tp_step_job`, "serve" :func:`fsdp_serve_job`, "dryrun"
    :func:`dryrun_job`, "moe_groups" :func:`moe_groups_job`, "gather_vmap"
    :func:`gather_vmap_job`, "tp" :func:`tp_job`, "combine"
    :func:`combine_job`) and that function's keyword arguments (rank 0
    prints each job's seconds).  ``card_share`` (ranks sharing one card):
    the share of the card's memory rank r's allocator may hold, by rank;
    past it the allocator frees its own cache before it fails, so that no
    rank's cache starves another."""
    if card_share is not None and device.type == "cuda":
        torch.cuda.set_per_process_memory_fraction(card_share[rank], device)
    out: Dict[str, Any] = {}
    for job in jobs:
        job = dict(job)
        name, fn = job.pop("name"), _FSDP_JOBS[job.pop("job")]
        t0 = time.perf_counter()
        out[name] = fn(rank, device, **job)
        if rank == 0:
            print(f"[fsdp] rank 0: {name} in {time.perf_counter() - t0:.1f}s", flush=True)
    return out
