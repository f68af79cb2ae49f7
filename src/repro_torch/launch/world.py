"""Starting the ranks of a ``torch.distributed`` world.

The port runs one process per rank where the reference runs one SPMD
program per device (on the CPU over simulated host devices,
``XLA_FLAGS=--xla_force_host_platform_device_count``).  This module starts
those processes and their process group:

* :func:`init_world` — inside a process that ``torchrun`` (``python -m
  torch.distributed.run``) started: reads ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` and joins the group over ``env://``;
* :func:`run_world` — spawns ``world_size`` ranks on one host over a
  ``file://`` store in a private temporary directory, runs ``fn(rank,
  world_size, *args)`` in each, and returns every rank's result;
* :func:`single_rank_world` — a world of one rank in the calling process,
  for running the collective paths without spawning (the tests, and the
  NCCL run of ``chip_smoke.py`` on one card).

The caller always names the backend (``"nccl"`` or ``"gloo"``): nothing here
picks one, and nothing falls back to another when the named one fails.
Every group is created with a timeout, so a collective that cannot complete
raises instead of hanging, and :func:`run_world` joins its ranks against a
deadline and kills any still running after it.  NCCL takes one card a rank
("Duplicate GPU detected" otherwise); several ranks sharing one card run
gloo, which stages CUDA tensors through the host and implements only
``all_reduce`` and ``broadcast`` for them, the two collectives the dist
layer uses.

A spawned rank imports ``fn`` by its module path, so ``fn`` lives in an
importable module of the port (never in a test module, which would import
the reference package into every rank).
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.federated.dist import resolve_device

BACKENDS = ("nccl", "gloo")


def _check_backend(backend: str, device: str) -> torch.device:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend reduces CUDA tensors: pass device='cuda'")
    return dev


def _bind_device(dev: torch.device, local_rank: int) -> torch.device:
    """The rank's card: local rank modulo the cards this host has."""
    if dev.type != "cuda":
        return dev
    card = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return torch.device("cuda", card)


def init_world(backend: str, device: str = "cuda", *, timeout_s: float = 600.0) -> torch.device:
    """Join the world ``torchrun`` started; returns this rank's device.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (``MASTER_ADDR`` and
    ``MASTER_PORT`` through ``env://``), as ``torchrun`` sets them.
    """
    dev = _check_backend(backend, device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = _bind_device(dev, int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


@contextlib.contextmanager
def single_rank_world(backend: str, device: str = "cuda", *,
                      timeout_s: float = 120.0) -> Iterator[torch.device]:
    """A world of one rank in this process, torn down on exit."""
    dev = _bind_device(_check_backend(backend, device), 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _rank_main(fn, rank, world_size, backend, device, store, timeout_s, results):
    """One spawned rank: read ``fn``'s arguments from ``store + ".args"``,
    join the group, run ``fn``, write its result to ``store + ".<rank>"``,
    report, leave."""
    try:
        with open(store + ".args", "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(1)
        dev = _bind_device(torch.device(device), rank)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            out = fn(rank, world_size, dev, *args)
        finally:
            dist.destroy_process_group()
        # pickled whole into a file (a tensor put on the queue as it is
        # would travel as a handle to this process's memory, gone once it
        # exits); the queue carries only its name: a pipe moves a large
        # result to the parent an order of magnitude slower than a file
        path = f"{store}.{rank}"
        with open(path, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        results.put((rank, True, path))
    except BaseException:  # reported to the parent, which re-raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(
    fn: Callable[..., Any],
    world_size: int,
    *,
    backend: str,
    device: str = "cuda",
    timeout_s: float = 300.0,
    args: Sequence[Any] = (),
) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` spawned
    ranks of one world; returns the ranks' results in rank order.

    Each rank sets ``torch.set_num_threads(1)``, binds its card (local rank
    modulo the host's cards) and joins the group over a ``file://`` store
    in a temporary directory.  The parent waits at most ``timeout_s``
    seconds in all; a rank that raised has its traceback re-raised here as
    ``RuntimeError``, and every rank still alive then is killed.  ``args``
    and the results travel pickled (CPU tensors, numpy arrays and plain
    Python values) through files in that directory: a spawned process
    receives its start-up data through a pipe, and one larger than the
    pipe's buffer makes each start wait for the previous rank to import
    its modules.
    """
    _check_backend(backend, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        with open(store + ".args", "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, r, world_size, backend, device, store, timeout_s, results),
                daemon=True,
            )
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        got: dict = {}
        failure = None
        try:
            # drain the queue before joining: a rank blocks on a full pipe
            while len(got) < world_size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = f"the world did not finish within {timeout_s:.0f} s"
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive() and p.exitcode != 0]
                    if dead:
                        failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                    continue
                if ok:
                    with open(out, "rb") as f:
                        got[rank] = pickle.load(f)
                else:
                    failure = f"rank {rank} raised:\n{out}"
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0) if failure is None else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
            results.close()
    if failure is not None:
        raise RuntimeError(f"run_world({getattr(fn, '__name__', fn)}, {world_size}): {failure}")
    return [got[r] for r in range(world_size)]
