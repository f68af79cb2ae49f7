"""Client sampling strategies.

The paper (§4.3, Fig. 3, App. I) distinguishes:

* **without replacement** — FED3R's natural mode: every client is sampled
  exactly once; convergence is exact after ⌈K/κ⌉ rounds;
* **with replacement** — classical FL sampling; the paper's worst-case
  analysis connects rounds-to-coverage to the Batch Coupon Collector problem
  (Table 7), reproduced in benchmarks/bench_coupon.py.

:func:`sample_round` is the STATELESS core: the cohort of round ``rnd`` is a
pure function of (n_clients, per_round, rnd, seed, replacement), so a
checkpoint-resumed run re-derives exactly the cohorts an uninterrupted run
would have drawn.  :class:`ClientSampler` wraps it with a round counter and
coverage bookkeeping for the driver loops.
"""
from __future__ import annotations

from typing import List

import numpy as np


def sample_round(
    n_clients: int,
    per_round: int,
    rnd: int,
    *,
    seed: int = 0,
    replacement: bool = False,
) -> np.ndarray:
    """The cohort of round ``rnd`` as a pure function of its arguments.

    With replacement: ``per_round`` iid draws (duplicates allowed, and
    ``per_round > n_clients`` is legal — the Batch-Coupon-Collector regime
    of §4.3/Table 7).  Without replacement: epoch-style — conceptually one
    infinite stream of per-epoch permutations, from which round ``rnd``
    takes positions ``[rnd·κ, (rnd+1)·κ)``; every client appears exactly
    once per epoch and each epoch's permutation is derived independently
    from (seed, epoch).
    """
    if replacement:
        rng = np.random.default_rng((seed, rnd, 0xC0))
        return rng.choice(n_clients, size=per_round, replace=True)
    start = rnd * per_round
    out: List[np.ndarray] = []
    for epoch in range(start // n_clients, (start + per_round - 1) // n_clients + 1):
        perm = np.random.default_rng((seed, epoch, 0xE0)).permutation(n_clients)
        lo = max(start - epoch * n_clients, 0)
        hi = min(start + per_round - epoch * n_clients, n_clients)
        out.append(perm[lo:hi])
    return np.concatenate(out).astype(np.int64)


class ClientSampler:
    def __init__(
        self,
        n_clients: int,
        per_round: int,
        *,
        replacement: bool = False,
        seed: int = 0,
    ):
        self.n_clients = n_clients
        self.per_round = per_round
        self.replacement = replacement
        self.seed = seed
        self.round = 0
        self.seen: set = set()

    def sample(self) -> np.ndarray:
        out = sample_round(
            self.n_clients, self.per_round, self.round,
            seed=self.seed, replacement=self.replacement,
        )
        self.round += 1
        self.seen.update(int(c) for c in out)
        return out

    @property
    def coverage(self) -> float:
        return len(self.seen) / self.n_clients

    def rounds_to_full_coverage(self) -> int:
        """⌈K/κ⌉ — FED3R's exact convergence horizon (no replacement)."""
        return -(-self.n_clients // self.per_round)
