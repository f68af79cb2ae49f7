"""Hypothesis properties of the port's invariants, against the reference
(the twin of ``tests/test_property.py``, with its example counts).

Exact aggregation — the paper's central claim — holds in the port for any
partition, any merge order and any merge tree, within the reference's
tolerances, and each drawn case's merged statistics equal the reference's
on the same rows; the copied cost model orders FED3R's upload below
FedAvg's and accumulates monotonically, as the reference's does on the
same draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.core import ncm as jncm  # noqa: E402
from repro.federated.costs import CostModel as JCostModel  # noqa: E402
from repro_torch.core import fed3r, ncm  # noqa: E402
from repro_torch.federated.costs import CostModel  # noqa: E402

D, C = 8, 4
_RNG = np.random.default_rng(0)
_FEATS = _RNG.normal(size=(120, D)).astype(np.float32)
_LABELS = _RNG.integers(0, C, size=120).astype(np.int32)


def _stats(idx):
    return fed3r.client_stats(torch.from_numpy(_FEATS[idx]), torch.from_numpy(_LABELS[idx]), C)


def _jstats(idx):
    return jfed3r.client_stats(jnp.asarray(_FEATS[idx]), jnp.asarray(_LABELS[idx]), C)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@st.composite
def partitions(draw):
    n = len(_LABELS)
    k = draw(st.integers(min_value=1, max_value=10))
    cuts = sorted(draw(
        st.lists(st.integers(1, n - 1), min_size=k - 1, max_size=k - 1, unique=True)
    ))
    perm = draw(st.permutations(list(range(n))))
    return np.split(np.asarray(perm), cuts)


@settings(max_examples=25, deadline=None)
@given(partitions())
def test_fed3r_partition_invariance(parts):
    merged = fed3r.merge(*[_stats(p) for p in parts if len(p)])
    ref = _stats(np.arange(len(_LABELS)))
    _close(merged.A, ref.A, 1e-3, 1e-3)
    _close(merged.b, ref.b, 1e-3, 1e-3)
    want = jfed3r.merge(*[_jstats(p) for p in parts if len(p)])
    _close(merged.A, want.A, 1e-5, 1e-5)
    _close(merged.b, want.b, 1e-5, 1e-5)
    assert float(merged.n) == float(want.n) == len(_LABELS)


@settings(max_examples=20, deadline=None)
@given(st.permutations(list(range(6))))
def test_fed3r_merge_order_invariance(order):
    parts = np.array_split(np.arange(len(_LABELS)), 6)
    stats = [_stats(p) for p in parts]
    a = fed3r.merge(*stats)
    b = fed3r.merge(*[stats[i] for i in order])
    _close(a.A, b.A, 1e-5)
    _close(a.b, b.b, 1e-5)
    jstats = [_jstats(p) for p in parts]
    _close(b.A, jfed3r.merge(*[jstats[i] for i in order]).A, 1e-5, 1e-5)


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 6), st.integers(0, 100))
def test_fed3r_merge_associativity(k, seed):
    """merge(merge(a,b),c) == merge(a,merge(b,c)) — the psum-tree freedom."""
    parts = np.array_split(np.arange(len(_LABELS)), k)
    stats = [_stats(p) for p in parts]
    rng = np.random.default_rng(seed)
    pool = list(stats)  # a random binary merge tree against the flat merge
    while len(pool) > 1:
        i, j = sorted(rng.choice(len(pool), size=2, replace=False))
        b = pool.pop(j)
        a = pool.pop(i)
        pool.append(fed3r.merge(a, b))
    flat = fed3r.merge(*stats)
    _close(pool[0].A, flat.A, 1e-4, 1e-4)
    _close(flat.A, jfed3r.merge(*[_jstats(p) for p in parts]).A, 1e-5, 1e-5)


@settings(max_examples=20, deadline=None)
@given(partitions())
def test_ncm_partition_invariance(parts):
    merged = ncm.merge(*[
        ncm.client_stats(torch.from_numpy(_FEATS[p]), torch.from_numpy(_LABELS[p]), C)
        for p in parts if len(p)
    ])
    ref = ncm.client_stats(torch.from_numpy(_FEATS), torch.from_numpy(_LABELS), C)
    _close(merged.sums, ref.sums, 1e-3, 1e-3)
    _close(merged.counts, ref.counts, 1e-7)
    want = jncm.merge(*[jncm.client_stats(jnp.asarray(_FEATS[p]), jnp.asarray(_LABELS[p]), C)
                        for p in parts if len(p)])
    _close(merged.sums, want.sums, 1e-5, 1e-5)
    assert np.array_equal(merged.counts.numpy(), np.asarray(want.counts))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4096), st.integers(1, 512), st.integers(2, 5000))
def test_cost_model_fed3r_cheaper_upstream_than_full_model(d, C_, b_scale):
    """App. D: FED3R upstream (d²+dC) vs FedAvg (b+dC) — for realistic
    extractor sizes (b ≫ d²) FED3R uploads less."""
    cm, jcm = CostModel(b=float(d * d * b_scale), d=d, C=C_), \
        JCostModel(b=float(d * d * b_scale), d=d, C=C_)
    for alg in ("fed3r", "fedavg"):
        assert cm.comm_per_client(alg) == jcm.comm_per_client(alg)
    assert cm.comm_per_client("fed3r")["up"] < cm.comm_per_client("fedavg")["up"] or b_scale <= 1


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 20))
def test_cost_model_cumulative_monotone(rounds):
    cm, jcm = CostModel(b=2.2e6, d=64, C=10), JCostModel(b=2.2e6, d=64, C=10)
    for alg in ("fedavg", "scaffold", "fedavg-lp", "fed3r"):
        curve = cm.cumulative_comm_bytes(alg, rounds, 10)
        assert len(curve) == rounds
        assert np.all(np.diff(curve) >= 0)
        assert np.array_equal(np.asarray(curve), np.asarray(jcm.cumulative_comm_bytes(alg, rounds,
                                                                                      10)))
