"""The port's packer and accumulation engine against the reference's.

* ``pack_client_shards`` is numpy in both packages: equal arrays, exactly.
* ``accumulate`` gives the reference engine's A, b, n and class counts on
  the same packed arrays (A and b within fp32 reassociation, relative to
  their largest entry; n and the counts exactly).
* In the port, A and b are bitwise invariant under client permutation and
  re-sharding (the reference's ``tests/test_engine.py`` contract).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import pack_client_shards as jpack  # noqa: E402
from repro.federated import compress as jcompress  # noqa: E402
from repro.federated.engine import AccumulationEngine as JEngine  # noqa: E402
from repro.federated.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import pack_client_shards  # noqa: E402
from repro_torch.federated.compress import WireFormat  # noqa: E402
from repro_torch.federated.dist import DistConfig  # noqa: E402
from repro_torch.federated.engine import (  # noqa: E402
    AccumulationEngine,
    EngineConfig,
    to_ncm_stats,
)
from repro_torch.federated.telemetry import Telemetry  # noqa: E402
from repro_torch.kernels.ops import fed3r_stats  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.world import single_rank_world  # noqa: E402

D, C = 16, 5
STATS_REL = 1e-5  # fp32 sums of ≤ 100 products in two orders, scaled to max|A|


def _make_clients(seed, sizes, d=D, n_classes=C):
    out = []
    for i, n in enumerate(sizes):
        r = np.random.default_rng(seed + i)
        out.append((
            r.normal(size=(n, d)).astype(np.float32),
            r.integers(0, n_classes, size=n).astype(np.int32),
        ))
    return out


def _engine(**kw):
    return AccumulationEngine(EngineConfig(n_classes=C), device="cpu", **kw)


def _close(got, want, rel):
    got, want = got.cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("kw", [{}, {"round_to": 4, "client_ids": [11, 3, 7, 5]},
                                {"max_n": 16, "num_shards": 3}])
def test_packer_equals_reference(kw):
    clients = _make_clients(1, [4, 7, 3, 6])
    got = pack_client_shards(clients, 2, **kw)
    want = jpack(clients, 2, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.n_clients == want.n_clients and got.n_samples == want.n_samples
    assert got.n_slots == want.inputs.shape[0] * want.inputs.shape[1]


def test_packer_rejects_oversized_client():
    with pytest.raises(ValueError):
        pack_client_shards(_make_clients(2, [4, 9]), 2, max_n=8)


@pytest.mark.parametrize("sizes,cps", [([8], 1), ([5, 9, 2], 2), ([1, 17, 4, 4, 30], 3)])
def test_accumulate_matches_reference_engine(sizes, cps):
    packed = pack_client_shards(_make_clients(3, sizes), cps)
    eng = _engine()
    got = eng.accumulate(eng.init(D), packed)
    jeng = JEngine(JEngineConfig(n_classes=C))
    want = jeng.accumulate(jeng.init(D), packed)
    _close(got.stats.A, want.stats.A, STATS_REL)
    _close(got.stats.b, want.stats.b, STATS_REL)
    assert float(got.stats.n) == float(want.stats.n) == sum(sizes)
    assert np.array_equal(got.class_counts.numpy(), np.asarray(want.class_counts))
    ncm = to_ncm_stats(got)
    assert torch.equal(ncm.sums, got.stats.b.T)


def test_accumulate_feature_fn_matches_reference():
    packed = pack_client_shards(_make_clients(6, [5, 8, 2]), 2)
    eng = _engine(feature_fn=lambda p, x: torch.tanh(x * p["w"]))
    got = eng.accumulate(eng.init(D), packed, {"w": torch.tensor(2.5)})
    jeng = JEngine(JEngineConfig(n_classes=C), feature_fn=lambda p, x: jnp.tanh(x * p["w"]))
    want = jeng.accumulate(jeng.init(D), packed, {"w": jnp.asarray(2.5, jnp.float32)})
    _close(got.stats.A, want.stats.A, STATS_REL)
    _close(got.stats.b, want.stats.b, STATS_REL)


def test_accumulate_goes_through_the_statistics_wrapper_per_client_slot(monkeypatch):
    """One wrapper call per folded client slot, empty slots included."""
    import repro_torch.federated.engine as engine_mod

    calls = []

    def counting(z, y):
        calls.append(tuple(z.shape))
        return fed3r_stats(z, y)

    monkeypatch.setattr(engine_mod, "fed3r_stats", counting)
    packed = pack_client_shards(_make_clients(7, [3, 5, 4, 2, 6]), 2)
    eng = _engine()
    eng.accumulate(eng.init(D), packed)
    assert len(calls) == packed.n_slots == 6
    assert set(calls) == {(packed.inputs.shape[2], D)}


def test_engine_bit_identical_under_client_permutation():
    clients = _make_clients(7, [9, 3, 14, 6, 1, 11])
    eng = _engine()
    a1 = eng.accumulate(eng.init(D), pack_client_shards(clients, 3))
    perm = [4, 0, 5, 2, 1, 3]
    a2 = eng.accumulate(
        eng.init(D), pack_client_shards([clients[i] for i in perm], 3, client_ids=perm)
    )
    assert torch.equal(a1.stats.A, a2.stats.A)
    assert torch.equal(a1.stats.b, a2.stats.b)


@pytest.mark.parametrize("cps", [1, 2, 3, 6])
def test_engine_bit_identical_under_resharding(cps):
    """Strict left fold in canonical order ⇒ shard boundaries are invisible."""
    clients = _make_clients(8, [9, 3, 14, 6, 1, 11])
    ref = _engine().accumulate(_engine().init(D), pack_client_shards(clients, 2, max_n=16))
    eng = _engine()
    got = eng.accumulate(eng.init(D), pack_client_shards(clients, cps, max_n=16))
    assert torch.equal(ref.stats.A, got.stats.A)
    assert torch.equal(ref.stats.b, got.stats.b)


def test_engine_counts_dispatches_and_spans():
    tel = Telemetry()
    eng = _engine(telemetry=tel)
    clients = _make_clients(10, [4] * 12)
    acc = eng.init(D)
    acc = eng.accumulate(acc, pack_client_shards(clients[:6], 3))
    acc = eng.accumulate(acc, pack_client_shards(clients[6:], 3, client_ids=range(6, 12)))
    assert eng.dispatches == 2
    assert float(acc.stats.n) == 48.0
    assert tel.histogram("span_seconds", stage="accumulate", engine="accumulation").count == 2
    ref = fed3r.client_stats(
        torch.from_numpy(np.concatenate([f for f, _ in clients])),
        torch.from_numpy(np.concatenate([y for _, y in clients])), C,
    )
    _close(acc.stats.A, ref.A.numpy(), STATS_REL)


def test_engine_rejects_unported_options():
    # compressed wires are ported: a WireFormat is taken, an unknown kind refused
    assert EngineConfig(n_classes=C, wire=WireFormat(kind="int8")).wire.kind == "int8"
    assert _engine().wire == WireFormat()  # fp32 by default
    with pytest.raises(ValueError):
        EngineConfig(n_classes=C, wire=WireFormat(kind="int4"))
    with pytest.raises(ValueError):  # psum needs axes: the reference's validation
        EngineConfig(n_classes=C, dist=DistConfig(aggregation="psum"))
    # psum runs on a one-rank world: the all-reduce sums one partial, so
    # fp32 is bitwise the merge fold, and int8 the merge fold through the
    # wire once more (the partial's crossing) — the reference's merge
    # engine under the int8 wire, then its jitted wire_roundtrip
    packed = pack_client_shards(_make_clients(3, [5, 9, 4]), 2)
    int8 = WireFormat(kind="int8", tile=8)

    def eng(**kw):
        return AccumulationEngine(EngineConfig(n_classes=C, **kw), device="cpu")

    merge32, merge8 = eng(), eng(wire=int8)
    want32 = merge32.accumulate(merge32.init(D), packed)
    want8 = merge8.accumulate(merge8.init(D), packed)
    with single_rank_world("gloo", "cpu"):
        psum = DistConfig(aggregation="psum", mesh=make_host_mesh(device_type="cpu"))
        eng32, eng8 = eng(dist=psum), eng(dist=psum, wire=int8)
        got32 = eng32.accumulate(eng32.init(D), packed)
        got8 = eng8.accumulate(eng8.init(D), packed)
    assert torch.equal(got32.stats.A, want32.stats.A) and torch.equal(got32.stats.b, want32.stats.b)
    assert torch.equal(got32.class_counts, want32.class_counts)
    jint8 = jcompress.WireFormat(kind="int8", tile=8)
    jeng = JEngine(JEngineConfig(n_classes=C, wire=jint8))
    jacc = jeng.accumulate(jeng.init(D), jpack(_make_clients(3, [5, 9, 4]), 2))
    A8, b8 = jax.jit(jcompress.wire_roundtrip, static_argnames=("fmt",))(
        jacc.stats.A, jacc.stats.b, fmt=jint8)
    _close(got8.stats.A, A8, STATS_REL)
    _close(got8.stats.b, b8, STATS_REL)
    assert not torch.equal(got8.stats.A, want8.stats.A)  # the partial crossed the wire
    with pytest.raises(ValueError):
        DistConfig(aggregation="allgather")
    with pytest.raises(TypeError):  # FED3R-RF is ported: rff_params must be RFFParams
        _engine(rff_params=object())
