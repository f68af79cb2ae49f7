"""The port's head-serving path against the reference, and on its own properties.

* ``SlotTable`` and ``TenantUniverse`` (ports of ``tests/test_serving.py``).
* ``HeadCache`` under both invalidation policies; ``HeadServer`` against the
  reference's server on the same federation and arrivals: the same modes
  and solve counts, scores within ``SCORE_REL`` of max|score|.
* ``ServingEngine``: the behaviours of ``tests/test_serving.py`` —
  segmented re-solves, parity with the synchronous server, the eviction
  round trip, overflow to the global slot, one dispatch per stage, queue
  and deadline shedding, latency accounting — and its scores against the
  reference engine's.
* ``serve_heads`` (both engines) and ``serve_stream(engine="slots")``
  against the reference drivers' logs, on the reference's data.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import make_federated_features as jmake_federated_features  # noqa: E402
from repro.federated.arrivals import pack_schedule, poisson_schedule  # noqa: E402
from repro.federated.personalization import PersonalizationEngine as JPersonalizationEngine  # noqa: E402
from repro.federated.personalization import PersonalizeConfig as JPersonalizeConfig  # noqa: E402
from repro.federated.streaming_engine import StreamConfig as JStreamConfig  # noqa: E402
from repro.federated.streaming_engine import StreamingEngine as JStreamingEngine  # noqa: E402
from repro.launch import serve_heads as jserve_heads_mod  # noqa: E402
from repro.launch import serve_stream as jserve_stream_mod  # noqa: E402
from repro.launch.serve_heads import HeadServer as JHeadServer  # noqa: E402
from repro.launch.serving_engine import ServingConfig as JServingConfig  # noqa: E402
from repro.launch.serving_engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset  # noqa: E402
from repro_torch.data.synthetic import FeatureDataset  # noqa: E402
from repro_torch.federated.personalization import (  # noqa: E402
    PersonalizationEngine,
    PersonalizeConfig,
)
from repro_torch.federated.slots import SlotTable, TenantUniverse  # noqa: E402
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine  # noqa: E402
from repro_torch.launch import serve_heads as serve_heads_mod  # noqa: E402
from repro_torch.launch import serve_stream as serve_stream_mod  # noqa: E402
from repro_torch.launch.serve_heads import HeadCache, HeadServer  # noqa: E402
from repro_torch.launch.serving_engine import ServingConfig, ServingEngine  # noqa: E402

D, C, LAM = 16, 5, 1e-2
ALPHA_GRID = (0.0, 0.5, 1.0, 2.0, 4.0)
# served scores of the two packages: fp32 streams and solves in different
# orders (the reference's own stream-vs-batch W tolerance is 1e-4 on unit
# columns), relative to the largest score of the burst
SCORE_REL = 1e-4


def _jfed(seed=1, n_clients=8):
    fed, _ = jmake_federated_features(
        seed=seed, n=600, d=D, n_classes=C, n_clients=n_clients, alpha=0.3, noise=2.0,
    )
    return fed


def _port(fed):
    return FederatedDataset(np.asarray(fed.features), np.asarray(fed.labels),
                            fed.client_indices, fed.n_classes)


def _fed(seed=1, n_clients=8):
    return _port(_jfed(seed, n_clients))


def _packed(fed, seed=0, waves=4):
    return pack_schedule(fed, poisson_schedule(fed.n_clients, waves, 3.0, seed=seed))


def _engine_cfg(**kw):
    cfg = dict(n_classes=C, ridge_lambda=LAM, n_slots=6, solve_bucket=4, serve_bucket=8,
               alpha_grid=ALPHA_GRID)
    cfg.update(kw)
    return cfg


def _engine(fed, **kw):
    eng = ServingEngine(ServingConfig(**_engine_cfg(**kw)), fed, device="cpu")
    eng.init(D)
    return eng


def _lru(fed, capacity=4, invalidation="strict"):
    srv = HeadServer(
        StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=LAM), device="cpu"),
        PersonalizationEngine(PersonalizeConfig(n_classes=C, alpha_grid=ALPHA_GRID),
                              device="cpu"),
        fed, cache_capacity=capacity, cohort_round_to=4, invalidation=invalidation,
    )
    srv.init(D)
    return srv


def _jlru(fed, capacity=4, invalidation="strict"):
    srv = JHeadServer(
        JStreamingEngine(JStreamConfig(n_classes=C, ridge_lambda=LAM, use_kernel=False)),
        JPersonalizationEngine(JPersonalizeConfig(n_classes=C, alpha_grid=ALPHA_GRID,
                                                  use_kernel=False)),
        fed, cache_capacity=capacity, cohort_round_to=4, invalidation=invalidation,
    )
    srv.init(D)
    return srv


def _burst(fed, cids):
    """Query i of the burst is sample i (cycled) of its tenant's own data."""
    rows = []
    for i, c in enumerate(cids):
        feats = fed.client(c % fed.n_clients).features
        rows.append(feats[i % len(feats)])
    return np.stack(rows)


def _scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= SCORE_REL * max(float(np.abs(want).max()), 1.0)


# ---------------------------------------------------------------------------
# slot-table state
# ---------------------------------------------------------------------------


def test_slot_table_rejects_degenerate_sizes():
    with pytest.raises(ValueError):
        SlotTable(1, D, C, device="cpu")  # no room for a tenant next to the pinned slot


def test_slot_table_free_first_then_coldest_eviction():
    t = SlotTable(5, D, C, device="cpu")
    assert t.heads.shape == (5, D, C) and t.heads.dtype == torch.float32
    s = t.take_slots(3)
    assert s == [1, 2, 3] and t.evictions == 0
    t.assign(s, [10, 11, 12], [0, 0, 0], global_version=1, tick=1)
    assert len(t) == 3 and t.slot_of(11) == 2
    t.touch([1], [5], tick=3)  # tenant 10 is hot and recent
    t.touch([2], [1], tick=2)  # tenant 11 lukewarm
    got = t.take_slots(2)  # slot 3 (tenant 12, never served) is coldest
    assert got == [4, 3]
    assert t.evictions == 1 and t.slot_of(12) is None
    assert t.slot_of(10) == 1


def test_slot_table_protected_slots_survive_saturation():
    t = SlotTable(4, D, C, device="cpu")
    s = t.take_slots(3)
    t.assign(s, [7, 8, 9], [0, 0, 0], global_version=1, tick=1)
    assert t.take_slots(3, protect=[1, 2]) == [3]  # only slot 3 is evictable
    assert t.slot_of(7) == 1 and t.slot_of(8) == 2


def test_tenant_universe_aliases_base_clients():
    fed = _fed()
    uni = TenantUniverse(fed, 1_000_000)
    assert uni.n_clients == 1_000_000 and uni.n_classes == C
    k = 777_777
    np.testing.assert_array_equal(uni.client(k).features, fed.client(k % fed.n_clients).features)
    assert int(uni.client_sizes().max()) == int(fed.client_sizes().max())
    with pytest.raises(ValueError):
        TenantUniverse(fed, fed.n_clients - 1)


# ---------------------------------------------------------------------------
# the LRU head cache and the synchronous server
# ---------------------------------------------------------------------------


def test_head_cache_lru_eviction_counters_and_dirty_marking():
    cache = HeadCache(capacity=2)
    W = torch.zeros((D, C))
    assert cache.get(1) is None
    cache.put(1, W)
    cache.put(2, W)
    assert cache.get(1) is not None  # a hit refreshes the recency of 1
    cache.put(3, W)  # evicts 2 (LRU), not 1
    assert cache.get(2) is None
    assert cache.get(1) is not None and cache.get(3) is not None
    assert cache.lru_evictions == 1 and cache.hits == 3 and cache.misses == 2
    cache.advance()  # strict: every cached head is stale
    assert cache.get(1) is None and cache.stale_evictions == 1
    with pytest.raises(ValueError):
        HeadCache(capacity=0)


def test_head_cache_segmented_invalidates_only_touched_tenants():
    cache = HeadCache(capacity=4, segmented=True)
    W = torch.zeros((D, C))
    cache.put(1, W)
    cache.put(2, W)
    cache.advance(touched=[1])
    assert cache.get(1) is None and cache.get(2) is not None
    assert cache.stale_evictions == 1
    cache.put(1, W)
    cache.advance(touched=None)  # unknown arrivals: whole-cache invalidation
    assert cache.get(1) is None and cache.get(2) is None
    strict = HeadCache(capacity=4)
    strict.put(1, W)
    strict.put(2, W)
    strict.advance(touched=[1])  # strict ignores the touched set
    assert strict.get(1) is None and strict.get(2) is None


@pytest.mark.parametrize("invalidation", ["strict", "segmented"])
def test_head_server_matches_reference_server(invalidation):
    jfed = _jfed(seed=13)
    fed = _port(jfed)
    srv, jsrv = _lru(fed, 4, invalidation), _jlru(jfed, 4, invalidation)
    cids = [0, 3, 0, 999, 5, 6, 7]  # a repeat, an unknown tenant, more tenants than slots
    xs = _burst(fed, cids)
    for seed, waves in ((0, 3), (1, 2)):
        packed = _packed(jfed, seed=seed, waves=waves)
        srv.absorb(packed)
        jsrv.absorb(packed)
        for _ in range(2):  # the second burst exercises the hit path
            s, r = srv.query(cids, xs)
            js, jr = jsrv.query(cids, xs)
            for key in ("queries", "per_tenant", "global", "solved_now", "cache_hits",
                        "cache_misses", "cache_version", "modes"):
                assert r[key] == jr[key], key
            _scores_close(s.numpy(), js)
    assert srv.pers.dispatches == jsrv.pers.dispatches
    assert srv.cache.stale_evictions == jsrv.cache.stale_evictions


def test_head_server_partial_repersonalization():
    fed = _fed()
    srv = _lru(fed, capacity=8, invalidation="segmented")
    strict = _lru(fed, capacity=8, invalidation="strict")
    cids = [0, 1, 2, 3]
    xs = _burst(fed, cids)
    wave = pack_schedule(fed, [[2]])  # arrivals of client 2 only
    for s in (srv, strict):
        s.absorb(_packed(fed))
        assert s.query(cids, xs)[1]["solved_now"] == 4
        s.absorb(wave)
    assert srv.query(cids, xs)[1]["solved_now"] == 1
    assert srv.cache.stale_evictions == 1
    assert strict.query(cids, xs)[1]["solved_now"] == 4


# ---------------------------------------------------------------------------
# the slot engine: parity, lifecycle, dispatches, admission
# ---------------------------------------------------------------------------


def test_slot_engine_segmented_resolves_only_touched_tenants():
    fed = _fed()
    eng, strict = _engine(fed, invalidation="segmented"), _engine(fed, invalidation="strict")
    cids = [0, 1, 2, 3]
    xs = _burst(fed, cids)
    for e in (eng, strict):
        e.absorb(_packed(fed))
        assert e.query(cids, xs)[1]["solved_now"] == 4
        e.absorb(pack_schedule(fed, [[2]]))
    assert eng.query(cids, xs)[1]["solved_now"] == 1
    assert strict.query(cids, xs)[1]["solved_now"] == 4


def test_slot_engine_matches_synchronous_server():
    fed = _fed()
    eng, srv = _engine(fed, invalidation="strict"), _lru(fed, capacity=5)
    packed = _packed(fed)
    eng.absorb(packed)
    srv.absorb(packed)
    cids = [0, 3, 0, 999]
    xs = _burst(fed, cids)
    for _ in range(2):
        s1, r1 = eng.query(cids, xs)
        s2, r2 = srv.query(cids, xs)
        assert r1["modes"] == r2["modes"] == ["per-tenant", "per-tenant", "per-tenant", "global"]
        assert torch.equal(s1, s2)  # same cohorts, same solves, same contraction
    assert torch.equal(eng.classifier(), srv.stream.classifier(srv.state))


def test_slot_engine_personalized_parity_after_stream_advance():
    fed = _fed()
    eng, srv = _engine(fed, invalidation="strict"), _lru(fed, capacity=5)
    cids = [1, 4, 6]
    xs = _burst(fed, cids)
    for seed in (0, 1):
        packed = _packed(fed, seed=seed, waves=2)
        eng.absorb(packed)
        srv.absorb(packed)
        assert float((eng.query(cids, xs)[0] - srv.query(cids, xs)[0]).abs().max()) <= 1e-5


def test_slot_engine_matches_reference_engine():
    jfed = _jfed()
    eng = _engine(_port(jfed), max_batch=3)
    jeng = JServingEngine(JServingConfig(**_engine_cfg(max_batch=3)), jfed)
    jeng.init(D)
    cids = [0, 3, 0, 999, 5, 1, 2]
    xs = _burst(jfed, cids)
    for seed in (0, 1):
        packed = _packed(jfed, seed=seed, waves=2)
        eng.absorb(packed)
        jeng.absorb(packed)
        s, r = eng.query(cids, xs)
        js, jr = jeng.query(cids, xs)
        for key in ("queries", "per_tenant", "global", "solved_now", "slot_overflow",
                    "evictions", "modes", "tenants"):
            assert r[key] == jr[key], key
        _scores_close(s.numpy(), js)
    for name in ("absorb_dispatches", "solve_dispatches", "serve_dispatches", "hits", "misses"):
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.table.tenant.tolist() == jeng.table.tenant.tolist()


def test_slot_engine_eviction_readmission_roundtrip():
    fed = _fed()
    eng = _engine(fed, n_slots=3)  # 2 tenant slots only
    eng.absorb(_packed(fed))
    xs0 = _burst(fed, [0])
    s_first, rep = eng.query([0], xs0)
    assert rep["solved_now"] == 1 and eng.table.slot_of(0) is not None
    eng.query([1, 2], _burst(fed, [1, 2]))
    assert eng.table.slot_of(0) is None and eng.table.evictions >= 1
    s_again, rep3 = eng.query([0], xs0)
    assert rep3["solved_now"] == 1 and eng.table.slot_of(0) is not None
    assert torch.equal(s_first, s_again)  # the stream did not move: the same head, bitwise


def test_slot_engine_overflow_serves_global_and_reports():
    fed = _fed()
    eng = _engine(fed, n_slots=3)  # 2 tenant slots for 4 distinct tenants
    eng.absorb(_packed(fed))
    cids = [0, 1, 2, 3]
    scores, rep = eng.query(cids, _burst(fed, cids))
    assert rep["slot_overflow"] == 2 == eng.slot_overflow
    assert rep["modes"].count("per-tenant") == 2 and rep["modes"].count("global") == 2
    assert scores.shape == (4, C)
    g = [i for i, m in enumerate(rep["modes"]) if m == "global"]
    expect = torch.as_tensor(_burst(fed, cids))[g] @ eng.classifier()
    np.testing.assert_allclose(scores[g].numpy(), expect.numpy(), rtol=1e-5, atol=1e-5)


def test_slot_engine_one_dispatch_per_stage():
    fed = _fed()
    eng = _engine(fed)
    eng.absorb(_packed(fed))
    assert eng.absorb_dispatches == 1
    cids = [0, 1, 2, 0, 1, 3]
    eng.query(cids, _burst(fed, cids))
    assert eng.solve_dispatches == 1 and eng.serve_dispatches == 1
    eng.query(cids, _burst(fed, cids))  # all hits: no solve, one serve
    assert eng.solve_dispatches == 1 and eng.serve_dispatches == 2


def test_slot_engine_queue_overflow_sheds_at_enqueue():
    fed = _fed()
    eng = _engine(fed, queue_depth=4)
    eng.absorb(_packed(fed))
    cids = [0, 1, 2, 3, 4, 5]
    assert eng.enqueue(cids, _burst(fed, cids)) == (4, 2)
    assert eng.shed_overflow == 2
    scores, rep = eng.tick()
    assert rep["queries"] == 4 and scores.shape == (4, C)
    with pytest.raises(RuntimeError):  # query() refuses silently shed bursts
        eng.query(cids, _burst(fed, cids))


def test_slot_engine_deadline_sheds_stale_requests():
    fed = _fed()
    eng = _engine(fed, queue_depth=64, max_batch=2, deadline_ticks=1)
    eng.absorb(_packed(fed))
    cids = [0, 1, 2, 3, 4, 5]
    assert eng.enqueue(cids, _burst(fed, cids)) == (6, 0)
    served = sheds = 0
    while eng.queue:
        _, rep = eng.tick()
        served += rep["queries"]
        sheds += rep["shed"]
    assert served + sheds == 6
    assert sheds == eng.shed_deadline > 0 and eng.ticks >= 2


def test_slot_engine_latency_accounting_covers_every_served_request():
    fed = _fed()
    eng = _engine(fed, max_batch=3)
    eng.absorb(_packed(fed))
    cids = [0, 1, 2, 3, 4]
    eng.enqueue(cids, _burst(fed, cids))
    reports = []
    while eng.queue:
        reports.append(eng.tick()[1])
    assert [r["queries"] for r in reports] == [3, 2]
    for rep in reports:
        assert len(rep["latency_s"]) == rep["queries"]
        assert all(t >= 0.0 for t in rep["latency_s"])
    assert reports[0]["tenants"] == [0, 1, 2] and reports[1]["tenants"] == [3, 4]
    assert eng._latency_hist.count == 5 and eng._latency_hist.p99 >= eng._latency_hist.p50


def test_serving_config_refuses_what_the_port_lacks():
    with pytest.raises(ValueError):
        ServingConfig(n_classes=C, invalidation="lazy")
    with pytest.raises(ValueError):
        ServingConfig(n_classes=C, max_batch=0)
    with pytest.raises(TypeError):
        ServingConfig(n_classes=C, use_kernel=True)  # the tensor's device decides


# ---------------------------------------------------------------------------
# the drivers against the reference drivers' logs, on the reference's data
# ---------------------------------------------------------------------------


@pytest.fixture
def reference_data(monkeypatch):
    """The port's drivers on the reference driver's own federation."""

    def make(seed, n, d, n_classes, n_clients, alpha, *, noise, device, **kw):
        fed, test = jmake_federated_features(seed=seed, n=n, d=d, n_classes=n_classes,
                                             n_clients=n_clients, alpha=alpha, noise=noise, **kw)
        ptest = FeatureDataset(torch.as_tensor(np.array(test.features), device=device),
                               torch.as_tensor(np.array(test.labels), device=device).long(),
                               n_classes)
        return _port(fed), ptest

    monkeypatch.setattr(serve_stream_mod, "make_federated_features", make)


HEADS_RUN = dict(n_waves=8, segment=4, queries_per_burst=24, cache_capacity=6, n_clients=16,
                 d=16, n_classes=5, verbose=False)


@pytest.mark.parametrize("engine,invalidation", [
    ("lru", "strict"), ("lru", "segmented"), ("slots", "strict"),
])
def test_serve_heads_matches_reference_log(reference_data, engine, invalidation):
    got = serve_heads_mod.serve_heads(engine=engine, invalidation=invalidation, device="cpu",
                                      **HEADS_RUN)
    want = jserve_heads_mod.serve_heads(engine=engine, invalidation=invalidation, **HEADS_RUN)
    for key in ("wave", "per_tenant", "global", "solved_now", "hit_rate", "cache",
                "stream_dispatches", "personalize_dispatches"):
        assert got[key] == want[key], key
    # a query whose two best scores nearly tie may flip: at most one a burst
    assert np.abs(np.subtract(got["acc_personal"], want["acc_personal"])).max() <= (
        1.0 / HEADS_RUN["queries_per_burst"] + 1e-9)
    assert abs(got["acc_global_test"] - want["acc_global_test"]) <= 2e-3
    assert all(bool(torch.isfinite(s).all()) for s in got["scores"])
    if engine == "slots":
        assert got["serve_dispatches"] == want["serve_dispatches"]
        assert set(got["stage_s"]) == {"absorb", "solve", "serve"}
        assert 0.0 < got["latency_p50_s"] <= got["latency_p99_s"]


def test_serve_heads_engines_serve_the_same_answers_under_strict(reference_data):
    # room for every tenant of a burst: a slot table that overflows serves
    # the global head where the LRU server serves a head it just solved
    run = dict(HEADS_RUN, cache_capacity=16)
    lru = serve_heads_mod.serve_heads(engine="lru", device="cpu", **run)
    slots = serve_heads_mod.serve_heads(engine="slots", device="cpu", **run)
    assert lru["modes"] == slots["modes"]
    for a, b in zip(lru["scores"], slots["scores"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    with pytest.raises(ValueError):
        serve_heads_mod.serve_heads(engine="fifo", device="cpu")


def test_serve_stream_slots_matches_reference_log(reference_data):
    kw = dict(n_waves=8, rate=3.0, segment=3, n_clients=24, d=16, n_classes=5, verbose=False)
    got = serve_stream_mod.serve_stream(engine="slots", device="cpu", **kw)
    want = jserve_stream_mod.serve_stream(engine="slots", **kw)
    for key in ("wave", "clients_seen", "samples_seen", "stale_waves", "stale_samples",
                "served_head", "engine", "dispatches", "serve_dispatches"):
        assert got[key] == want[key], key
    n_test = 1600  # 20% of the driver's 8,000 samples; one flipped near-tie allowed
    assert np.abs(np.subtract(got["acc_served"], want["acc_served"])).max() <= 1.0 / n_test + 1e-9
    assert abs(got["acc_final"] - want["acc_final"]) <= 1.0 / n_test + 1e-9
    # the slot engine's stream refreshes every wave: its served head is the
    # synchronous driver's under the arrival policy, bitwise
    lru = serve_stream_mod.serve_stream(engine="lru", device="cpu", **kw)
    assert torch.equal(got["W"], lru["W"])
    assert got["trace"].refreshed.all() and got["packed"].n_waves == 8


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    fed = _fed()
    calls = [
        lambda: serve_heads_mod.serve_heads(),
        lambda: serve_stream_mod.serve_stream(engine="slots"),
        lambda: ServingEngine(ServingConfig(n_classes=C), fed),
        lambda: PersonalizationEngine(PersonalizeConfig(n_classes=C)),
        lambda: SlotTable(2, D, C),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
