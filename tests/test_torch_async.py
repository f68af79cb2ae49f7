"""The port's asynchronous round engine against the reference, and on its own.

Twins every test of ``tests/test_async.py`` on the port
(:mod:`repro_torch.federated.async_engine`, the chaos half of
:mod:`repro_torch.federated.arrivals`, ``shard_cohort``), on the CPU:

* merge-on-arrival is bitwise the synchronous barrier under every fault
  type, within the port;
* the same numpy payloads through both packages' engines under each fault
  type: W within ``rtol = atol = 1e-5`` of max|W|;
* the chaos events and JSON timelines are identical across the packages;
* secure mode: each package against its own unmasked survivor-only run,
  bitwise (the port's masks come from ``torch.Generator``, the reference's
  from ``jax.random``), and the two packages' W within tolerance;
* the slot writes are in place: a test that compares a state before and
  after a call clones it first;
* ``serve_stream(engine="async")`` against the reference's driver on the
  reference's data: the same cohorts and counters, W within tolerance;
* two twins of ``tests/test_federated.py`` this slice rests on: split
  invariance through the driver, and a resampled client sent exactly once
  (the tolerance on A scaled to max|A|).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data import make_federated_features as jmake_federated_features  # noqa: E402
from repro.federated import arrivals as jarrivals  # noqa: E402
from repro.federated import async_engine as jasync  # noqa: E402
from repro.federated import secure_agg as jsecure_agg  # noqa: E402
from repro.federated.compress import cohort_quantize_int8 as jcohort_quantize_int8  # noqa: E402
from repro.launch import serve_stream as jserve_stream_mod  # noqa: E402
from repro_torch.configs.base import Fed3RConfig, FederatedConfig  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset  # noqa: E402
from repro_torch.data.synthetic import FeatureDataset  # noqa: E402
from repro_torch.federated import secure_agg  # noqa: E402
from repro_torch.federated.arrivals import (  # noqa: E402
    ChaosSpec,
    UploadEvent,
    chaos_round_events,
    chaos_timeline,
    latency_profile,
    timeline_from_json,
    timeline_to_json,
)
from repro_torch.federated.async_engine import (  # noqa: E402
    AsyncConfig,
    AsyncRoundEngine,
    ClientHealth,
    client_payloads,
    run_adaptive_rounds,
    run_chaos_timeline,
)
from repro_torch.federated.compress import WireFormat, cohort_quantize_int8  # noqa: E402
from repro_torch.federated.costs import CostModel  # noqa: E402
from repro_torch.federated.dist import DistConfig, shard_cohort  # noqa: E402
from repro_torch.federated.fed3r_driver import run_fed3r  # noqa: E402
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine  # noqa: E402
from repro_torch.launch import dist_check  # noqa: E402
from repro_torch.launch import serve_stream as serve_stream_mod  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.world import single_rank_world  # noqa: E402

D, C = 16, 4
N_CLIENTS = 10
COHORT = 4
LAMBDA = 1e-2
# the two packages reduce the same fp32 statistics in different orders and
# factor them with different Cholesky routines
W_REL = 1e-5


def _data(seed=0, n_clients=N_CLIENTS, d=D, lo=20, hi=40):
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(n_clients):
        n = int(rng.integers(lo, hi))
        out[k] = (rng.normal(size=(n, d)).astype(np.float32),
                  rng.integers(0, C, size=n).astype(np.int32))
    return out


def _payloads(seed=0, **kw):
    return {k: fed3r.client_stats(torch.as_tensor(x), torch.as_tensor(y), C)
            for k, (x, y) in _data(seed, **kw).items()}


def _jpayloads(seed=0, **kw):
    return {k: jfed3r.client_stats(jnp.asarray(x), jnp.asarray(y), C)
            for k, (x, y) in _data(seed, **kw).items()}


def _cohorts(n_rounds, seed=0, n_clients=N_CLIENTS, k=COHORT):
    return [
        sorted(np.random.default_rng((seed, r)).choice(n_clients, size=k, replace=False).tolist())
        for r in range(n_rounds)
    ]


def _kw(synchronous=False, **kw):
    kw.setdefault("staleness_rounds", 3)
    kw.setdefault("early_close", False)
    kw.setdefault("demote_after", 10_000)
    return dict(n_classes=C, ridge_lambda=LAMBDA, cohort=COHORT, deadline=1.0,
                synchronous=synchronous, **kw)


def _engine(synchronous=False, **kw):
    return AsyncRoundEngine(AsyncConfig(**_kw(synchronous, **kw)), device="cpu")


def _jengine(synchronous=False, **kw):
    return jasync.AsyncRoundEngine(jasync.AsyncConfig(**_kw(synchronous, **kw)))


def _close_rel(got, want, rel=W_REL):
    got, want = np.asarray(got), np.asarray(want)
    tol = rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=tol)


FAULTS = {
    "drop": dict(drop=0.5, rto=0.1, max_attempts=6, seed=3),
    "duplicate": dict(duplicate=0.6, seed=3),
    "reorder": dict(reorder=0.9, rto=0.2, seed=3),
    "delay": dict(delay=0.5, delay_factor=2.0, seed=3),
    "all": dict(drop=0.3, duplicate=0.3, reorder=0.5, delay=0.2, delay_factor=2.0, rto=0.1,
                max_attempts=6, seed=3),
}


def _chaos_latency():
    return latency_profile(N_CLIENTS, 0.2, straggler_factor=3.0, base=0.3, jitter=0.5, seed=1)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_chaos_parity_bitwise_per_fault_type(fault):
    payloads = _payloads()
    cohorts = _cohorts(5)
    events = chaos_timeline(cohorts, _chaos_latency(), ChaosSpec(**FAULTS[fault]))

    def pf(c, r):
        return payloads[c]

    ea = _engine(synchronous=False)
    sa, ra = run_chaos_timeline(ea, ea.init(D), cohorts, events, pf)
    es = _engine(synchronous=True)
    ss, _ = run_chaos_timeline(es, es.init(D), cohorts, events, pf)

    assert ra["dropped_uploads"] == 0, "chaos tail escaped the staleness window"
    assert torch.equal(sa.W, ss.W)
    assert torch.equal(sa.L, ss.L)
    if fault in ("duplicate", "all"):
        assert ra["duplicates"] > 0  # dedup actually exercised


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_chaos_timeline_matches_reference_engine(fault):
    """The same numpy payloads and chaos events through both engines: the
    same counters, W and L within tolerance."""
    payloads, jpayloads = _payloads(), _jpayloads()
    cohorts = _cohorts(5)
    latency = _chaos_latency()
    events = chaos_timeline(cohorts, latency, ChaosSpec(**FAULTS[fault]))
    jevents = jarrivals.chaos_timeline(cohorts, latency, jarrivals.ChaosSpec(**FAULTS[fault]))
    assert [tuple(e) for e in events] == [tuple(e) for e in jevents]

    ea = _engine()
    sa, ra = run_chaos_timeline(ea, ea.init(D), cohorts, events, lambda c, r: payloads[c])
    ja = _jengine()
    jsa, jra = jasync.run_chaos_timeline(ja, ja.init(D), cohorts, jevents,
                                         lambda c, r: jpayloads[c])
    for key in ("folded", "duplicates", "late_folds", "stale_rejected", "dropped_uploads",
                "demoted", "completion", "makespan", "dispatches"):
        assert ra[key] == jra[key], key
    _close_rel(sa.W.numpy(), jsa.W)
    _close_rel(sa.L.numpy(), jsa.L)
    assert float(sa.n) == float(jsa.n)


def test_int8_wire_matches_reference_and_stays_bitwise_sync():
    payloads, jpayloads = _payloads(d=32), _jpayloads(d=32)
    cohorts = _cohorts(4)
    events = chaos_timeline(cohorts, _chaos_latency(), ChaosSpec(**FAULTS["all"]))
    wire = WireFormat(kind="int8", tile=16)
    outs = {}
    for sync in (False, True):
        eng = _engine(sync, wire=wire)
        outs[sync], _ = run_chaos_timeline(eng, eng.init(32), cohorts, events,
                                           lambda c, r: payloads[c])
    assert torch.equal(outs[False].W, outs[True].W)
    from repro.federated.compress import WireFormat as JWireFormat

    je = _jengine(wire=JWireFormat(kind="int8", tile=16))
    js, _ = jasync.run_chaos_timeline(je, je.init(32), cohorts, events,
                                      lambda c, r: jpayloads[c])
    _close_rel(outs[False].W.numpy(), js.W)


def test_stale_upload_rejected_and_never_folds():
    payloads = _payloads()
    eng = _engine(staleness_rounds=0)
    state = eng.init(D)
    eng.begin_round(0, [0, 1], 0.0)
    state, s = eng.deliver(state, UploadEvent(0.1, 0, 0, 0), payloads[0])
    assert s == "folded"
    state = eng.close_round(state, 0, now=1.0)  # staleness 0: retires at once
    W_before = state.W.clone()
    state, s = eng.deliver(state, UploadEvent(1.5, 0, 1, 0), payloads[1])
    assert s == "stale"
    assert eng.stale_rejected == 1
    assert torch.equal(state.W, W_before)


def test_duplicate_deduped_state_unchanged():
    payloads = _payloads()
    eng = _engine()
    state = eng.init(D)
    eng.begin_round(0, [0, 1], 0.0)
    state, _ = eng.deliver(state, UploadEvent(0.1, 0, 0, 0), payloads[0])
    snap = state.A_slots.clone()  # the slot ring is written in place
    state, s = eng.deliver(state, UploadEvent(0.2, 0, 0, 1), payloads[0])
    assert s == "duplicate"
    assert eng.duplicates == 1
    assert torch.equal(state.A_slots, snap)


def test_deliver_writes_the_slot_in_place():
    payloads = _payloads()
    eng = _engine()
    state = eng.init(D)
    ring = state.A_slots
    eng.begin_round(0, [3, 5], 0.0)
    new, _ = eng.deliver(state, UploadEvent(0.1, 0, 5, 0), payloads[5])
    assert new.A_slots is ring  # consumed, not copied
    assert torch.equal(ring[0, 1], payloads[5].A) and not ring[0, 0].any()


def test_late_fold_inside_staleness_window_counts():
    payloads = _payloads()
    eng = _engine(staleness_rounds=2)
    state = eng.init(D)
    eng.begin_round(0, [0, 1], 0.0)
    state, _ = eng.deliver(state, UploadEvent(0.1, 0, 0, 0), payloads[0])
    state = eng.close_round(state, 0, now=1.0)
    state, s = eng.deliver(state, UploadEvent(1.5, 0, 1, 0), payloads[1])
    assert s == "late"
    assert eng.late_folds == 1
    state = eng.drain(state)
    # both uploads made it into the retired sums
    assert float(state.n) == pytest.approx(float(payloads[0].n) + float(payloads[1].n))


def test_client_health_demotes_and_readmits():
    h = ClientHealth(demote_after=2, cooldown=3)
    h.missed(7, 0)
    assert h.is_eligible(7, 1)
    h.missed(7, 1)
    assert 7 in h.demoted
    assert not h.is_eligible(7, 2)
    assert not h.is_eligible(7, 3)
    assert h.is_eligible(7, 4)  # cooldown elapsed: probation
    h.on_time(7)
    assert 7 not in h.demoted
    assert h.is_eligible(7, 5)


def test_adaptive_rounds_demote_persistent_straggler():
    payloads = _payloads()
    latency = latency_profile(N_CLIENTS, 0.0, base=0.2, jitter=0.2, seed=2)
    latency[3] = 50.0  # client 3 never makes any deadline
    eng = AsyncRoundEngine(AsyncConfig(
        n_classes=C, ridge_lambda=LAMBDA, cohort=N_CLIENTS,
        deadline=1.0, staleness_rounds=2, demote_after=2, cooldown=100,
    ), device="cpu")
    _, rep = run_adaptive_rounds(
        eng, eng.init(D), N_CLIENTS, N_CLIENTS, 8, latency,
        ChaosSpec(seed=0), lambda c, r: payloads[c], seed=5,
    )
    assert 3 in rep["demoted"]
    # once demoted, client 3 stops being sampled
    demoted_from = next(r for r, cohort in enumerate(rep["cohorts"]) if 3 not in cohort)
    for cohort in rep["cohorts"][demoted_from:]:
        assert 3 not in cohort


def test_adaptive_rounds_match_reference():
    payloads, jpayloads = _payloads(), _jpayloads()
    latency = latency_profile(N_CLIENTS, 0.3, straggler_factor=6.0, seed=4)
    spec = dict(duplicate=0.2, reorder=0.3, delay=0.2, seed=9)
    cfg = dict(n_classes=C, ridge_lambda=LAMBDA, cohort=6, deadline=1.0, staleness_rounds=2,
               demote_after=2, cooldown=3)
    eng = AsyncRoundEngine(AsyncConfig(**cfg), device="cpu")
    st, rep = run_adaptive_rounds(eng, eng.init(D), N_CLIENTS, 6, 10, latency, ChaosSpec(**spec),
                                  lambda c, r: payloads[c], seed=5)
    jeng = jasync.AsyncRoundEngine(jasync.AsyncConfig(**cfg))
    jst, jrep = jasync.run_adaptive_rounds(jeng, jeng.init(D), N_CLIENTS, 6, 10, latency,
                                           jarrivals.ChaosSpec(**spec),
                                           lambda c, r: jpayloads[c], seed=5)
    assert rep == jrep
    _close_rel(st.W.numpy(), jst.W)


def test_live_classifier_tracks_open_rounds():
    payloads = _payloads()
    eng = _engine(staleness_rounds=2)
    state = eng.init(D)
    eng.begin_round(0, [0, 1], 0.0)
    state, _ = eng.deliver(state, UploadEvent(0.1, 0, 0, 0), payloads[0])
    state, _ = eng.deliver(state, UploadEvent(0.2, 0, 1, 0), payloads[1])
    live = eng.live_classifier(state).numpy()
    # the open round has not retired; the carried classifier is still empty
    assert not np.array_equal(live, state.W.numpy())
    state = eng.drain(state)
    np.testing.assert_allclose(live, state.W.numpy(), rtol=1e-5, atol=1e-6)


def test_retire_matches_streaming_absorb_stats():
    payloads = _payloads()
    cohort = [0, 1, 2, 3]
    eng = _engine(staleness_rounds=0)
    state = eng.init(D)
    eng.begin_round(0, cohort, 0.0)
    for i, c in enumerate(cohort):
        state, _ = eng.deliver(state, UploadEvent(0.1 * i, 0, c, 0), payloads[c])
    state = eng.close_round(state, 0, now=1.0)

    se = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=LAMBDA), device="cpu")
    ss = se.init(D)
    S = fed3r.merge(*(payloads[c] for c in cohort))
    ss = se.absorb_stats(ss, S.A, S.b, S.n)

    np.testing.assert_allclose(state.W.numpy(), ss.W.numpy(), rtol=1e-6, atol=1e-7)
    assert float(state.n) == pytest.approx(float(ss.n))


# ---------------------------------------------------------------------------
# Secure aggregation under dropout
# ---------------------------------------------------------------------------


def _secure_round(cohort, payloads_masked, scales, deliver_clients, seed=0, jax=False):
    kw = dict(n_classes=C, ridge_lambda=LAMBDA, cohort=len(cohort), deadline=1.0,
              staleness_rounds=0, secure=True, secure_seed=seed)
    if jax:
        eng = jasync.AsyncRoundEngine(jasync.AsyncConfig(**kw))
    else:
        eng = AsyncRoundEngine(AsyncConfig(**kw), device="cpu")
    state = eng.init(D)
    eng.begin_round(0, cohort, 0.0, scales=scales)
    for i, c in enumerate(deliver_clients):
        state, s = eng.deliver(state, UploadEvent(0.1 * i, 0, c, 0), payloads_masked[c])
        assert s == "folded"
    state = eng.close_round(state, 0, now=1.0)
    return eng, state


@pytest.mark.parametrize("n_drop", [1, 2, 3])
def test_secure_dropout_recovery_bitwise(n_drop):
    """Masked round with 1..K-1 dropped clients == survivor-only round with
    UNMASKED payloads and the same shared scales, bit for bit, in each
    package; the two packages' W agree within tolerance."""
    cohort = [0, 1, 2, 3]
    survivors = cohort[n_drop:]
    seed = 11

    stats = _payloads(seed=4)
    q, sA, sb = cohort_quantize_int8([stats[c] for c in cohort])
    masked = {c: secure_agg.mask_quantized_payload(q[i], c, cohort, seed)
              for i, c in enumerate(cohort)}
    _, s_drop = _secure_round(cohort, masked, (sA, sb), survivors, seed=seed)
    unmasked = {c: q[cohort.index(c)] for c in survivors}
    _, s_base = _secure_round(survivors, unmasked, (sA, sb), survivors, seed=seed)
    assert torch.equal(s_drop.W, s_base.W)
    assert torch.equal(s_drop.L, s_base.L)

    jstats = _jpayloads(seed=4)
    jq, jsA, jsb = jcohort_quantize_int8([jstats[c] for c in cohort])
    jmasked = {c: jsecure_agg.mask_quantized_payload(jq[i], c, cohort, seed)
               for i, c in enumerate(cohort)}
    _, js_drop = _secure_round(cohort, jmasked, (jsA, jsb), survivors, seed=seed, jax=True)
    _close_rel(s_drop.W.numpy(), js_drop.W)


def test_secure_live_classifier_serves_last_retired_w():
    stats = _payloads(seed=4)
    cohort = [0, 1]
    q, sA, sb = cohort_quantize_int8([stats[c] for c in cohort])
    masked = {c: secure_agg.mask_quantized_payload(q[i], c, cohort, 0)
              for i, c in enumerate(cohort)}
    eng, state = _secure_round(cohort, masked, (sA, sb), cohort)
    # open slots are masked garbage by design; live serving returns state.W
    assert torch.equal(eng.live_classifier(state), state.W)


def test_secure_chaos_timeline_drops_two_of_ten():
    """run_chaos_timeline in secure mode: 2 of 10 clients never upload, the
    retired W is bitwise the survivor-only unmasked round's."""
    cohort = list(range(10))
    dropped = {3, 7}
    survivors = [c for c in cohort if c not in dropped]
    stats = _payloads(seed=8)
    q, sA, sb = cohort_quantize_int8([stats[c] for c in cohort])
    masked = {c: secure_agg.mask_quantized_payload(q[i], c, cohort, 5)
              for i, c in enumerate(cohort)}
    events = [e for e in chaos_timeline([cohort], latency_profile(10, 0.0, seed=1),
                                        ChaosSpec(duplicate=0.3, reorder=0.5, seed=2))
              if e.client not in dropped]
    eng = AsyncRoundEngine(AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=10,
                                       staleness_rounds=0, secure=True, secure_seed=5),
                           device="cpu")
    st, rep = run_chaos_timeline(eng, eng.init(D), [cohort], events, lambda c, r: masked[c],
                                 scales_for=lambda r: (sA, sb))
    assert rep["dropped_uploads"] == 2
    _, base = _secure_round(survivors, {c: q[c] for c in survivors}, (sA, sb), survivors)
    assert torch.equal(st.W, base.W)


def test_recover_survivor_sum_quantized_host_bitwise():
    stats = _payloads(seed=6)
    cohort = [0, 1, 2, 3, 4]
    q, _, _ = cohort_quantize_int8([stats[c] for c in cohort])
    survivors, dropped = cohort[:3], cohort[3:]
    seed = 9
    masked_sum = secure_agg.secure_aggregate_quantized([
        secure_agg.mask_quantized_payload(q[i], c, cohort, seed)
        for i, c in enumerate(cohort) if c in survivors
    ])
    rec = secure_agg.recover_survivor_sum_quantized(masked_sum, survivors, dropped, seed)
    plain = secure_agg.secure_aggregate_quantized([q[cohort.index(c)] for c in survivors])
    assert torch.equal(rec.qA, plain.qA)
    assert torch.equal(rec.qb, plain.qb)


def test_recover_survivor_sum_float_tolerance():
    stats = _payloads(seed=6)
    cohort = [0, 1, 2]
    survivors, dropped = cohort[:2], cohort[2:]
    seed = 9
    masked = [secure_agg.mask_statistics(stats[c], c, cohort, seed) for c in survivors]
    rec = secure_agg.recover_survivor_sum(
        secure_agg.secure_aggregate(masked), survivors, dropped, seed
    )
    plain_A = sum(stats[c].A.numpy() for c in survivors)
    np.testing.assert_allclose(rec.A.numpy(), plain_A, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# Control-plane errors, serialization, satellites
# ---------------------------------------------------------------------------


def test_begin_round_contiguity_and_overflow():
    eng = _engine(staleness_rounds=1)  # ring of 2
    eng.init(D)
    with pytest.raises(ValueError, match="contiguously"):
        eng.begin_round(1, [0], 0.0)
    eng.begin_round(0, [0], 0.0)
    eng.begin_round(1, [1], 1.0)
    with pytest.raises(RuntimeError, match="ring overflow"):
        eng.begin_round(2, [2], 2.0)
    with pytest.raises(ValueError, match="duplicate"):
        _engine().begin_round(0, [3, 3], 0.0)


def test_deliver_unknown_round_or_client_raises():
    payloads = _payloads()
    eng = _engine()
    state = eng.init(D)
    with pytest.raises(ValueError, match="before begin_round"):
        eng.deliver(state, UploadEvent(0.1, 0, 0, 0), payloads[0])
    eng.begin_round(0, [0, 1], 0.0)
    with pytest.raises(ValueError, match="cohort"):
        eng.deliver(state, UploadEvent(0.1, 0, 9, 0), payloads[9])


def test_timeline_json_roundtrip():
    cohorts = _cohorts(3)
    latency = latency_profile(N_CLIENTS, 0.2, seed=0)
    spec = ChaosSpec(drop=0.3, duplicate=0.2, reorder=0.4, seed=7)
    events = chaos_timeline(cohorts, latency, spec)
    sched = timeline_from_json(timeline_to_json(cohorts, latency, spec, events))
    assert sched["spec"] == spec
    assert sched["cohorts"] == [list(c) for c in cohorts]
    np.testing.assert_allclose(sched["latency"], latency)
    assert sched["events"] == list(events)


@pytest.mark.parametrize("frac,seed", [(0.0, 0), (0.2, 1), (0.5, 7)])
def test_chaos_events_and_json_identical_across_packages(frac, seed):
    cohorts = _cohorts(6, seed=seed)
    kw = dict(straggler_factor=5.0, base=0.25, jitter=0.4, seed=seed)
    latency = latency_profile(N_CLIENTS, frac, **kw)
    np.testing.assert_array_equal(latency, jarrivals.latency_profile(N_CLIENTS, frac, **kw))
    for knobs in FAULTS.values():
        spec, jspec = ChaosSpec(**knobs), jarrivals.ChaosSpec(**knobs)
        events = chaos_timeline(cohorts, latency, spec)
        jevents = jarrivals.chaos_timeline(cohorts, latency, jspec)
        assert [tuple(e) for e in events] == [tuple(e) for e in jevents]
        assert [tuple(e) for e in chaos_round_events(cohorts[2], latency, spec, 2)] == [
            tuple(e) for e in jarrivals.chaos_round_events(cohorts[2], latency, jspec, 2)]
        blob = timeline_to_json(cohorts, latency, spec, events)
        jblob = jarrivals.timeline_to_json(cohorts, latency, jspec, jevents)
        assert blob == jblob
        # a timeline written by either package loads in the other
        mine, theirs = timeline_from_json(jblob), jarrivals.timeline_from_json(blob)
        assert mine["events"] == events and [tuple(e) for e in theirs["events"]] == [
            tuple(e) for e in events]
        assert json.loads(blob)["spec"] == json.loads(jblob)["spec"]


def test_chaos_spec_validation():
    with pytest.raises(ValueError, match="probability"):
        ChaosSpec(drop=1.5)
    with pytest.raises(ValueError, match="max_attempts"):
        ChaosSpec(max_attempts=0)
    with pytest.raises(ValueError, match="straggler_frac"):
        latency_profile(4, 1.5)


def test_straggler_tail_pricing():
    cm = CostModel(b=2.22e6, d=D, C=C)
    out = cm.straggler_tail(16, 0.2, straggler_factor=8.0, base_s=0.3, deadline_s=1.0)
    assert 0.0 < out["p_straggler_round"] <= 1.0
    assert out["async_round_s"] <= out["sync_round_s"]
    assert out["speedup"] >= 1.5  # the bench_async regime
    flat = cm.straggler_tail(16, 0.0, straggler_factor=8.0, base_s=0.3)
    assert flat["speedup"] == pytest.approx(1.0)


def test_shard_cohort_partitions_round_robin():
    cohort = [9, 2, 5, 7, 1]
    parts = [shard_cohort(cohort, s, 3) for s in range(3)]
    joined = sorted(c for p in parts for c in p)
    assert joined == sorted(cohort)
    assert all(len(set(p)) == len(p) for p in parts)
    with pytest.raises(ValueError):
        shard_cohort(cohort, 3, 3)
    from repro.federated.dist import shard_cohort as jshard_cohort

    assert parts == [jshard_cohort(tuple(cohort), s, 3) for s in range(3)]


def test_config_validation():
    with pytest.raises(ValueError, match="cohort"):
        AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=0)
    with pytest.raises(ValueError, match="deadline"):
        AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=1, deadline=0.0)
    with pytest.raises(ValueError, match="secure"):
        AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=1, secure=True,
                    wire=WireFormat(kind="int8"))
    with pytest.raises(ValueError, match="mesh axis"):  # the reference's validation
        AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=1,
                    dist=DistConfig(aggregation="psum"))
    # psum runs on a one-rank world: every slot is this rank's, bitwise merge
    rng = np.random.default_rng(0)
    payloads = {c: fed3r.client_stats(torch.from_numpy(dist_check.grid(rng, (8, dist_check.D))),
                                      torch.from_numpy(rng.integers(0, dist_check.C, size=8)),
                                      dist_check.C)
                for c in range(3)}
    with single_rank_world("gloo", "cpu"):
        psum = DistConfig(aggregation="psum", mesh=make_host_mesh(device_type="cpu"))
        with pytest.raises(ValueError, match="exclusive"):
            AsyncRoundEngine(AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=1, secure=True,
                                         dist=psum), device="cpu")
        got = dist_check.run_async(payloads, 3, psum, "cpu")
    want = dist_check.run_async(payloads, 3, None, "cpu")
    for k in ("W", "L", "live"):
        assert torch.equal(got[k], want[k])
    assert got["status"] == want["status"] == ["folded"] * 3
    if not torch.cuda.is_available():  # the card by default: no CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AsyncRoundEngine(AsyncConfig(n_classes=C, ridge_lambda=LAMBDA, cohort=1))


def test_client_payloads_equal_client_stats():
    fed, _ = jmake_federated_features(seed=2, n=400, d=D, n_classes=C, n_clients=6, alpha=0.3,
                                      noise=2.0)
    pfed = FederatedDataset(np.asarray(fed.features), np.asarray(fed.labels),
                            fed.client_indices, fed.n_classes)
    got = client_payloads(pfed, C, "cpu")
    for k in range(6):
        cd = fed.client(k)
        want = jfed3r.client_stats(jnp.asarray(cd.features), jnp.asarray(cd.labels), C)
        _close_rel(got[k].A.numpy(), want.A, rel=1e-6)
        _close_rel(got[k].b.numpy(), want.b, rel=1e-6)
        assert float(got[k].n) == float(want.n) == len(cd.labels)


# ---------------------------------------------------------------------------
# serve_stream(engine="async") against the reference driver
# ---------------------------------------------------------------------------


@pytest.fixture
def reference_data(monkeypatch):
    """The port's driver on the reference driver's own federation."""

    def make(seed, n, d, n_classes, n_clients, alpha, *, noise, device, **kw):
        fed, test = jmake_federated_features(seed=seed, n=n, d=d, n_classes=n_classes,
                                             n_clients=n_clients, alpha=alpha, noise=noise, **kw)
        ptest = FeatureDataset(torch.as_tensor(np.array(test.features), device=device),
                               torch.as_tensor(np.array(test.labels), device=device).long(),
                               n_classes)
        return FederatedDataset(np.asarray(fed.features), np.asarray(fed.labels),
                                fed.client_indices, fed.n_classes), ptest

    monkeypatch.setattr(serve_stream_mod, "make_federated_features", make)


def test_serve_stream_async_matches_reference_log(reference_data):
    kw = dict(n_waves=12, rate=4.0, segment=3, n_clients=32, d=D, n_classes=5, verbose=False)
    got = serve_stream_mod.serve_stream(engine="async", device="cpu", **kw)
    want = jserve_stream_mod.serve_stream(engine="async", **kw)
    for key in ("wave", "clients_seen", "stale_waves", "served_head", "engine", "dispatches",
                "chaos"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["samples_seen"], want["samples_seen"], rtol=0, atol=0)
    np.testing.assert_allclose(got["stale_samples"], want["stale_samples"], rtol=0, atol=0)
    n_test = 1600  # 20% of the driver's 8,000 samples; one flipped near-tie allowed
    assert np.abs(np.subtract(got["acc_served"], want["acc_served"])).max() <= 1.0 / n_test + 1e-9
    assert abs(got["acc_final"] - want["acc_final"]) <= 1.0 / n_test + 1e-9
    assert len(got["folded"]) == got["chaos"]["folded"] + got["chaos"]["late_folds"]
    assert got["W"].shape == (D, 5) and bool(torch.isfinite(got["W"]).all())


def test_serve_stream_async_w_is_the_closed_form_of_what_folded(reference_data):
    """The drained W against a float64 solve of exactly the folded uploads."""
    got = serve_stream_mod.serve_stream(engine="async", device="cpu", n_waves=8, rate=3.0,
                                        segment=4, n_clients=24, d=D, n_classes=5,
                                        verbose=False)
    fed, _ = jmake_federated_features(seed=0, n=8000, d=D, n_classes=5, n_clients=24, alpha=0.1,
                                      noise=7.0)
    A = LAMBDA * np.eye(D)
    b = np.zeros((D, 5))
    for _, c in got["folded"]:
        cd = fed.client(c)
        x = np.asarray(cd.features, np.float64)
        A += x.T @ x
        b += x.T @ np.eye(5)[np.asarray(cd.labels)]
    W = np.linalg.solve(A, b)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    np.testing.assert_allclose(got["W"].numpy(), W, atol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_federated.py twins this slice rests on
# ---------------------------------------------------------------------------

FED_CLIENTS, FED_C, FED_D = 20, 6, 32


@pytest.fixture(scope="module")
def fed_data():
    fed, test = jmake_federated_features(seed=0, n=1500, d=FED_D, n_classes=FED_C,
                                         n_clients=FED_CLIENTS, alpha=0.0, noise=1.5)
    return fed, test


def _pfed(fed):
    return FederatedDataset(np.asarray(fed.features), np.asarray(fed.labels),
                            fed.client_indices, fed.n_classes)


def _fc(**kw):
    base = dict(n_clients=FED_CLIENTS, clients_per_round=5, n_rounds=20, local_epochs=1,
                local_batch_size=16, client_lr=0.1, algorithm="fedavg", seed=0)
    base.update(kw)
    return FederatedConfig(**base)


def test_fed3r_split_invariance_via_driver(fed_data):
    """Fig. 1: different federated splits converge to identical accuracy."""
    fed, test = fed_data
    f3 = Fed3RConfig(n_classes=FED_C)
    tx, ty = torch.tensor(np.array(test.features)), torch.tensor(np.array(test.labels))
    accs = []
    for n_cl, alpha in [(10, 0.0), (40, 0.0), (20, 100.0)]:
        fed2 = _pfed(fed.repartition(np.random.default_rng(7), n_cl, alpha))
        _, _, h = run_fed3r(fed2, tx, ty, f3, _fc(n_clients=n_cl), eval_every=1000,
                            device="cpu")
        accs.append(h.accuracy[-1])
    assert max(accs) - min(accs) < 1e-6


def test_fed3r_resampled_client_sends_exactly_once(fed_data):
    """With-replacement sampling re-draws clients, but each client's
    statistics enter the sum exactly once: A equals the centralized pass
    within fp32 summation error (scaled to max|A|), and ``n`` counts every
    sample once."""
    fed, test = fed_data
    f3 = Fed3RConfig(n_classes=FED_C)
    cfg = _fc(sample_with_replacement=True, n_rounds=60)
    tx, ty = torch.tensor(np.array(test.features)), torch.tensor(np.array(test.labels))
    _, stats, hist = run_fed3r(_pfed(fed), tx, ty, f3, cfg, device="cpu")
    assert hist.clients_seen[-1] == FED_CLIENTS  # coupon collector finished
    cen = fed3r.client_stats(torch.tensor(np.array(fed.features)),
                             torch.tensor(np.array(fed.labels)), FED_C)
    _close_rel(stats.A.numpy(), cen.A.numpy(), rel=1e-6)
    assert float(stats.n) == len(fed.labels)
