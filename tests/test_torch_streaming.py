"""The port's streaming path against the reference, and on its own properties.

* ``chol_gram_ref`` / the CPU path of ``chol_gram`` against the reference's
  Pallas ``chol_gram_pallas`` (interpret mode), n = 0 included.
* The factored and the deprecated Woodbury core forms against the
  reference's.
* ``pack_arrival_waves`` and every copied schedule function: the same numpy
  arrays as the reference's, bitwise.
* ``StreamingEngine`` against the reference engine (``use_kernel=False``)
  on the same packed timeline: L, b and W within the reference's own
  tolerances (``tests/test_streaming.py``: W 1e-4, L 1e-3 absolute), the
  wave trace's integers exactly.  In the port alone: chunk invariance and
  permutation invariance, bitwise; a reference state carried across
  mid-stream; the refresh policy; ``serve_stream`` end to end on the CPU.
"""
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.core import random_features as jrf  # noqa: E402
from repro.data import make_federated_features as jmake_federated_features  # noqa: E402
from repro.data.pipeline import pack_arrival_waves as jpack_arrival_waves  # noqa: E402
from repro.federated import arrivals as jarrivals  # noqa: E402
from repro.federated.streaming_engine import StreamConfig as JStreamConfig  # noqa: E402
from repro.federated.streaming_engine import StreamingEngine as JStreamingEngine  # noqa: E402
from repro.kernels.chol_update import chol_gram_pallas  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.core.random_features import rff_params_from_jax  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    FederatedDataset,
    PackedArrivals,
    pack_arrival_waves,
)
from repro_torch.federated import arrivals  # noqa: E402
from repro_torch.federated.compress import WireFormat  # noqa: E402
from repro_torch.federated.dist import DistConfig  # noqa: E402
from repro_torch.federated.streaming_engine import (  # noqa: E402
    ReferenceArrivalLoop,
    StreamConfig,
    StreamingEngine,
    batch_equivalent,
    stream_state_from_jax,
)
from repro_torch.federated.tiers import AggregationTree, TierSpec  # noqa: E402
from repro_torch.kernels import chol_update as chol_update_mod  # noqa: E402
from repro_torch.kernels.ops import chol_gram  # noqa: E402
from repro_torch.kernels.ref import chol_gram_ref  # noqa: E402
from repro_torch.launch import serve_stream as serve_stream_mod  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.world import single_rank_world  # noqa: E402

D, C = 24, 6
STATS_REL = 1e-5  # fp32 sums in two orders, relative to the largest entry
# the reference's own engine tolerances (tests/test_streaming.py:157-161)
W_ATOL, L_ATOL = 1e-4, 1e-3


def _make_stream(seed, n_waves, lo=8, hi=40, max_clients=3, d=D, n_classes=C):
    """The reference test's stream generator (tests/test_streaming.py)."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        wave = []
        for _ in range(int(rng.integers(0, max_clients + 1))):
            n = int(rng.integers(lo, hi))
            wave.append((
                rng.normal(size=(n, d)).astype(np.float32),
                rng.integers(0, n_classes, size=n).astype(np.int32),
            ))
        waves.append(wave)
    if all(not w for w in waves):
        waves[0].append((
            rng.normal(size=(lo, d)).astype(np.float32),
            rng.integers(0, n_classes, size=lo).astype(np.int32),
        ))
    return waves


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=None, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if rel is not None:
        atol = rel * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _cfg(**kw):
    base = dict(n_classes=C, ridge_lambda=1e-2)
    base.update(kw)
    return StreamConfig(**base)


def _jcfg(**kw):
    base = dict(n_classes=C, ridge_lambda=1e-2, use_kernel=False)
    base.update(kw)
    return JStreamConfig(**base)


def _engine(**kw):
    return StreamingEngine(_cfg(**kw), device="cpu")


# ---------------------------------------------------------------------------
# the chol_gram kernel's plain version
# ---------------------------------------------------------------------------


def _chol_inputs(d, n, c, seed=0):
    r = np.random.default_rng(seed)
    A = r.normal(size=(d, d)).astype(np.float32)
    L = np.linalg.cholesky(A @ A.T + np.eye(d, dtype=np.float32)).astype(np.float32)
    Z = r.normal(size=(n, d)).astype(np.float32)
    Y = np.eye(c, dtype=np.float32)[r.integers(0, c, size=n)].reshape(n, c)
    return L, Z, Y


@pytest.mark.parametrize("d,n,c", [(16, 30, 3), (65, 129, 7), (24, 7, 5), (24, 0, 4)])
def test_chol_gram_ref_and_cpu_path_match_reference_kernel(d, n, c):
    L, Z, Y = _chol_inputs(d, n, c)
    Gr, Br = chol_gram_pallas(jnp.asarray(L), jnp.asarray(Z), jnp.asarray(Y), interpret=True)
    for fn in (chol_gram_ref, chol_gram):
        G, B = fn(_t(L), _t(Z), _t(Y))
        assert G.dtype == B.dtype == torch.float32
        _close(G.numpy(), Gr, STATS_REL)
        _close(B.numpy(), Br, STATS_REL)


def _masked_wave(d, n, c, seed):
    """A wave as the engine hands it over: padding rows zero in runs, the
    negative features of a masked row -0.0 (a feature times a mask of 0)."""
    L, X, Y = _chol_inputs(d, n, c, seed)
    r = np.random.default_rng(seed + 1)
    m = np.ones(n, np.float32)
    k = 0
    while k < n:
        live, dead = int(r.integers(1, 12)), int(r.integers(0, 40))
        m[k + live:k + live + dead] = 0.0
        k += live + dead
    return L, X * m[:, None], Y * m[:, None], m


@pytest.mark.parametrize("d,n,c", [(24, 150, 5), (65, 129, 7)])
def test_chol_gram_plain_version_matches_reference_kernel_on_a_masked_wave(d, n, c):
    L, Z, Y, m = _masked_wave(d, n, c, seed=3)
    assert np.signbit(Z[m == 0]).any() and (m == 0).sum() >= 32  # −0.0 rows, runs of padding
    Gr, Br = chol_gram_pallas(jnp.asarray(L), jnp.asarray(Z), jnp.asarray(Y), interpret=True)
    live = m > 0
    Gc, Bc = chol_gram_ref(_t(L), _t(Z[live]), _t(Y[live]))  # the live rows alone
    for fn in (chol_gram_ref, chol_gram):
        G, B = fn(_t(L), _t(Z), _t(Y))
        _close(G.numpy(), Gr, STATS_REL)
        _close(B.numpy(), Br, STATS_REL)
        _close(G.numpy(), Gc.numpy(), STATS_REL)
        _close(B.numpy(), Bc.numpy(), STATS_REL)


def test_chol_gram_empty_batch_is_the_pure_reconstruction():
    L, _, _ = _chol_inputs(16, 0, 4, seed=1)
    before = chol_gram.launches
    G, B = chol_gram(_t(L), torch.zeros((0, 16)), torch.zeros((0, 4)))
    assert torch.equal(G, _t(L) @ _t(L).T)
    assert B.shape == (16, 4) and not B.any()
    assert chol_gram.launches == before  # the CPU runs the plain version


def test_chol_gram_validates_inputs():
    L, Z, Y = (_t(a) for a in _chol_inputs(8, 5, 3))
    with pytest.raises(TypeError):
        chol_gram(L.double(), Z, Y)
    with pytest.raises(ValueError):
        chol_gram(L[:, :-1], Z, Y)
    with pytest.raises(ValueError):
        chol_gram(L, Z[:-1], Y)
    with pytest.raises(ValueError):
        chol_gram(L, Z[:, :-1], Y)


# ---------------------------------------------------------------------------
# the factored and the deprecated Woodbury core forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_factored_update_and_solution_match_reference(masked):
    r = np.random.default_rng(14)
    xs = r.normal(size=(3, 50, D)).astype(np.float32)
    ys = r.integers(0, C, size=(3, 50)).astype(np.int32)
    ms = (r.uniform(size=(3, 50)) > 0.3).astype(np.float32)
    st = fed3r.init_factored(D, C, 1e-2, device="cpu")
    jst = jfed3r.init_factored(D, C, 1e-2)
    np.testing.assert_array_equal(st.L.numpy(), np.asarray(jst.L))
    for x, y, m in zip(xs, ys, ms):
        mask = m if masked else None
        st = fed3r.factored_update(st, _t(x), _t(y), None if mask is None else _t(mask))
        jst = jfed3r.factored_update(jst, jnp.asarray(x), jnp.asarray(y),
                                     None if mask is None else jnp.asarray(mask))
    _close(st.L.numpy(), jst.L, atol=L_ATOL)
    _close(st.b.numpy(), jst.b, STATS_REL)
    assert torch.equal(torch.triu(st.L, 1), torch.zeros_like(st.L))
    _close(fed3r.factored_solution(st).numpy(), jfed3r.factored_solution(jst), atol=W_ATOL)
    _close(fed3r.factored_solution(st, normalize=False).numpy(),
           jfed3r.factored_solution(jst, normalize=False), atol=W_ATOL)
    # online_solution routes factored states through the triangular solves
    assert torch.equal(fed3r.online_solution(st), fed3r.factored_solution(st))


def test_psd_cholesky_keeps_the_reference_failure_meaning():
    G = torch.tensor([[1.0, 2.0], [2.0, 1.0]])  # indefinite far beyond rounding
    got = fed3r.psd_cholesky(G).numpy()
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(G.numpy())))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))  # NaN on and below the diagonal
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    spd = torch.tensor([[4.0, 2.0], [2.0, 3.0]])
    L = fed3r.psd_cholesky(spd)
    assert torch.equal(L, torch.linalg.cholesky(spd))  # no jitter where the plain one succeeds
    assert L.is_contiguous()  # row-major, as the chol_gram kernel reads it


def test_stream_survives_a_rank_deficient_first_wave_where_the_reference_goes_nan():
    """Fewer samples than d in the first wave: the fp32 Gram's rounding
    drowns the ridge and the reference's plain Cholesky fails for good; the
    port's guarded factorization stays within the float64 yardstick."""
    d, c, lam = 96, 5, 1e-2
    r = np.random.default_rng(0)
    means = 3.0 * r.normal(size=(c, d))

    def client(n):
        y = r.integers(0, c, size=n).astype(np.int32)
        return ((means[y] + 7.0 * r.normal(size=(n, d))) * 30.0 / 7.0).astype(np.float32), y

    packed = pack_arrival_waves([[client(20)], [client(40), client(30)], [client(60)],
                                 [client(80), client(50)]])
    jeng = JStreamingEngine(_jcfg(n_classes=c, ridge_lambda=lam))
    jstate, _ = jeng.absorb(jeng.init(d), packed)
    assert not bool(jnp.isfinite(jstate.W).all())  # the reference's fault
    cfg = _cfg(n_classes=c, ridge_lambda=lam)
    eng = StreamingEngine(cfg, device="cpu")
    state, _ = eng.absorb(eng.init(d), packed)
    m = _t(packed.mask).reshape(-1, 1).double()
    Z = _t(packed.inputs).reshape(-1, d).double() * m
    Y = torch.nn.functional.one_hot(_t(packed.labels).reshape(-1).long(), c).double() * m
    W64 = torch.linalg.solve(Z.T @ Z + lam * torch.eye(d, dtype=torch.float64), Z.T @ Y)
    W64 = W64 / W64.norm(dim=0, keepdim=True)
    W_batch, _ = batch_equivalent(packed, cfg, device="cpu")
    err_stream = float((state.W.double() - W64).abs().max())
    err_batch = float((W_batch.double() - W64).abs().max())
    assert err_stream <= 2 * err_batch + 1e-5


def test_woodbury_path_matches_reference_and_warns():
    r = np.random.default_rng(15)
    xs = r.normal(size=(3, 20, 8)).astype(np.float32)
    ys = r.integers(0, 3, size=(3, 20)).astype(np.int32)
    with pytest.warns(DeprecationWarning, match="CANCELS"):
        st = fed3r.init_online(8, 3, 1e-3, device="cpu")  # small λ names the hazard
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jst = jfed3r.init_online(8, 3, 1.0)
        st = fed3r.init_online(8, 3, 1.0, device="cpu")
    for x, y in zip(xs, ys):
        st = fed3r.woodbury_update(st, _t(x), _t(y))
        jst = jfed3r.woodbury_update(jst, jnp.asarray(x), jnp.asarray(y))
    _close(st.Ainv.numpy(), jst.Ainv, 1e-4)
    _close(st.b.numpy(), jst.b, STATS_REL)
    with pytest.warns(DeprecationWarning):
        W = fed3r.online_solution(st)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _close(W.numpy(), jfed3r.online_solution(jst), atol=1e-4)


# ---------------------------------------------------------------------------
# the arrival packer and the copied schedules: the reference's arrays, bitwise
# ---------------------------------------------------------------------------


def _assert_packed_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    {}, {"round_to": 4}, {"max_n": 48, "clients_per_wave": 5}, {"num_shards": 4},
    {"canonical_order": False},
])
def test_pack_arrival_waves_equals_reference(kw):
    waves = _make_stream(2, 6)
    ids = [list(range(100 + 10 * t, 100 + 10 * t + len(w)))[::-1] for t, w in enumerate(waves)]
    got = pack_arrival_waves(waves, client_ids=ids, **kw)
    want = jpack_arrival_waves(waves, client_ids=ids, **kw)
    _assert_packed_equal(got, want)
    assert got.n_waves == want.n_waves and got.n_clients == want.n_clients
    assert got.n_samples == want.n_samples and got.clients_per_wave == want.clients_per_wave
    _assert_packed_equal(got.slice_waves(2, 5), want.slice_waves(2, 5))


def test_pack_arrival_waves_validates_like_the_reference():
    waves = _make_stream(3, 3, max_clients=2)
    for bad in (dict(clients_per_wave=0), dict(max_n=1), dict(client_ids=[[0]])):
        with pytest.raises(ValueError):
            jpack_arrival_waves(waves, **bad)
        with pytest.raises(ValueError):
            pack_arrival_waves(waves, **bad)
    with pytest.raises(ValueError):
        pack_arrival_waves([])
    with pytest.raises(ValueError):
        pack_arrival_waves([[], []])
    with single_rank_world("gloo", "cpu"):  # one data shard: the mesh pads nothing
        meshed = pack_arrival_waves(waves, mesh=make_host_mesh(device_type="cpu"))
    assert all(np.array_equal(a, b) for a, b in zip(meshed, pack_arrival_waves(waves)))


def test_packed_arrivals_to_device_keeps_the_arrays():
    packed = pack_arrival_waves(_make_stream(4, 3))
    on = packed.to("cpu")
    assert all(isinstance(a, torch.Tensor) for a in on)
    for a, b in zip(on, packed):
        np.testing.assert_array_equal(a.numpy(), b)
    assert on.n_clients == packed.n_clients and on.n_samples == packed.n_samples
    assert on.slice_waves(1, 2).n_waves == 1


@pytest.mark.parametrize("n_clients,n_waves,rate,seed,drain", [
    (64, 24, 4.0, 0, True), (30, 5, 2.5, 3, False), (10, 40, 0.7, 1, True),
])
def test_poisson_schedule_equals_reference(n_clients, n_waves, rate, seed, drain):
    got = arrivals.poisson_schedule(n_clients, n_waves, rate, seed=seed, drain=drain)
    assert got == jarrivals.poisson_schedule(n_clients, n_waves, rate, seed=seed, drain=drain)


def test_trace_schedule_equals_reference():
    arr = [3, 0, 0, 2, 5, 1]
    assert arrivals.trace_schedule(arr) == jarrivals.trace_schedule(arr)
    assert arrivals.trace_schedule(arr, n_waves=8) == jarrivals.trace_schedule(arr, n_waves=8)
    with pytest.raises(ValueError):
        arrivals.trace_schedule([0, -1])
    with pytest.raises(ValueError):
        arrivals.trace_schedule(arr, n_waves=3)


@pytest.fixture(scope="module")
def fed_stream():
    fed, test = jmake_federated_features(seed=2, n=1200, d=D, n_classes=C, n_clients=30,
                                         alpha=0.1, noise=3.0)
    pfed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, test, pfed


@pytest.mark.parametrize("skew,seed", [(0.0, 0), (0.5, 1), (1.0, 2)])
def test_skewed_schedule_and_dominant_labels_equal_reference(fed_stream, skew, seed):
    fed, _, pfed = fed_stream
    dom = arrivals.dominant_labels(pfed)
    np.testing.assert_array_equal(dom, jarrivals.dominant_labels(fed))
    assert (arrivals.skewed_schedule(dom, 7, skew=skew, seed=seed)
            == jarrivals.skewed_schedule(dom, 7, skew=skew, seed=seed))


@pytest.mark.parametrize("kw", [dict(), dict(exponent=1.3, permute=False), dict(seed=5)])
def test_zipf_traffic_equals_reference(kw):
    got = arrivals.zipf_traffic(1000, 500, **kw)
    want = jarrivals.zipf_traffic(1000, 500, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pack_schedule_equals_reference(fed_stream):
    fed, _, pfed = fed_stream
    sched = jarrivals.poisson_schedule(30, 9, 3.0, seed=4)
    _assert_packed_equal(arrivals.pack_schedule(pfed, sched), jarrivals.pack_schedule(fed, sched))
    np.testing.assert_array_equal(pfed.client_sizes(), fed.client_sizes())


# ---------------------------------------------------------------------------
# the streaming engine against the reference engine
# ---------------------------------------------------------------------------


def _assert_trace_matches(trace, jtrace):
    np.testing.assert_array_equal(trace.refreshed.numpy(), np.asarray(jtrace.refreshed))
    np.testing.assert_array_equal(trace.stale_waves.numpy(), np.asarray(jtrace.stale_waves))
    np.testing.assert_array_equal(trace.n_seen.numpy(), np.asarray(jtrace.n_seen))
    np.testing.assert_array_equal(trace.stale_samples.numpy(), np.asarray(jtrace.stale_samples))


@pytest.mark.parametrize("lam,refresh_every", [(1e-2, 1), (1e-3, 1), (1e-2, 3)])
def test_streaming_engine_matches_reference_engine(lam, refresh_every):
    packed = pack_arrival_waves(_make_stream(5, 10, lo=20, hi=60))
    jeng = JStreamingEngine(_jcfg(ridge_lambda=lam, refresh_every=refresh_every))
    jstate, jtrace = jeng.absorb(jeng.init(D), packed)
    eng = _engine(ridge_lambda=lam, refresh_every=refresh_every)
    state, trace = eng.absorb(eng.init(D), packed)
    _close(state.L.numpy(), jstate.L, atol=L_ATOL)
    _close(state.b.numpy(), jstate.b, STATS_REL)
    _close(state.W.numpy(), jstate.W, atol=W_ATOL)
    assert float(state.n) == float(jstate.n) == packed.n_samples
    assert state.wave == int(jstate.wave) == 10
    assert state.stale_waves == int(jstate.stale_waves)
    assert float(state.stale_samples) == float(jstate.stale_samples)
    _assert_trace_matches(trace, jtrace)
    assert eng.dispatches == 1


def test_streaming_rf_engine_matches_reference_engine():
    d, Dr = 10, 64
    packed = pack_arrival_waves(_make_stream(6, 5, d=d))
    jp = jrf.rff_init(jax.random.PRNGKey(4), d, Dr, sigma=3.0)
    jeng = JStreamingEngine(_jcfg(), rff_params=jp)
    jstate, _ = jeng.absorb(jeng.init(Dr), packed)
    eng = StreamingEngine(_cfg(), rff_params=rff_params_from_jax(jp.omega, jp.beta, jp.sigma,
                                                                 device="cpu"), device="cpu")
    state, _ = eng.absorb(eng.init(Dr), packed)
    _close(state.L.numpy(), jstate.L, atol=L_ATOL)
    _close(state.b.numpy(), jstate.b, STATS_REL)
    _close(state.W.numpy(), jstate.W, atol=W_ATOL)
    assert float(state.n) == float(jstate.n) == packed.n_samples  # padding masked after ψ


def test_absorb_stats_matches_reference():
    r = np.random.default_rng(8)
    x = r.normal(size=(40, D)).astype(np.float32)
    y = r.integers(0, C, size=40).astype(np.int32)
    st = fed3r.client_stats(_t(x), _t(y), C)
    jeng = JStreamingEngine(_jcfg())
    want = jeng.absorb_stats(jeng.init(D), jnp.asarray(st.A.numpy()), jnp.asarray(st.b.numpy()),
                             float(st.n))
    eng = _engine()
    got = eng.absorb_stats(eng.init(D), st.A, st.b, st.n)
    _close(got.L.numpy(), want.L, atol=L_ATOL)
    _close(got.W.numpy(), want.W, atol=W_ATOL)
    assert got.wave == int(want.wave) == 1 and got.stale_waves == 0
    assert float(got.n) == 40.0


def test_stream_state_from_jax_continues_the_stream():
    packed = pack_arrival_waves(_make_stream(9, 8))
    jeng = JStreamingEngine(_jcfg(refresh_every=2))
    whole, _ = jeng.absorb(jeng.init(D), packed)
    half, _ = jeng.absorb(jeng.init(D), PackedArrivals(*[a[:5] for a in packed]))
    eng = _engine(refresh_every=2)
    state = stream_state_from_jax(half, device="cpu")
    assert state.wave == 5 and state.stale_waves == int(half.stale_waves)
    state, trace = eng.absorb(state, packed.slice_waves(5, 8))
    _close(state.L.numpy(), whole.L, atol=L_ATOL)
    _close(state.W.numpy(), whole.W, atol=W_ATOL)
    assert state.wave == int(whole.wave) == 8
    assert trace.refreshed.tolist() == [True, False, True]  # waves 6, 7, 8


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------


def test_streaming_is_chunk_invariant_bitwise():
    packed = pack_arrival_waves(_make_stream(7, 9))
    eng = _engine()
    whole, _ = eng.absorb(eng.init(D), packed)
    state = eng.init(D)
    for lo in (0, 3, 6):
        state, _ = eng.absorb(state, packed.slice_waves(lo, lo + 3))
    assert state.wave == whole.wave == 9
    assert torch.equal(whole.L, state.L) and torch.equal(whole.W, state.W)


def test_final_w_bit_invariant_under_concurrent_arrival_permutation():
    waves = _make_stream(8, 6, max_clients=4)
    ids, nxt = [], 0
    for w in waves:
        ids.append(list(range(nxt, nxt + len(w))))
        nxt += len(w)
    rng = np.random.default_rng(9)
    shuffled, sh_ids = [], []
    for w, wi in zip(waves, ids):
        perm = rng.permutation(len(w))
        shuffled.append([w[i] for i in perm])
        sh_ids.append([wi[i] for i in perm])
    eng = _engine()
    s1, _ = eng.absorb(eng.init(D), pack_arrival_waves(waves, client_ids=ids))
    s2, _ = eng.absorb(eng.init(D), pack_arrival_waves(shuffled, client_ids=sh_ids))
    assert torch.equal(s1.L, s2.L) and torch.equal(s1.b, s2.b) and torch.equal(s1.W, s2.W)


def test_refresh_policy_staleness_and_batch_equivalent():
    packed = pack_arrival_waves(_make_stream(10, 8, max_clients=2))
    eng = _engine(refresh_every=3)
    state, trace = eng.absorb(eng.init(D), packed)
    assert trace.refreshed.tolist() == [False, False, True] * 2 + [False, False]
    assert trace.stale_waves.tolist() == [1, 2, 0, 1, 2, 0, 1, 2]
    per_wave = packed.mask.sum(axis=(1, 2))
    assert float(trace.stale_samples[1]) == pytest.approx(per_wave[:2].sum())
    assert float(trace.stale_samples[2]) == 0.0
    W_at_6, _ = batch_equivalent(PackedArrivals(*[a[:6] for a in packed]), _cfg(), device="cpu")
    _close(state.W.numpy(), W_at_6.numpy(), atol=1e-5)
    refreshed = eng.refresh(state)
    W_final, stats = batch_equivalent(packed, _cfg(), device="cpu")
    _close(refreshed.W.numpy(), W_final.numpy(), atol=1e-5)
    assert refreshed.stale_waves == 0 and float(refreshed.stale_samples) == 0.0
    assert float(stats.n) == packed.n_samples
    assert eng.dispatches == 2


def test_legacy_woodbury_visibly_diverges_where_engine_holds():
    packed = pack_arrival_waves(_make_stream(6, 16, lo=40, hi=80))
    cfg = _cfg()
    eng = StreamingEngine(cfg, device="cpu")
    state, _ = eng.absorb(eng.init(D), packed)
    legacy = ReferenceArrivalLoop(cfg, device="cpu")
    W_legacy = legacy.classifier(legacy.absorb(legacy.init(D), packed))
    W_batch, _ = batch_equivalent(packed, cfg, device="cpu")
    err_fac = float((state.W - W_batch).abs().max())
    err_leg = float((W_legacy - W_batch).abs().max())
    assert legacy.dispatches == packed.n_waves
    assert err_fac <= 1e-4
    assert err_leg > 10 * max(err_fac, 1e-7)


def test_streaming_rejects_unported_options():
    with pytest.raises(ValueError):
        _engine(refresh_every=0)
    # compressed wires are ported: a WireFormat is taken, an unknown kind refused
    assert _engine(wire=WireFormat(kind="int8", tile=16)).wire == WireFormat(kind="int8", tile=16)
    with pytest.raises(ValueError):
        _cfg(wire=WireFormat(kind="int4"))
    with pytest.raises(ValueError, match="mesh axis"):  # the reference's validation
        _cfg(dist=DistConfig(aggregation="psum"))
    # host-tier trees fold in TieredAbsorber (tests/test_torch_tiers.py); a
    # mesh-routed tree routes the psum backend instead
    mesh_routed = AggregationTree((TierSpec("data", fan_in=1, axis="data"),))
    with pytest.raises(ValueError, match="route through DistConfig"):
        _engine().tiered_absorber(mesh_routed)
    # psum runs on a one-rank world: on the CPU the plain chol_gram is
    # L Lᵀ + ZᵀZ, so the psum wave's L Lᵀ + S is bitwise the merge wave
    packed = pack_arrival_waves(_make_stream(4, 3, max_clients=2))
    want, _ = _engine().absorb(_engine().init(D), packed)
    with single_rank_world("gloo", "cpu"):
        mesh = make_host_mesh(device_type="cpu")
        eng = StreamingEngine(_cfg(dist=DistConfig(aggregation="psum", mesh=mesh)), device="cpu")
        got, _ = eng.absorb(eng.init(D), packed)
        with pytest.raises(ValueError, match="dist-owned mesh"):
            eng.absorb_stats(got, got.L, got.b, got.n)
    assert torch.equal(got.L, want.L) and torch.equal(got.W, want.W)
    with pytest.raises(TypeError):
        StreamingEngine(_cfg(), rff_params=object(), device="cpu")


@pytest.mark.parametrize("policy,k", [("arrival", 1), ("every-k", 4)])
def test_serve_stream_on_the_cpu(policy, k):
    log = serve_stream_mod.serve_stream(
        n_waves=8, rate=3.0, policy=policy, k=k, segment=3, n_clients=24, d=16, n_classes=5,
        verbose=False, device="cpu",
    )
    for key in ("wave", "clients_seen", "samples_seen", "stale_waves", "stale_samples",
                "acc_served", "served_head", "engine", "dispatches", "acc_final", "wall_s"):
        assert key in log
    packed, trace = log["packed"], log["trace"]
    assert log["wave"] == [3, 6, 8] and log["clients_seen"][-1] == 24 == packed.n_clients
    assert log["samples_seen"][-1] == packed.n_samples == 6400
    assert log["dispatches"] == 3 + 1  # one absorb per segment, one final refresh
    t = np.arange(1, 9)
    assert trace.refreshed.tolist() == list(t % k == 0)
    assert trace.stale_waves.tolist() == [0 if w % k == 0 else w % k for w in t]
    assert log["stale_waves"] == [int(trace.stale_waves[i]) for i in (2, 5, 7)]
    W_batch, _ = batch_equivalent(packed, _cfg(n_classes=5), device="cpu")
    _close(log["W"].numpy(), W_batch.numpy(), atol=W_ATOL)
    assert log["acc_final"] > 0.5


def test_serve_stream_refuses_unported_engines():
    # engine="slots" (tests/test_torch_serving.py) and engine="async"
    # (tests/test_torch_async.py) are ported; an unknown engine is refused
    with pytest.raises(ValueError, match="unknown serving engine"):
        serve_stream_mod.serve_stream(engine="fifo", device="cpu")
    log = serve_stream_mod.serve_stream(engine="async", device="cpu", n_waves=2, rate=2.0,
                                        segment=2, n_clients=8, d=8, n_classes=3,
                                        verbose=False)
    assert log["engine"] == "async" and log["wave"] == [2]


def test_streaming_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.federated.streaming_engine, repro_torch.federated.arrivals
        import repro_torch.launch.serve_stream, repro_torch.kernels.chol_update as m
        assert m.LIBRARY.lib is None and m.LIBRARY.build_log == ""
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print(m.LIBRARY.path().name)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/nonexistent", "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == chol_update_mod.LIBRARY.path().name
