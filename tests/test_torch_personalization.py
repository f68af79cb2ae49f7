"""The port's personalization path against the reference, and on its own properties.

* ``batched_chol_gram_ref`` / the CPU path of ``batched_chol_gram`` against
  the reference's Pallas ``batched_chol_gram_pallas`` (interpret mode) and
  its ``batched_chol_gram_ref``, n = 0 included.
* ``psd_cholesky`` on batches: per-matrix bounds, and bit-identical on 2-D
  input to the 2-D implementation it replaced.
* ``personalized_solution`` / ``batched_personalized_solution`` against the
  reference's; α = 0 bitwise with the port's ``factored_solution``.
* ``pack_personal_cohort``: the reference's arrays, bit for bit.
* ``PersonalizationEngine`` against the reference engine on the same numpy
  cohort and global state (its kernel path in interpret mode, and its XLA
  path): the same selected α, heads within the reference's own engine
  tolerance (``tests/test_personalization.py``: 1e-4); in the port alone:
  α = 0 and padded rows bitwise, first-grid-entry ties, request-order
  invariance, one dispatch against the reference loop's K + 1.
"""
import math
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data.pipeline import make_federated_features as jmake_federated_features  # noqa: E402
from repro.data.pipeline import pack_personal_cohort as jpack_personal_cohort  # noqa: E402
from repro.federated.personalization import PersonalizationEngine as JEngine  # noqa: E402
from repro.federated.personalization import PersonalizeConfig as JConfig  # noqa: E402
from repro.federated.personalization import cohort_stats as jcohort_stats  # noqa: E402
from repro.kernels.chol_update import batched_chol_gram_pallas  # noqa: E402
from repro.kernels.ref import batched_chol_gram_ref as jbatched_chol_gram_ref  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import PackedPersonalCohort, pack_personal_cohort  # noqa: E402
from repro_torch.federated.dist import DistConfig  # noqa: E402
from repro_torch.federated.personalization import (  # noqa: E402
    PersonalizationEngine,
    PersonalizeConfig,
    ReferencePersonalizedLoop,
    cohort_stats,
)
from repro_torch.federated.streaming_engine import factored_from_jax  # noqa: E402
from repro_torch.kernels import chol_update as chol_update_mod  # noqa: E402
from repro_torch.kernels.ops import batched_chol_gram  # noqa: E402
from repro_torch.kernels.ref import batched_chol_gram_ref  # noqa: E402

D, C, LAM = 24, 6, 1e-2
GRID = (0.0, 0.5, 1.0, 2.0)
STATS_REL = 1e-5  # fp32 sums in two orders, relative to the largest entry
# the reference's own tolerance between its engine paths (tests/test_personalization.py)
W_ATOL = 1e-4


def _make_clients(seed, K, lo=20, hi=60, d=D, n_classes=C):
    """The reference test's cohort generator (tests/test_personalization.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(K):
        n = int(rng.integers(lo, hi))
        out.append((
            rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, n_classes, size=n).astype(np.int32),
        ))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=None, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if rel is not None:
        atol = rel * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _states(packed, lam=LAM):
    """One global factored state for both packages: the reference's Cholesky
    of the cohort's statistics, carried into the port."""
    stats = jcohort_stats(packed, C)
    L = jnp.linalg.cholesky(stats.A + lam * jnp.eye(D, dtype=jnp.float32))
    jstate = jfed3r.Fed3RFactored(L=L, b=stats.b)
    return jstate, factored_from_jax(jstate.L, jstate.b, device="cpu")


def _engine(**kw):
    base = dict(n_classes=C, alpha_grid=GRID)
    base.update(kw)
    return PersonalizationEngine(PersonalizeConfig(**base), device="cpu")


def _jengine(use_kernel, **kw):
    base = dict(n_classes=C, alpha_grid=GRID, use_kernel=use_kernel)
    base.update(kw)
    return JEngine(JConfig(**base))


# ---------------------------------------------------------------------------
# the batched_chol_gram kernel's plain version
# ---------------------------------------------------------------------------


def _batched_inputs(K, n, d, c, seed=0):
    r = np.random.default_rng(seed)
    A = r.normal(size=(d, d)).astype(np.float32)
    L = np.linalg.cholesky(A @ A.T + np.eye(d, dtype=np.float32)).astype(np.float32)
    Z = r.normal(size=(K, n, d)).astype(np.float32)
    Y = np.eye(c, dtype=np.float32)[r.integers(0, c, size=(K, n))].reshape(K, n, c)
    return L, Z, Y


@pytest.mark.parametrize("K,n,d,c", [(3, 30, 16, 3), (2, 129, 65, 7), (4, 7, 24, 5), (3, 0, 16, 4)])
def test_batched_chol_gram_ref_and_cpu_path_match_reference_kernel(K, n, d, c):
    L, Z, Y = _batched_inputs(K, n, d, c)
    jL, jZ, jY = jnp.asarray(L), jnp.asarray(Z), jnp.asarray(Y)
    Gp, Bp = batched_chol_gram_pallas(jL, jZ, jY, interpret=True)
    Gr, Br = jbatched_chol_gram_ref(jL, jZ, jY)
    before = batched_chol_gram.launches
    for fn in (batched_chol_gram_ref, batched_chol_gram):
        G, B = fn(_t(L), _t(Z), _t(Y))
        assert G.dtype == B.dtype == torch.float32
        assert G.shape == (K, d, d) and B.shape == (K, d, c)
        for want_G, want_B in ((Gp, Bp), (Gr, Br)):
            _close(G.numpy(), want_G, STATS_REL)
            _close(B.numpy(), want_B, STATS_REL)
        if n == 0:
            assert not B.any()  # no sample rows: B exactly 0
            assert torch.equal(G, (_t(L) @ _t(L).T).expand(K, d, d))
    assert batched_chol_gram.launches == before  # the CPU runs the plain version


def test_batched_chol_gram_validates_inputs():
    L, Z, Y = (_t(a) for a in _batched_inputs(2, 5, 8, 3))
    with pytest.raises(TypeError):
        batched_chol_gram(L.double(), Z, Y)
    with pytest.raises(ValueError):
        batched_chol_gram(L, Z[0], Y[0])  # unbatched operands
    with pytest.raises(ValueError):
        batched_chol_gram(L, Z[:, :-1], Y)
    with pytest.raises(ValueError):
        batched_chol_gram(L, Z[:1], Y)
    with pytest.raises(ValueError):
        batched_chol_gram(L, Z.transpose(1, 2).contiguous().transpose(1, 2), Y)


# ---------------------------------------------------------------------------
# psd_cholesky on batches
# ---------------------------------------------------------------------------


def _psd_cholesky_2d(G):
    """``core/fed3r.py::psd_cholesky`` as it was before it took batches."""
    d = G.shape[0]
    L, info = torch.linalg.cholesky_ex(G, check_errors=False)
    bound = math.sqrt(d) * torch.finfo(torch.float32).eps * G.diagonal().amax()
    eye = torch.eye(d, dtype=G.dtype, device=G.device)
    for mult in (1.0, 4.0, 16.0):
        retry, retry_info = torch.linalg.cholesky_ex(G + (mult * bound) * eye, check_errors=False)
        take = (info != 0) & (retry_info == 0)
        L = torch.where(take, retry, L)
        info = torch.where(take, retry_info, info)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")).tril()).contiguous()


def _shifted_gram(shift, d=16, scale=1.0, seed=0):
    """A symmetric matrix whose smallest eigenvalue is ``shift`` times the
    jitter bound √d·eps·max diag: negative shifts fail a plain Cholesky."""
    r = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(r.normal(size=(d, d)))
    ev = scale * np.linspace(1.0, 4.0, d)
    G = (Q * ev) @ Q.T
    ev[0] = shift * math.sqrt(d) * np.finfo(np.float32).eps * G.diagonal().max()
    return torch.tensor(((Q * ev) @ Q.T).astype(np.float32))


@pytest.mark.parametrize("shift", [3.0, -0.5, -2.0, -6.0, -40.0])
def test_psd_cholesky_is_bit_identical_on_2d_input(shift):
    G = _shifted_gram(shift)
    plain_fails = int(torch.linalg.cholesky_ex(G)[1]) != 0
    assert plain_fails == (shift < 0)  # the negative shifts exercise the retries
    got, want = fed3r.psd_cholesky(G), _psd_cholesky_2d(G)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert bool(torch.isfinite(got).all()) == (shift > -40.0)  # -40: every retry fails


def test_psd_cholesky_takes_its_bound_per_matrix():
    """A batch factors each matrix as the 2-D call would: a failing matrix
    beside one with a 1e4× larger diagonal gets its own small jitter."""
    Gs = torch.stack([
        _shifted_gram(-0.5), _shifted_gram(3.0, scale=1e4, seed=1), _shifted_gram(-40.0, seed=2),
    ])
    batched = fed3r.psd_cholesky(Gs)
    assert batched.shape == Gs.shape and batched.is_contiguous()
    for k in range(3):
        want = _psd_cholesky_2d(Gs[k])
        assert torch.equal(torch.nan_to_num(batched[k]), torch.nan_to_num(want))
        assert torch.equal(torch.isnan(batched[k]), torch.isnan(want))
    assert bool(torch.isfinite(batched[:2]).all()) and bool(torch.isnan(batched[2]).any())
    # a grid × heads batch, as the α sweep factors it
    assert fed3r.psd_cholesky(Gs[:2].expand(3, 2, 16, 16)).shape == (3, 2, 16, 16)


# ---------------------------------------------------------------------------
# the core personalized forms
# ---------------------------------------------------------------------------


def _client_stats_pair(packed, k):
    args = (packed.inputs[k], packed.labels[k])
    js = jfed3r.client_stats(*(jnp.asarray(a) for a in args), C, jnp.asarray(packed.mask[k]))
    ps = fed3r.client_stats(*(_t(a) for a in args), C, _t(packed.mask[k]))
    return js, ps


@pytest.mark.parametrize("alpha", [0.0, 0.5, 4.0])
def test_personalized_solution_matches_reference(alpha):
    packed = pack_personal_cohort(_make_clients(5, 3))
    jstate, state = _states(packed)
    js, ps = _client_stats_pair(packed, 1)
    _close(ps.A.numpy(), js.A, STATS_REL)
    W = fed3r.personalized_solution(state, ps, alpha)
    _close(W.numpy(), jfed3r.personalized_solution(jstate, js, alpha), atol=W_ATOL)
    Wg = fed3r.factored_solution(state)
    if alpha == 0.0:
        assert torch.equal(W, Wg)  # the carried (L, b), never refactored
        assert torch.equal(fed3r.personalized_solution(state, ps, torch.tensor(0.0)), Wg)
    else:
        assert float((W - Wg).abs().max()) > 1e-4  # visibly off the global head
    raw = fed3r.personalized_solution(state, ps, alpha, normalize=False)
    _close(raw.numpy(), jfed3r.personalized_solution(jstate, js, alpha, normalize=False),
           atol=W_ATOL)


def test_batched_personalized_solution_matches_reference_and_per_client():
    packed = pack_personal_cohort(_make_clients(7, 4))
    jstate, state = _states(packed)
    pairs = [_client_stats_pair(packed, k) for k in range(4)]
    alphas = np.array([0.0, 1.0, 2.0, 0.5], np.float32)
    W = fed3r.batched_personalized_solution(
        state, torch.stack([p.A for _, p in pairs]), torch.stack([p.b for _, p in pairs]),
        _t(alphas))
    Wj = jfed3r.batched_personalized_solution(
        jstate, jnp.stack([j.A for j, _ in pairs]), jnp.stack([j.b for j, _ in pairs]),
        jnp.asarray(alphas))
    assert W.shape == (4, D, C)
    _close(W.numpy(), Wj, atol=W_ATOL)
    for k in range(4):  # the reference test's per-client tolerance
        np.testing.assert_allclose(
            W[k].numpy(), fed3r.personalized_solution(state, pairs[k][1], alphas[k]).numpy(),
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the personal-cohort packer: the reference's arrays, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"cohort_size": 8}, {"holdout_frac": 0.5}, {"holdout_frac": 0.0},
    {"holdout_frac": 0.3, "round_to": 4}, {"max_n": 72}, {"canonical_order": False},
    {"num_shards": 4, "cohort_size": 6},
])
def test_pack_personal_cohort_equals_reference(kw):
    clients = _make_clients(2, 6, lo=1, hi=40)
    ids = [17, 3, 250, 9, 4, 88]
    got = pack_personal_cohort(clients, client_ids=ids, **kw)
    want = jpack_personal_cohort(clients, client_ids=ids, **kw)
    assert isinstance(got, PackedPersonalCohort)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got.cohort, got.n_clients, got.n_samples, got.n_holdout) == (
        want.cohort, want.n_clients, want.n_samples, want.n_holdout)


def test_pack_personal_cohort_holdout_rule_and_validation():
    # one sample: no holdout; fewer than the stride: the last one; never index 0
    tiny = [(np.ones((1, D), np.float32), np.zeros((1,), np.int32)),
            (np.ones((3, D), np.float32), np.zeros((3,), np.int32)),
            (np.ones((9, D), np.float32), np.zeros((9,), np.int32))]
    p = pack_personal_cohort(tiny, holdout_frac=0.25)
    assert p.holdout[0].sum() == 0.0
    assert p.holdout[1].tolist()[:3] == [0.0, 0.0, 1.0]
    assert np.flatnonzero(p.holdout[2]).tolist() == [3, 7]  # stride round(1/0.25) = 4
    assert np.all(p.holdout <= p.mask) and p.holdout[:, 0].sum() == 0.0
    clients = _make_clients(1, 3)
    for bad in (dict(cohort_size=2), dict(holdout_frac=1.0), dict(max_n=2), dict(num_shards=0)):
        with pytest.raises(ValueError):
            pack_personal_cohort(clients, **bad)
    with pytest.raises(ValueError):
        pack_personal_cohort([])
    with pytest.raises(NotImplementedError, match="item 8"):
        pack_personal_cohort(clients, mesh=object())


def test_cohort_stats_matches_reference():
    packed = pack_personal_cohort(_make_clients(12, 5), cohort_size=8)
    got, want = cohort_stats(packed, C, device="cpu"), jcohort_stats(packed, C)
    _close(got.A.numpy(), want.A, STATS_REL)
    _close(got.b.numpy(), want.b, STATS_REL)
    assert float(got.n) == float(want.n) == packed.n_samples


def test_factored_from_jax_carries_the_arrays():
    packed = pack_personal_cohort(_make_clients(3, 2))
    jstate, state = _states(packed)
    assert state.L.dtype == torch.float32 and state.L.is_contiguous()
    np.testing.assert_array_equal(state.L.numpy(), np.asarray(jstate.L))
    np.testing.assert_array_equal(state.b.numpy(), np.asarray(jstate.b))


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False])  # True: Pallas in interpret mode
@pytest.mark.parametrize("selection,seed", [("error", 3), ("error", 10), ("sse", 10)])
def test_solve_heads_matches_reference_engine(use_kernel, selection, seed):
    packed = pack_personal_cohort(_make_clients(seed, 5, lo=30, hi=80), cohort_size=8)
    jstate, state = _states(packed)
    grid = (0.0, 0.5, 1.0, 2.0, 4.0)
    want = _jengine(use_kernel, alpha_grid=grid, selection=selection).solve_heads(jstate, packed)
    eng = _engine(alpha_grid=grid, selection=selection)
    got = eng.solve_heads(state, packed)
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    np.testing.assert_array_equal(got.client_ids.numpy(), np.asarray(want.client_ids))
    _close(got.W.numpy(), want.W, atol=W_ATOL)
    if selection == "error":  # integer error counts
        np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    else:
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=1e-4)
    assert eng.dispatches == 1


@pytest.mark.parametrize("use_kernel", [True, False])
def test_solve_at_matches_reference_engine(use_kernel):
    packed = pack_personal_cohort(_make_clients(6, 6))
    jstate, state = _states(packed)
    alphas = np.array([0.0, 2.0, 0.0, 1.0, 0.0, 0.5], np.float32)
    want = _jengine(use_kernel).solve_at(jstate, packed, jnp.asarray(alphas))
    got = _engine().solve_at(state, packed, alphas)
    _close(got.W.numpy(), want.W, atol=W_ATOL)
    W_g = fed3r.factored_solution(state)
    for k, a in enumerate(alphas):
        if a == 0.0:
            assert torch.equal(got.W[k], W_g)  # α = 0 rows: the global head, bitwise
        else:
            assert float((got.W[k] - W_g).abs().max()) > 1e-5


def test_alpha_zero_and_padded_rows_are_factored_solution_bitwise():
    packed = pack_personal_cohort(_make_clients(4, 5), cohort_size=8)
    _, state = _states(packed)
    W_g = fed3r.factored_solution(state)
    pinned = _engine(alpha_grid=(0.0,)).solve_heads(state, packed)  # no sweep
    for k in range(packed.cohort):  # real AND padded slots
        assert torch.equal(pinned.W[k], W_g)
    swept = _engine().solve_heads(state, packed)
    for k in range(packed.cohort):
        if float(swept.alpha[k]) == 0.0 or int(swept.client_ids[k]) < 0:
            assert torch.equal(swept.W[k], W_g)
    assert (swept.client_ids < 0).sum() == 3 and bool((swept.alpha[swept.client_ids < 0] == 0).all())


def test_ties_select_the_first_grid_entry():
    """Equal held-out scores pick ``alpha_grid[0]``, as the reference's argmin
    does: with no holdout split every candidate scores 0."""
    grid = (2.0, 0.5, 1.0)
    packed = pack_personal_cohort(_make_clients(8, 4), holdout_frac=0.0)
    jstate, state = _states(packed)
    heads = _engine(alpha_grid=grid).solve_heads(state, packed)
    want = _jengine(False, alpha_grid=grid).solve_heads(jstate, packed)
    assert heads.alpha.tolist() == [2.0] * 4 == np.asarray(want.alpha).tolist()
    assert heads.score.tolist() == [0.0] * 4
    scores = torch.tensor([[1.0, 0.0, 3.0], [1.0, 0.0, 3.0], [1.0, 2.0, 3.0]])
    assert torch.argmin(scores, dim=0).tolist() == [0, 0, 0]  # first occurrence, per column


def test_heads_are_bit_invariant_to_request_order():
    clients = _make_clients(9, 7)
    ids = list(range(7))
    perm = [4, 1, 6, 0, 2, 5, 3]
    _, state = _states(pack_personal_cohort(clients, client_ids=ids))
    eng = _engine()
    h1 = eng.solve_heads(state, pack_personal_cohort(clients, client_ids=ids))
    h2 = eng.solve_heads(state, pack_personal_cohort(
        [clients[i] for i in perm], client_ids=[ids[i] for i in perm]))
    assert torch.equal(h1.client_ids, h2.client_ids)
    assert torch.equal(h1.alpha, h2.alpha) and torch.equal(h1.W, h2.W)


def test_engine_matches_reference_loop_with_one_dispatch_against_k_plus_one():
    packed = pack_personal_cohort(_make_clients(8, 8, lo=30, hi=70))
    _, state = _states(packed)
    cfg = PersonalizeConfig(n_classes=C, alpha_grid=GRID)
    eng = PersonalizationEngine(cfg, device="cpu")
    heads = eng.solve_heads(state, packed)
    loop = ReferencePersonalizedLoop(cfg, device="cpu")
    W_g, W_loop = loop.solve_at(state, packed, heads.alpha)
    assert eng.dispatches == 1
    assert loop.dispatches == packed.cohort + 1
    assert torch.equal(W_g, fed3r.factored_solution(state))
    assert float((heads.W - W_loop).abs().max()) <= 1e-5


def test_personalization_recovers_tenant_concept_drift():
    """Tenants whose label concepts disagree with the federation (two classes
    swapped) get personalized heads that beat the global head on their own
    held-back data — the reference test's scenario, on the reference's data."""
    fed, _ = jmake_federated_features(seed=11, n=4000, d=D, n_classes=C, n_clients=10,
                                      alpha=0.3, noise=2.0)
    clients, eval_xy = [], []
    for k in range(fed.n_clients):
        cd = fed.client(k)
        labels = np.asarray(cd.labels)
        if k % 2 == 1:
            rng = np.random.default_rng((11, k))
            i, j = rng.choice(C, size=2, replace=False)
            perm = np.arange(C)
            perm[[i, j]] = perm[[j, i]]
            labels = perm[labels]
        half = max(cd.n // 2, 1)
        clients.append((cd.features[:half], labels[:half]))
        eval_xy.append((cd.features[half:], labels[half:]))
    packed = pack_personal_cohort(clients, client_ids=list(range(fed.n_clients)))
    stats = cohort_stats(packed, C, device="cpu")
    L = fed3r.psd_cholesky(stats.A + LAM * torch.eye(D))
    state = fed3r.Fed3RFactored(L=L, b=stats.b)
    heads = _engine(alpha_grid=(0.0, 1.0, 4.0, 16.0, 64.0)).solve_heads(state, packed)
    W_g = fed3r.factored_solution(state)
    acc_p, acc_g = [], []
    for k, (x, y) in enumerate(eval_xy):
        if len(y):
            acc_p.append(float(fed3r.accuracy(heads.W[k], _t(x), _t(y))))
            acc_g.append(float(fed3r.accuracy(W_g, _t(x), _t(y))))
    assert np.mean(acc_p) > np.mean(acc_g) + 0.05


def test_config_refuses_what_the_port_lacks():
    with pytest.raises(ValueError):
        PersonalizeConfig(n_classes=C, alpha_grid=())
    with pytest.raises(ValueError):
        PersonalizeConfig(n_classes=C, alpha_grid=(0.0, -1.0))
    with pytest.raises(ValueError):
        PersonalizeConfig(n_classes=C, selection="accuracy")
    with pytest.raises(TypeError):
        PersonalizeConfig(n_classes=C, use_kernel=True)  # the tensor's device decides
    with pytest.raises(NotImplementedError, match="item 8"):
        PersonalizeConfig(n_classes=C, dist=DistConfig(aggregation="psum"))


def test_personalization_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.federated.personalization, repro_torch.federated.slots
        import repro_torch.launch.serve_heads, repro_torch.launch.serving_engine
        import repro_torch.kernels.chol_update as m
        assert m.BATCHED_LIBRARY.lib is None and m.BATCHED_LIBRARY.build_log == ""
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print(m.BATCHED_LIBRARY.path().name)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/nonexistent", "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == chol_update_mod.BATCHED_LIBRARY.path().name
