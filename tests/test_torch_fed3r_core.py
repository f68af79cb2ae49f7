"""The port's FED3R core, NCM and calibration against the reference's.

Inputs are drawn with numpy and handed to both packages.  Tolerances:
statistics are fp32 GEMMs summed in different orders, so they are compared
relative to their largest entry; the solve amplifies that by the condition
number of A + λI, which these well-sampled designs keep small.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import calibration as jcal  # noqa: E402
from repro.core import fed3r as jfed3r  # noqa: E402
from repro.core import ncm as jncm  # noqa: E402
from repro_torch.core import calibration, fed3r, ncm  # noqa: E402

N, D, C = 200, 24, 6
STATS_REL = 1e-5  # fp32 sums of 200 products, two orders: ~n·eps of the largest entry
W_ATOL = 1e-5  # solve of a well-conditioned 24×24 system in fp32


def _data(seed=0, n=N, d=D, c=C):
    r = np.random.default_rng(seed)
    feats = r.normal(size=(n, d)).astype(np.float32)
    labels = r.integers(0, c, size=n).astype(np.int32)
    mask = (r.uniform(size=n) > 0.3).astype(np.float32)
    return feats, labels, mask


def _close(got, want, rel=None, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if rel is not None:
        atol = rel * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_masked_design_matches(masked):
    f, y, m = _data(1)
    z, yy, n = fed3r.masked_design(_t(f), _t(y), C, _t(m) if masked else None)
    zr, yr, nr = jfed3r.masked_design(jnp.asarray(f), jnp.asarray(y), C,
                                      jnp.asarray(m) if masked else None)
    assert np.array_equal(z.numpy(), np.asarray(zr))  # elementwise: exact
    assert np.array_equal(yy.numpy(), np.asarray(yr))
    assert float(n) == float(nr)


@pytest.mark.parametrize("masked", [False, True])
def test_client_stats_and_merge_match(masked):
    parts = [_data(s) for s in (2, 3, 4)]
    got = fed3r.init_stats(D, C, "cpu")
    want = jfed3r.init_stats(D, C)
    for f, y, m in parts:
        got = fed3r.merge(got, fed3r.client_stats(_t(f), _t(y), C, _t(m) if masked else None))
        want = jfed3r.merge(want, jfed3r.client_stats(
            jnp.asarray(f), jnp.asarray(y), C, jnp.asarray(m) if masked else None))
    _close(got.A, want.A, rel=STATS_REL)
    _close(got.b, want.b, rel=STATS_REL)
    assert float(got.n) == float(want.n)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("lam", [1e-2, 1.0])
def test_solve_predict_accuracy_match(normalize, lam):
    f, y, _ = _data(5)
    s = fed3r.client_stats(_t(f), _t(y), C)
    js = jfed3r.Fed3RStats(A=jnp.asarray(s.A.numpy()), b=jnp.asarray(s.b.numpy()),
                           n=jnp.asarray(float(s.n)))
    W = fed3r.solve(s, lam, normalize)
    Wr = jfed3r.solve(js, lam, normalize)
    _close(W, Wr, atol=W_ATOL * max(1.0, float(np.abs(np.asarray(Wr)).max())))
    ft, yt, _ = _data(6, n=80)
    _close(fed3r.predict(W, _t(ft)), jfed3r.predict(Wr, jnp.asarray(ft)), rel=1e-5)
    assert float(fed3r.accuracy(W, _t(ft), _t(yt))) == pytest.approx(
        float(jfed3r.accuracy(Wr, jnp.asarray(ft), jnp.asarray(yt))), abs=1.0 / 80
    )


def test_normalize_columns_matches():
    r = np.random.default_rng(7)
    W = r.normal(size=(D, C)).astype(np.float32)
    W[:, 2] = 0.0  # the 1e-12 floor
    _close(fed3r.normalize_columns(_t(W)), jfed3r.normalize_columns(jnp.asarray(W)), atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_ncm_matches(normalize):
    got = ncm.init_stats(D, C, "cpu")
    want = jncm.init_stats(D, C)
    for seed in (8, 9):
        f, y, m = _data(seed)
        got = ncm.merge(got, ncm.client_stats(_t(f), _t(y), C, _t(m)))
        want = ncm.merge(want, jncm.client_stats(jnp.asarray(f), jnp.asarray(y), C,
                                                 jnp.asarray(m)))
    _close(got.sums, want.sums, rel=STATS_REL)
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    W, Wr = ncm.solve(got, normalize), jncm.solve(want, normalize)
    _close(W, Wr, atol=1e-5 * max(1.0, float(np.abs(np.asarray(Wr)).max())))
    ft, yt, _ = _data(10, n=80)
    assert float(ncm.accuracy(W, _t(ft), _t(yt))) == pytest.approx(
        float(jncm.accuracy(Wr, jnp.asarray(ft), jnp.asarray(yt))), abs=1.0 / 80
    )


def test_calibrate_temperature_matches():
    r = np.random.default_rng(11)
    scores = (r.normal(size=(120, C)) * 0.3).astype(np.float32)
    labels = r.integers(0, C, size=120).astype(np.int32)
    T, ces = calibration.calibrate_temperature(_t(scores), _t(labels))
    Tr, cesr = jcal.calibrate_temperature(jnp.asarray(scores), jnp.asarray(labels))
    assert float(T) == float(Tr)
    # logsumexp of ≤ 100-scale logits in fp32: a few ulps of the CE values
    _close(ces, cesr, rel=1e-5)
    W = r.normal(size=(D, C)).astype(np.float32)
    _close(calibration.fold_temperature(_t(W), T), jcal.fold_temperature(jnp.asarray(W), Tr),
           atol=0.0)
