"""The port's FED3R-RF path against the reference: kernel, features, engine, driver.

* ``rff_ref`` and the CPU path of ``rff_transform`` against the reference's
  Pallas ``rff_pallas`` (interpret mode) and its ``rff_map``.  ψ is bounded
  by √(2/D), so the tolerance is 1e-5·√(2/D): fp32 products summed in two
  orders, then a cos of an argument below ~10.
* ``rff_init`` on its own properties (the two packages draw from different
  random streams); reference-drawn (Ω, β) are carried across with
  ``rff_params_from_jax`` wherever results are compared.
* The RF accumulation engine and ``run_fed3r(n_random_features > 0)``
  against the reference's: A and b within 1e-5 of their largest entry, W
  within 1e-4.
"""
import math
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import Fed3RConfig as JFed3RConfig  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core import random_features as jrf  # noqa: E402
from repro.data import make_federated_features as jmake_federated_features  # noqa: E402
from repro.data.pipeline import pack_client_shards as jpack  # noqa: E402
from repro.federated import run_fed3r as jrun_fed3r  # noqa: E402
from repro.federated.engine import AccumulationEngine as JEngine  # noqa: E402
from repro.federated.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.kernels.rff import rff_pallas  # noqa: E402
from repro_torch.configs.base import Fed3RConfig, FederatedConfig  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.core.random_features import (  # noqa: E402
    RFFParams,
    rbf_kernel,
    rff_init,
    rff_map,
    rff_params_from_jax,
)
from repro_torch.data.pipeline import FederatedDataset, pack_client_shards  # noqa: E402
from repro_torch.federated import fed3r_driver  # noqa: E402
from repro_torch.federated.engine import AccumulationEngine, EngineConfig  # noqa: E402
from repro_torch.kernels import rff as rff_mod  # noqa: E402
from repro_torch.kernels.ops import fed3r_stats, rff_transform  # noqa: E402
from repro_torch.kernels.ref import rff_ref  # noqa: E402

STATS_REL = 1e-5  # fp32 sums of ≤ 1200 products in two orders, scaled to max|A|
W_ATOL = 1e-4


def _rff_inputs(n, d, D, sigma, seed=0, scale=3.0):
    r = np.random.default_rng(seed)
    Z = (scale * r.normal(size=(n, d))).astype(np.float32)
    omega = (r.normal(size=(d, D)) / sigma).astype(np.float32)
    beta = r.uniform(0.0, 2.0 * np.pi, size=D).astype(np.float32)
    return Z, omega, beta


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(float(np.abs(want).max()), 1.0)


# ragged in every dimension: none is a multiple of a tile
SHAPES = [(37, 20, 130), (129, 64, 256), (5, 3, 7)]


@pytest.mark.parametrize("n,d,D", SHAPES)
@pytest.mark.parametrize("sigma", [1.0, 10.0])
def test_rff_ref_and_cpu_path_match_reference_kernel(n, d, D, sigma):
    Z, omega, beta = _rff_inputs(n, d, D, sigma)
    want = np.asarray(rff_pallas(jnp.asarray(Z), jnp.asarray(omega), jnp.asarray(beta),
                                 interpret=True))
    tol = 1e-5 * math.sqrt(2.0 / D)
    got_ref = rff_ref(_t(Z), _t(omega), _t(beta)).numpy()
    got_op = rff_transform(_t(Z), _t(omega), _t(beta)).numpy()
    assert got_ref.dtype == np.float32 and got_ref.shape == (n, D)
    assert float(np.abs(got_ref - want).max()) <= tol
    assert float(np.abs(got_op - want).max()) <= tol


@pytest.mark.parametrize("n,d,D", SHAPES)
def test_rff_map_matches_reference_rff_map(n, d, D):
    jp = jrf.rff_init(jax.random.PRNGKey(n), d, D, sigma=2.0)
    Z = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    params = rff_params_from_jax(jp.omega, jp.beta, jp.sigma, device="cpu")
    got = rff_map(params, _t(Z)).numpy()
    want = np.asarray(jrf.rff_map(jp, jnp.asarray(Z)))
    assert float(np.abs(got - want).max()) <= 1e-5 * math.sqrt(2.0 / D)
    assert float(params.sigma) == 2.0


def test_rff_transform_cpu_path_launches_nothing_and_validates():
    Z, omega, beta = _rff_inputs(9, 4, 11, 1.0)
    before = rff_transform.launches
    assert torch.equal(rff_transform(_t(Z), _t(omega), _t(beta)),
                       rff_ref(_t(Z), _t(omega), _t(beta)))
    assert rff_transform.launches == before
    with pytest.raises(TypeError):
        rff_transform(_t(Z).double(), _t(omega), _t(beta))
    with pytest.raises(ValueError):
        rff_transform(_t(Z), _t(omega)[:-1], _t(beta))
    with pytest.raises(ValueError):
        rff_transform(_t(Z), _t(omega), _t(beta)[:-1])


@pytest.mark.parametrize("sigma", [0.5, 1000.0])
def test_rff_init_properties(sigma):
    d, D = 64, 4096
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    p = rff_init(gen, d, D, sigma)
    assert isinstance(p, RFFParams)
    assert p.omega.shape == (d, D) and p.beta.shape == (D,)
    assert p.omega.dtype == p.beta.dtype == torch.float32
    assert float(p.beta.min()) >= 0.0 and float(p.beta.max()) < 2.0 * math.pi
    # Ω ~ N(0, σ⁻²): 262144 draws pin the spread to well under 1%
    assert float(p.omega.std()) * sigma == pytest.approx(1.0, rel=0.01)
    assert abs(float(p.omega.mean())) * sigma < 0.01
    # β ~ U[0, 2π): mean π, and every quarter of the circle is hit
    assert float(p.beta.mean()) == pytest.approx(math.pi, rel=0.05)
    quarters = torch.bincount((p.beta / (math.pi / 2)).long(), minlength=4)
    assert int(quarters.min()) > D // 5
    gen.manual_seed(3)
    again = rff_init(gen, d, D, sigma)
    assert torch.equal(p.omega, again.omega) and torch.equal(p.beta, again.beta)


def test_rbf_kernel_matches_reference_and_rff_approximates_it():
    r = np.random.default_rng(4)
    z1 = r.normal(size=(12, 8)).astype(np.float32)
    z2 = r.normal(size=(9, 8)).astype(np.float32)
    got = rbf_kernel(_t(z1), _t(z2), 3.0).numpy()
    want = np.asarray(jrf.rbf_kernel(jnp.asarray(z1), jnp.asarray(z2), 3.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    p = rff_init(gen, 8, 20000, 3.0)
    approx = rff_map(p, _t(z1)) @ rff_map(p, _t(z2)).T
    # Monte-Carlo error of D = 20000 features: O(1/√D) ≈ 0.007
    assert float((approx - _t(got)).abs().max()) < 0.05


def _clients(seed, sizes, d, n_classes):
    out = []
    for i, n in enumerate(sizes):
        r = np.random.default_rng(seed + i)
        out.append((r.normal(size=(n, d)).astype(np.float32),
                    r.integers(0, n_classes, size=n).astype(np.int32)))
    return out


@pytest.mark.parametrize("cps", [1, 2, 4])
def test_rf_engine_matches_reference_engine(cps):
    d, D, C = 12, 96, 5
    clients = _clients(7, [9, 4, 13, 6, 11], d, C)
    jp = jrf.rff_init(jax.random.PRNGKey(2), d, D, sigma=3.0)
    jeng = JEngine(JEngineConfig(n_classes=C), rff_params=jp)
    want = jeng.accumulate(jeng.init(D), jpack(clients, cps))
    params = rff_params_from_jax(jp.omega, jp.beta, jp.sigma, device="cpu")
    eng = AccumulationEngine(EngineConfig(n_classes=C), rff_params=params, device="cpu")
    got = eng.accumulate(eng.init(D), pack_client_shards(clients, cps))
    _close(got.stats.A.numpy(), want.stats.A, STATS_REL)
    _close(got.stats.b.numpy(), want.stats.b, STATS_REL)
    assert float(got.stats.n) == float(want.stats.n) == 43
    np.testing.assert_array_equal(got.class_counts.numpy(), np.asarray(want.class_counts))


def test_rf_engine_masks_padding_after_the_map():
    """ψ(0) ≠ 0: padded rows must add nothing to A, b or n."""
    d, D, C = 6, 40, 3
    clients = _clients(11, [3, 10], d, C)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p = rff_init(gen, d, D, 2.0)
    eng = AccumulationEngine(EngineConfig(n_classes=C), rff_params=p, device="cpu")
    got = eng.accumulate(eng.init(D), pack_client_shards(clients, 2, max_n=32))
    feats = torch.cat([_t(x) for x, _ in clients])
    labels = torch.cat([_t(y) for _, y in clients])
    want = fed3r.client_stats(rff_map(p, feats), labels, C)
    _close(got.stats.A.numpy(), want.A.numpy(), STATS_REL)
    _close(got.stats.b.numpy(), want.b.numpy(), STATS_REL)
    assert float(got.stats.n) == 13.0


def test_rf_engine_launches_one_map_per_shard_and_one_stats_per_slot(monkeypatch):
    d, D, C = 5, 16, 3
    clients = _clients(3, [4, 5, 6, 2, 3], d, C)
    calls = {"rff": 0, "stats": 0}
    from repro_torch.core import random_features
    from repro_torch.federated import engine as engine_mod

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(random_features, "rff_transform", count("rff", rff_transform))
    monkeypatch.setattr(engine_mod, "fed3r_stats", count("stats", fed3r_stats))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    eng = AccumulationEngine(EngineConfig(n_classes=C), rff_params=rff_init(gen, d, D, 1.0),
                             device="cpu")
    packed = pack_client_shards(clients, 2)  # 3 shards of 2 slots
    eng.accumulate(eng.init(D), packed)
    assert calls == {"rff": 3, "stats": 6}


@pytest.fixture(scope="module")
def rf_data():
    fed, test = jmake_federated_features(seed=1, n=1500, d=16, n_classes=6, n_clients=20,
                                         alpha=0.0, noise=1.5)
    port_fed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, test, port_fed


def _fc(mod):
    return mod(n_clients=20, clients_per_round=5, n_rounds=20, seed=0)


def test_run_fed3r_rf_matches_reference(rf_data):
    fed, test, pfed = rf_data
    D, sigma = 128, 4.0
    # the reference's own default draw: PRNGKey(seed + 101)
    jp = jrf.rff_init(jax.random.PRNGKey(0 + 101), 16, D, sigma)
    Wr, stats_r, hist_r = jrun_fed3r(
        fed, test.features, test.labels,
        JFed3RConfig(n_classes=6, n_random_features=D, rff_sigma=sigma), _fc(JFederatedConfig),
        eval_every=1)
    W, stats, hist = fed3r_driver.run_fed3r(
        pfed, np.asarray(test.features), np.asarray(test.labels),
        Fed3RConfig(n_classes=6, n_random_features=D, rff_sigma=sigma), _fc(FederatedConfig),
        eval_every=1, rff_params=rff_params_from_jax(jp.omega, jp.beta, jp.sigma, device="cpu"),
        device="cpu")
    assert W.shape == (D, 6) and stats.A.shape == (D, D)
    _close(stats.A.numpy(), stats_r.A, STATS_REL)
    _close(stats.b.numpy(), stats_r.b, STATS_REL)
    assert float(stats.n) == float(stats_r.n)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wr), rtol=0, atol=W_ATOL)
    assert hist.rounds == hist_r.rounds and hist.clients_seen == hist_r.clients_seen
    np.testing.assert_allclose(hist.accuracy, hist_r.accuracy, rtol=0,
                               atol=1.0 / len(test.labels))
    assert hist.accuracy[-1] > 0.5


def test_run_fed3r_rf_default_draw_is_seeded_by_the_config(rf_data):
    _, test, pfed = rf_data
    f3 = Fed3RConfig(n_classes=6, n_random_features=64, rff_sigma=4.0)
    runs = [fed3r_driver.run_fed3r(pfed, np.asarray(test.features), np.asarray(test.labels),
                                   f3, _fc(FederatedConfig), device="cpu") for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0 + 101)  # fed_cfg.seed + 101
    W, _, _ = fed3r_driver.run_fed3r(pfed, np.asarray(test.features), np.asarray(test.labels),
                                     f3, _fc(FederatedConfig), device="cpu",
                                     rff_params=rff_init(gen, 16, 64, 4.0))
    assert torch.equal(W, runs[0][0])


def test_rf_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.core.random_features, repro_torch.kernels.rff
        import repro_torch.kernels.build, repro_torch.federated.fed3r_driver
        m = repro_torch.kernels.rff
        assert m.LIBRARY.lib is None and m.LIBRARY.build_log == ""
        print(m.LIBRARY.path().name)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/nonexistent", "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == rff_mod.LIBRARY.path().name
    assert rff_mod.LIBRARY.source.exists()
