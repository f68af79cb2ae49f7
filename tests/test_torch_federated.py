"""The rest of ``tests/test_federated.py``'s twins: FED3R against FedNCM,
the client sampler, the cost meters (paper App. D/E) and the partitioners,
each run in the port and the reference on the same inputs.

* FED3R beats FedNCM in the port's drivers, as in the reference's, with
  the same final accuracies;
* the copied ``ClientSampler`` covers every client without replacement
  and collects the coupons with replacement in the reference's rounds;
* the copied ``CostModel``'s communication and computation formulas have
  the paper's structure and the reference's values, and FED3R stays orders
  of magnitude cheaper than gradient FL at iNaturalist's scale;
* the copied partitioners draw the reference's clients from the same
  generator: one class a client at Dirichlet α = 0, every class at large
  α, quantity-skewed sizes summing to n.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import Fed3RConfig as JFed3RConfig  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.data import make_federated_features as jmake_federated_features  # noqa: E402
from repro.data.partition import dirichlet_partition as jdirichlet  # noqa: E402
from repro.data.partition import quantity_skew_sizes as jquantity  # noqa: E402
from repro.federated import costs as jcosts  # noqa: E402
from repro.federated import run_fed3r as jrun_fed3r  # noqa: E402
from repro.federated import run_fedncm as jrun_fedncm  # noqa: E402
from repro.federated.sampling import ClientSampler as JClientSampler  # noqa: E402
from repro_torch.configs.base import Fed3RConfig, FederatedConfig  # noqa: E402
from repro_torch.data.partition import dirichlet_partition, quantity_skew_sizes  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset  # noqa: E402
from repro_torch.federated import costs, fed3r_driver  # noqa: E402
from repro_torch.federated.sampling import ClientSampler  # noqa: E402

N_CLIENTS, C, D = 20, 6, 32


@pytest.fixture(scope="module")
def fed_data():
    fed, test = jmake_federated_features(seed=0, n=1500, d=D, n_classes=C, n_clients=N_CLIENTS,
                                         alpha=0.0, noise=1.5)
    port_fed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, test, port_fed


def _fc(mod, **kw):
    base = dict(n_clients=N_CLIENTS, clients_per_round=5, n_rounds=20, local_epochs=1,
                local_batch_size=16, client_lr=0.1, algorithm="fedavg", seed=0)
    base.update(kw)
    return mod(**base)


def test_fed3r_beats_fedncm(fed_data):
    fed, test, pfed = fed_data
    tf, tl = np.asarray(test.features), np.asarray(test.labels)
    _, _, h3 = fed3r_driver.run_fed3r(pfed, tf, tl, Fed3RConfig(n_classes=C), _fc(FederatedConfig),
                                      device="cpu")
    _, hn = fed3r_driver.run_fedncm(pfed, tf, tl, _fc(FederatedConfig), device="cpu")
    assert h3.accuracy[-1] >= hn.accuracy[-1] - 0.02
    _, _, j3 = jrun_fed3r(fed, test.features, test.labels, JFed3RConfig(n_classes=C),
                          _fc(JFederatedConfig))
    _, jn = jrun_fedncm(fed, test.features, test.labels, _fc(JFederatedConfig))
    assert h3.accuracy[-1] == pytest.approx(j3.accuracy[-1], abs=1.0 / len(tl))
    assert hn.accuracy[-1] == pytest.approx(jn.accuracy[-1], abs=1.0 / len(tl))


def test_sampler_without_replacement_covers_all():
    s, js = ClientSampler(17, 5, replacement=False, seed=0), \
        JClientSampler(17, 5, replacement=False, seed=0)
    assert s.rounds_to_full_coverage() == js.rounds_to_full_coverage()
    seen = set()
    for _ in range(s.rounds_to_full_coverage()):
        drawn = s.sample()
        assert np.array_equal(drawn, js.sample())
        seen.update(int(c) for c in drawn)
    assert len(seen) == 17


def test_sampler_with_replacement_coupon_collector():
    rounds = []
    for s in (ClientSampler(50, 10, replacement=True, seed=0),
              JClientSampler(50, 10, replacement=True, seed=0)):
        n = 0
        while s.coverage < 1.0 and n < 500:
            s.sample()
            n += 1
        rounds.append(n)
    assert rounds[0] == rounds[1] > 50 / 10  # strictly more rounds than ⌈K/κ⌉


def test_cost_formulas_match_paper_structure():
    cm, jcm = costs.CostModel(b=2.22e6, d=1280, C=2028), jcosts.CostModel(b=2.22e6, d=1280, C=2028)
    assert cm.comm_per_client("fedavg")["up"] == cm.b + cm.d * cm.C
    assert cm.comm_per_client("scaffold")["up"] == 2 * (cm.b + cm.d * cm.C)
    assert cm.comm_per_client("fedavg-lp")["up"] == cm.d * cm.C
    assert cm.comm_per_client("fed3r")["up"] == cm.d**2 + cm.d * cm.C
    assert cm.comm_per_client("fed3r")["down"] == 0.0
    # computation: FedAvg = 3·E·n_k·F_M (App. E)
    assert cm.comp_per_client("fedavg", 100) == 3 * cm.E * 100 * cm.F_M
    assert cm.comp_per_client("fed3r", 100) == \
        100 * (cm.F_phi + 0.5 * cm.d * (cm.d + 1) + cm.d * cm.C)
    for alg in ("fedavg", "scaffold", "fedavg-lp", "fed3r"):
        assert cm.comm_per_client(alg) == jcm.comm_per_client(alg)
        assert cm.comp_per_client(alg, 100) == jcm.comp_per_client(alg, 100)


def test_fed3r_two_orders_of_magnitude_cheaper():
    """§5.2: at paper scale, FED3R total compute ≪ gradient FL compute."""
    ratios = []
    for cm in (costs.INATURALIST, jcosts.INATURALIST):
        # gradient FL: 5000 rounds (the paper's iNaturalist budget)
        grad = cm.comp_per_client("fedavg", 13.0) * 5000 * 10 / 9275
        ratios.append(grad / cm.comp_per_client("fed3r", 13.0))  # each client works once
    assert ratios[0] == ratios[1] > 25


def test_dirichlet_alpha0_single_class_per_client():
    labels = np.repeat(np.arange(10), 100)
    parts = dirichlet_partition(np.random.default_rng(0), labels, 20, alpha=0.0)
    want = jdirichlet(np.random.default_rng(0), labels, 20, alpha=0.0)
    assert len(parts) == len(want)
    for p, w in zip(parts, want):
        assert np.array_equal(p, w)
        assert len(np.unique(labels[p])) == 1
    assert sum(len(p) for p in parts) == len(labels)


def test_dirichlet_alpha_large_is_roughly_uniform():
    labels = np.repeat(np.arange(5), 200)
    parts = dirichlet_partition(np.random.default_rng(0), labels, 10, alpha=1000.0)
    want = jdirichlet(np.random.default_rng(0), labels, 10, alpha=1000.0)
    for p, w in zip(parts, want, strict=True):
        assert np.array_equal(p, w)
        assert np.bincount(labels[p], minlength=5).min() > 0  # every class present


def test_quantity_skew_sizes_sum():
    sizes = quantity_skew_sizes(np.random.default_rng(0), 1000, 30, sigma=1.5)
    assert np.array_equal(sizes, jquantity(np.random.default_rng(0), 1000, 30, sigma=1.5))
    assert sizes.sum() == 1000
    assert sizes.min() >= 1
