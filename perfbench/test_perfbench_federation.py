"""The federation generator: the sources' counts, and repeats under a seed."""
import numpy as np
import pytest

from perfbench import federation, harness

TRAFFIC = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", TRAFFIC)
def test_hits_the_sources_counts(name):
    traffic = harness.load_json(harness.HERE / "traffic" / f"{name}.json")
    fed = federation.build(traffic, seed=2**31 + 5)
    assert len(fed.sizes) == traffic["n_clients"]
    assert fed.n_samples == traffic["n_samples"] == len(fed.labels)
    assert fed.sizes.min() >= 1
    assert fed.labels.min() >= 0 and fed.labels.max() < traffic["n_classes"]
    rows = np.concatenate([np.arange(s, e) for r in fed.rounds for s, e in r])
    np.testing.assert_array_equal(rows, np.arange(fed.n_samples))  # every sample once a pass
    per_round = traffic["clients_per_round"]
    assert len(fed.rounds) == -(-traffic["n_clients"] // per_round)
    assert sum(len(r) for r in fed.rounds) == traffic["n_clients"]  # a client is one slot


@pytest.mark.parametrize("name", TRAFFIC)
def test_layout_from_its_seed_labels_from_the_runs(name):
    traffic = harness.load_json(harness.HERE / "traffic" / f"{name}.json")
    a, b, c = (federation.build(traffic, s) for s in (7, 7, 8))
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.sizes, c.sizes)  # every seed runs the same rounds
    for ra, rc in zip(a.rounds, c.rounds):
        np.testing.assert_array_equal(ra, rc)
    assert (a.labels != c.labels).mean() > 0.5


def test_labels_follow_each_clients_mix():
    rng = np.random.default_rng(0)
    sizes = np.full(200, 500)
    labels = federation.client_labels(sizes, 50, 0.1, rng).reshape(200, 500)
    # Dirichlet(0.1) over 50 classes: a client's 500 labels miss many classes
    assert np.median([len(np.unique(row)) for row in labels]) < 30
    flat = federation.client_labels(np.full(20, 5000), 10, 1e3, rng)
    share = np.bincount(flat, minlength=10) / len(flat)
    assert np.abs(share - 0.1).max() < 0.01  # a flat mix draws every class evenly


def test_sizes_sum_exactly():
    for sigma in (0.0, 1.0, 3.0):
        sizes = federation.client_sizes(1000, 13_000, sigma, np.random.default_rng(1))
        assert sizes.sum() == 13_000 and sizes.min() >= 1
    with pytest.raises(ValueError):
        federation.client_sizes(10, 5, 1.0, np.random.default_rng(1))
