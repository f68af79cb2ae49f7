"""The plain references against the port, on the CPU at small sizes.

The references import nothing of the port; these tests hold them to it: the
random features against ``core/random_features.py::rff_map``, and the
statistics and solve against ``core/fed3r.py``.
"""
import numpy as np
import torch

from perfbench.families import rff as rff_family
from perfbench.reference import rff, ridge


def test_rff_reference_matches_the_port():
    from repro_torch.core.random_features import RFFParams, rff_map

    config = {"d": 48, "n_random_features": 160, "rff_sigma": 8.0, "class_scale": 3.0,
              "noise": 2.0}
    gen = torch.Generator().manual_seed(4)
    params = rff_family.make_params(config, gen)
    x = torch.randn((70, 48), generator=gen) * 2.0
    port = rff_map(RFFParams(params["omega"], params["beta"], torch.tensor(8.0)), x)
    ref = rff.features(config, params, x)
    assert ref.dtype == torch.float64
    assert float((port.double() - ref).abs().max()) < 1e-5 * (2.0 / 160) ** 0.5
    low = rff.features(config, params, x, precision="tf32")
    assert float((low.double() - ref).abs().max()) > 1e-4 * (2.0 / 160) ** 0.5


def test_ridge_statistics_and_solve_match_the_port():
    from repro_torch.core import fed3r

    gen = torch.Generator().manual_seed(5)
    z = torch.randn((90, 12), generator=gen)
    y = torch.randint(0, 6, (90,), generator=gen)
    stats = ridge.new_stats(12, 6, "cpu")
    ridge.fold(stats, z[:40], y[:40])
    ridge.fold(stats, z[40:], y[40:])
    port = fed3r.client_stats(z, y, 6)
    assert ridge.rel_gap(port.A, stats["A"]) < 1e-6 and ridge.rel_gap(port.b, stats["b"]) < 1e-6
    assert stats["n"] == 90
    np.testing.assert_array_equal(stats["counts"].numpy(), np.bincount(y.numpy(), minlength=6))
    W = fed3r.solve(port, 0.01)
    assert ridge.rel_gap(W, ridge.solve(stats["A"], stats["b"], 0.01)) < 1e-4
    assert ridge.solve_residual(port.A, port.b, W, 0.01) < 1e-6
    # a swapped column, a zeroed one, or a column for an empty class is caught
    assert ridge.solve_residual(port.A, port.b, W[:, [1, 0, 2, 3, 4, 5]], 0.01) > 1e-2
    W0 = W.clone()
    W0[:, 2] = 0
    assert ridge.solve_residual(port.A, port.b, W0, 0.01) == float("inf")


def test_precision_roundings():
    t = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, -3.0])
    assert ridge.round_tf32(t).tolist() == [1.0, 1.0, 1.0 + 2.0 ** -10, -3.0]
    x = torch.linspace(-5, 5, 101)
    assert float((ridge.round_bf16(x) - x).abs().max()) < 5 * 2 ** -8
