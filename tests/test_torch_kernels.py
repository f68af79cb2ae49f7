"""The port's fed3r_stats against the reference kernel, and on the card.

On the CPU the port's wrapper runs its plain version; the reference's Pallas
kernel runs in interpret mode.  Tolerances are scaled to the largest entry
of each statistic: both sides sum fp32 products in different orders, so the
gap grows with the magnitude of the sums, not with the entry compared.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fed3r_stats as fed3r_stats_mod  # noqa: E402
from repro_torch.kernels.ops import fed3r_stats  # noqa: E402
from repro_torch.kernels.ref import fed3r_stats_ref  # noqa: E402

# fp32 sums of n ≤ 1024 products in two different orders: ≤ ~n·eps relative
# to the largest entry; 1e-5 leaves an order of magnitude of headroom
REL_TOL = 1e-5


def _inputs(n, d, C, seed=0):
    r = np.random.default_rng(seed)
    Z = r.normal(size=(n, d)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[r.integers(0, C, size=n)]
    return Z, Y


def _assert_scaled_close(got, want, rel=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("n,d,C", [(64, 32, 5), (300, 200, 37), (513, 129, 10), (1024, 256, 100)])
def test_fed3r_stats_matches_reference_kernel(n, d, C):
    import jax.numpy as jnp

    from repro.kernels import fed3r_stats as jax_fed3r_stats

    Z, Y = _inputs(n, d, C)
    A, b = fed3r_stats(torch.from_numpy(Z), torch.from_numpy(Y))
    Ar, br = jax_fed3r_stats(jnp.asarray(Z), jnp.asarray(Y))
    assert A.dtype == torch.float32 and b.dtype == torch.float32
    _assert_scaled_close(A.numpy(), Ar)
    _assert_scaled_close(b.numpy(), br)


def test_fed3r_stats_rejects_non_fp32_and_bad_shapes():
    Z, Y = _inputs(16, 8, 3)
    with pytest.raises(TypeError):
        fed3r_stats(torch.from_numpy(Z).to(torch.bfloat16), torch.from_numpy(Y))
    with pytest.raises(ValueError):
        fed3r_stats(torch.from_numpy(Z), torch.from_numpy(Y[:-1]))
    with pytest.raises(ValueError):
        fed3r_stats(torch.from_numpy(Z)[0], torch.from_numpy(Y))


def test_fed3r_stats_cpu_path_is_the_plain_version_and_launches_nothing():
    Z, Y = _inputs(40, 24, 4, seed=1)
    before = fed3r_stats.launches
    A, b = fed3r_stats(torch.from_numpy(Z), torch.from_numpy(Y))
    Ar, br = fed3r_stats_ref(torch.from_numpy(Z), torch.from_numpy(Y))
    assert torch.equal(A, Ar) and torch.equal(b, br)
    assert fed3r_stats.launches == before


def test_kernel_module_imports_without_building():
    """Importing the kernel modules needs no nvcc and no card, and builds
    nothing; the library path is a pure function of the source."""
    code = (
        "import repro_torch.kernels.ops, repro_torch.kernels.fed3r_stats as m;"
        "assert m._lib is None and m.build_log == '';"
        "print(m.library_path().name)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env={"PATH": "/nonexistent", "PYTHONPATH": ":".join(sys.path)},
    )
    assert out.stdout.strip() == fed3r_stats_mod.library_path().name
    assert fed3r_stats_mod.SOURCE.exists()


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,C", [(64, 32, 5), (513, 1281, 37), (88, 1280, 100)])
def test_fed3r_stats_kernel_on_card(cuda_device, n, d, C):
    torch.backends.cuda.matmul.allow_tf32 = False
    Z, Y = _inputs(n, d, C, seed=2)
    Zc, Yc = torch.from_numpy(Z).to(cuda_device), torch.from_numpy(Y).to(cuda_device)
    before = fed3r_stats.launches
    A, b = fed3r_stats(Zc, Yc)
    torch.cuda.synchronize()
    assert fed3r_stats.launches == before + 1
    Ar, br = fed3r_stats_ref(Zc, Yc)
    _assert_scaled_close(A.cpu().numpy(), Ar.cpu().numpy())
    _assert_scaled_close(b.cpu().numpy(), br.cpu().numpy())
    assert torch.equal(A, A.T)  # per-element sample-order sums: exactly symmetric
    A2, b2 = fed3r_stats(Zc, Yc)
    assert torch.equal(A, A2) and torch.equal(b, b2)  # no atomics: bitwise repeatable
