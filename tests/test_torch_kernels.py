"""The port's kernels against the reference kernel, and on the card.

``fed3r_stats`` is held against the reference here; ``rff`` and
``chol_gram`` in ``test_torch_rff.py`` and ``test_torch_streaming.py``.  The
tests marked ``gpu`` (all three kernels, and the streaming engine's
sync-free absorb) run on the card; this file imports JAX only inside the
reference comparisons, so they run where JAX is not installed.

On the CPU the port's wrapper runs its plain version; the reference's Pallas
kernel runs in interpret mode.  Tolerances are scaled to the largest entry
of each statistic: both sides sum fp32 products in different orders, so the
gap grows with the magnitude of the sums, not with the entry compared.
"""
import math
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fed3r_stats as fed3r_stats_mod  # noqa: E402
from repro_torch.kernels.ops import chol_gram, fed3r_stats, rff_transform  # noqa: E402
from repro_torch.kernels.ref import chol_gram_ref, fed3r_stats_ref, rff_ref  # noqa: E402

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


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,D", [(37, 100, 130), (5120, 1280, 5000)])
def test_rff_kernel_on_card(cuda_device, n, d, D):
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(3)
    Z = torch.from_numpy((7.0 * r.normal(size=(n, d))).astype(np.float32)).to(cuda_device)
    omega = torch.from_numpy((r.normal(size=(d, D)) / 1000.0).astype(np.float32)).to(cuda_device)
    beta = torch.from_numpy(r.uniform(0, 2 * np.pi, size=D).astype(np.float32)).to(cuda_device)
    before = rff_transform.launches
    out = rff_transform(Z, omega, beta)
    torch.cuda.synchronize()
    assert rff_transform.launches == before + 1
    err = float((out - rff_ref(Z, omega, beta)).abs().max())
    assert err <= 1e-5 * math.sqrt(2.0 / D)  # ψ is bounded by √(2/D)
    assert torch.equal(out, rff_transform(Z, omega, beta))  # no atomics: repeatable


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,C", [(1280, 3000, 100), (130, 77, 7), (64, 0, 5)])
def test_chol_gram_kernel_on_card(cuda_device, d, n, C):
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(4)
    A = r.normal(size=(d, d))
    L = torch.from_numpy(np.linalg.cholesky(A @ A.T / d + np.eye(d)).astype(np.float32))
    Z, Y = _inputs(n, d, C, seed=5)
    L, Zc, Yc = L.to(cuda_device), torch.from_numpy(Z).to(cuda_device), torch.from_numpy(Y).to(cuda_device)
    before = chol_gram.launches
    G, B = chol_gram(L, Zc, Yc)
    torch.cuda.synchronize()
    assert chol_gram.launches == before + 1
    Gr, Br = chol_gram_ref(L, Zc, Yc)
    _assert_scaled_close(G.cpu().numpy(), Gr.cpu().numpy())
    if n:
        _assert_scaled_close(B.cpu().numpy(), Br.cpu().numpy())
    else:
        assert not B.any()  # an empty wave: B exactly 0
    assert torch.equal(G, G.T)  # mirrored tiles: exactly symmetric
    G2, B2 = chol_gram(L, Zc, Yc)
    assert torch.equal(G, G2) and torch.equal(B, B2)  # no atomics: bitwise repeatable


@pytest.mark.gpu
def test_streaming_absorb_makes_no_host_sync_on_card(cuda_device):
    from repro_torch.data.pipeline import pack_arrival_waves
    from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine

    r = np.random.default_rng(6)
    waves = [[(r.normal(size=(int(n), 24)).astype(np.float32),
               r.integers(0, 6, size=int(n)).astype(np.int32)) for n in r.integers(8, 40, size=k)]
             for k in (2, 0, 3, 1)]
    packed = pack_arrival_waves(waves).to(cuda_device)
    eng = StreamingEngine(StreamConfig(n_classes=6, ridge_lambda=1e-2, refresh_every=2),
                          device=cuda_device)
    state, _ = eng.absorb(eng.init(24), packed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = eng.absorb(state, packed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.wave == 8 and bool(torch.isfinite(state.W).all())
