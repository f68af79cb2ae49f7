"""The port's kernels against the reference kernel, and on the card.

``fed3r_stats`` is held against the reference here; ``rff``, ``chol_gram``,
``batched_chol_gram`` and the quantization pair in ``test_torch_rff.py``,
``test_torch_streaming.py``, ``test_torch_personalization.py`` and
``test_torch_compress.py``, ``flash_attention`` in ``test_torch_flash.py``.
The tests marked ``gpu`` (all seven kernels, the int8 engine's launches,
the streaming engine's sync-free absorb, the smoke-width fp32 serving
path against the CPU, the FL round engine's sync-free step and the
full-width fine-tuning round's peak memory) run on the card; this file imports JAX only inside
the reference comparisons, so they run where JAX is not installed.

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

from repro_torch.kernels import chol_update as chol_update_mod  # noqa: E402
from repro_torch.kernels import fed3r_stats as fed3r_stats_mod  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import quant as quant_mod  # noqa: E402
from repro_torch.kernels import rff as rff_mod  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    batched_chol_gram,
    chol_gram,
    dequant_accumulate,
    fed3r_stats,
    quantize_tiles,
    rff_transform,
)
from repro_torch.kernels.ref import (  # noqa: E402
    batched_chol_gram_ref,
    chol_gram_ref,
    dequant_acc_ref,
    fed3r_stats_ref,
    quantize_tiles_ref,
    rff_ref,
)

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


@pytest.mark.parametrize("M,N", [(1280, 1280), (1280, 100)])
def test_broadcast_addcmul_is_dequant_acc_bitwise(M, N):
    """The yardstick chip_smoke.py times beside dequant_acc: one
    torch.addcmul on the kernel's own int8 q and tile scales through
    broadcast views computes the same function, bitwise."""
    from repro_torch.launch.timing import broadcast_addcmul

    r = np.random.default_rng(11)
    x = torch.from_numpy((10.0 * r.normal(size=(M, N))).astype(np.float32))
    acc = torch.from_numpy(r.normal(size=(M, N)).astype(np.float32))
    q, s = quantize_tiles_ref(x, 128)
    lib = broadcast_addcmul(acc, q, s, 128)
    assert torch.equal(lib().reshape(M, N), dequant_acc_ref(acc, q, s, 128))


def test_broadcast_addcmul_refuses_shapes_the_tile_does_not_divide():
    from repro_torch.launch.timing import broadcast_addcmul

    acc = torch.zeros((5000, 5000))
    q = torch.zeros((5000, 5000), dtype=torch.int8)
    assert broadcast_addcmul(acc, q, torch.ones((40, 40)), 128) is None


def test_require_hopper_cache_refuses_another_card_per_device_index(monkeypatch):
    from types import SimpleNamespace

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "_HOPPER_SMS", {})
    caps = {5: (9, 0), 6: (8, 0)}
    asked = []

    def capability(index):
        asked.append(index)
        return caps[index]

    monkeypatch.setattr(torch.cuda, "get_device_capability", capability)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index: f"card {index}")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: SimpleNamespace(multi_processor_count=132))
    assert build.require_hopper(torch.device("cuda", 5), "k") == 132
    assert build.require_hopper(torch.device("cuda", 5), "k") == 132
    assert asked == [5]  # a card that passed is not asked again
    for _ in range(2):  # one reported as (8, 0) is refused at every launch
        with pytest.raises(RuntimeError, match=r"sm_90a.*card 6.*\(8, 0\)"):
            build.require_hopper(torch.device("cuda", 6), "k")
    assert asked == [5, 6, 6] and set(build._HOPPER_SMS) == {5}
    caps[5] = (8, 0)  # the cache is per device index: index 5 stays admitted
    assert build.require_hopper(torch.device("cuda", 5), "k") == 132


@pytest.mark.parametrize("private", [True, False])
@pytest.mark.parametrize("index,current", [(0, 0), (3, 0)])
def test_launch_passes_the_current_stream_handle_with_or_without_the_private_getter(
        monkeypatch, private, index, current):
    """build.launch hands the C function the raw handle of the card's
    current stream: through torch's private getter where torch has it, else
    through the public current_stream, so a torch that renames the private
    one still launches.  The device guard is entered only off the current
    device."""
    from contextlib import contextmanager
    from types import SimpleNamespace

    from repro_torch.kernels import build

    if private:
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                            raising=False)
    else:
        monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream", raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda i: SimpleNamespace(cuda_stream=2000 + i))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    guarded = []

    @contextmanager
    def guard(i):
        guarded.append(i)
        yield

    monkeypatch.setattr(torch.cuda, "device", guard)
    calls = []
    err = build.launch(torch.device("cuda", index),
                       lambda *args: calls.append(args) or 7, 1, 2)
    assert err == 7
    assert calls == [(1, 2, (1000 if private else 2000) + index)]
    assert guarded == ([] if index == current else [index])


@pytest.mark.parametrize("library", [lib.name for lib in _ops.LIBRARIES])
def test_c_launch_functions_take_the_arguments_their_bindings_pass(library):
    """Each ctypes binding has as many arguments as its C function in the
    source: a launch function that gains an argument (dequant_acc_launch's
    SM count, fed3r_stats_launch's tile) cannot be called with the old
    list, which only a card would otherwise show."""
    import re

    lib = next(lib for lib in _ops.LIBRARIES if lib.name == library)
    text = lib.source.read_text()
    for fn, (argtypes, _) in lib.functions.items():
        decl = re.search(r"\b" + fn + r"\(([^)]*)\)\s*\{", text)
        assert decl is not None, fn
        params = [p for p in decl.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), (fn, params)


@pytest.mark.parametrize("d,C,sms,tile", [(1280, 100, 132, 64), (5000, 100, 132, 128),
                                          (2560, 100, 132, 64), (4096, 100, 132, 128),
                                          (37, 1, 132, 64), (1280, 100, 16, 128)])
def test_fed3r_stats_picks_the_128_instance_only_where_it_fills_the_card(d, C, sms, tile):
    assert fed3r_stats_mod.pick_tile(d, C, sms) == tile


def test_fed3r_stats_launch_refuses_a_tile_it_has_no_instance_for():
    Z, Y = _inputs(8, 4, 2)
    with pytest.raises(ValueError, match="tile"):
        fed3r_stats_mod._launch(torch.from_numpy(Z), torch.from_numpy(Y), tile=32)


# (d, C, heads, tile): the stream wave at d 1280 (65 blocks of 128 for 132
# SMs), stream-rf at d 5000, a narrow d, the refit's L Lᵀ sweep (no B
# tiles) and its 32 heads
@pytest.mark.parametrize("d,C,heads,tile", [(1280, 100, 1, 64), (5000, 100, 1, 128),
                                            (64, 100, 1, 64), (1280, 0, 1, 64),
                                            (1280, 100, 32, 128)])
def test_chol_gram_picks_the_128_instance_only_where_it_fills_the_card(d, C, heads, tile):
    assert chol_update_mod.pick_tile(d, C, 132, heads) == tile


def test_chol_gram_launches_refuse_a_tile_they_have_no_instance_for():
    L = torch.eye(8)
    Z, Y = (torch.from_numpy(a) for a in _inputs(4, 8, 3))
    with pytest.raises(ValueError, match="tile"):
        chol_update_mod._launch(L, Z, Y, tile=32)
    with pytest.raises(ValueError, match="tile"):
        chol_update_mod._launch_batched(L, Z[None], Y[None], tile=96)


# (n, D, sms, tile): the rf shard (1600 blocks of 128 for 132 SMs), the
# stream wave (360), a narrow ψ, one sample, the stream wave on a card of
# many SMs, a small ψ on a card of two
@pytest.mark.parametrize("n,D,sms,tile", [(5120, 5000, 132, 128), (1088, 5000, 132, 128),
                                          (37, 130, 132, 64), (1, 4999, 132, 64),
                                          (1088, 5000, 400, 64), (256, 256, 2, 128)])
def test_rff_picks_the_128_instance_only_where_it_fills_the_card(n, D, sms, tile):
    assert rff_mod.pick_tile(n, D, sms) == tile


def test_rff_launch_refuses_a_tile_it_has_no_instance_for():
    Z, omega, beta = torch.zeros((4, 8)), torch.zeros((8, 5)), torch.zeros(5)
    with pytest.raises(ValueError, match="tile"):
        rff_mod._launch(Z, omega, beta, tile=32)


# (tiles, tile, sms, cluster): the wire's A (1280², 100 tiles) and b
# (1280 × 100, 10 tiles), the rf width (5000², 1600 tiles: two blocks a
# tile so a slab fits what a block holds), many small tiles, tile 1 and 2 (no
# more blocks than rows), the wire's A on a card of 16 SMs, a tile wider
# than eight blocks hold
@pytest.mark.parametrize("tiles,tile,sms,cluster", [(100, 128, 132, 8), (10, 128, 132, 8),
                                                    (1600, 128, 132, 2), (6400, 16, 132, 1),
                                                    (1, 1, 132, 1), (4, 2, 132, 2),
                                                    (100, 128, 16, 2), (16, 512, 132, 8)])
def test_quantize_tiles_picks_the_smallest_cluster_that_fills_the_card(tiles, tile, sms, cluster):
    assert quant_mod.pick_cluster(tiles, tile, sms) == cluster


@pytest.mark.parametrize("cluster", [3, 16, -1])
def test_quantize_tiles_launch_refuses_a_cluster_it_has_no_instance_for(cluster):
    with pytest.raises(ValueError, match="cluster"):
        quant_mod._quantize(torch.zeros((8, 8)), 4, cluster=cluster)


def test_time_kernels_gram_cases_are_the_paths_inputs():
    """The inputs the Gram kernels are timed and digested on: the stream's
    widest wave with its padding rows, the same rows dense, that wave
    through a random-features map (−0.0 in its masked rows), an empty
    wave, a cohort padded to max_n; and the stacked-operand yardstick
    computes the plain versions' function on each."""
    from repro_torch.launch import time_kernels
    from repro_torch.launch.timing import stacked_gram

    gen = torch.Generator()
    gen.manual_seed(0)
    cases = time_kernels.gram_cases(gen, rf_d=64, heads_k=4)
    _, Z, _ = cases["stream wave"]
    live = Z.ne(0).any(dim=1)
    assert 0 < int(live.sum()) < Z.shape[0]
    _, Zd, _ = cases["dense wave"]
    assert bool(Zd.ne(0).any(dim=1).all()) and torch.equal(Zd[live], Z[live])
    _, Zr, _ = cases["stream-rf wave"]
    assert Zr.shape == (Z.shape[0], 64) and torch.equal(Zr.ne(0).any(dim=1), live)
    assert torch.signbit(Zr[~live]).any()
    assert cases["empty wave"][1].shape[0] == 0
    _, Zc, _ = cases["cohort K=4"]
    assert Zc.dim() == 3 and Zc.shape[0] == 4 and not bool(Zc.ne(0).any(dim=2).all())
    for label, (L, Z, Y) in cases.items():
        plain = batched_chol_gram_ref if Z.dim() == 3 else chol_gram_ref
        G, B = plain(L, Z, Y)
        R = stacked_gram(L, Z, Y)()
        d = L.shape[0]
        _assert_scaled_close(R[..., :d].numpy(), G.numpy())
        _assert_scaled_close(R[..., d:].numpy(), B.numpy())


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


def _masked_runs(Z, Y, seed):
    """Z and Y with rows masked to zero in runs, as a padded wave or cohort:
    a negative feature times a mask of 0 leaves −0.0."""
    r = np.random.default_rng(seed)
    m = np.ones(Z.shape[0], np.float32)
    k = 0
    while k < len(m):
        live, dead = int(r.integers(1, 24)), int(r.integers(0, 48))
        m[k + live:k + live + dead] = 0.0
        k += live + dead
    return Z * m[:, None], Y * m[:, None]


def _compacted(Z, Y):
    """The live rows of a masked (n, d) Z and (n, C) Y, in order."""
    live = Z.ne(0).any(dim=1) | Y.ne(0).any(dim=1)
    return Z[live].contiguous(), Y[live].contiguous()


def _factor(d, seed, device):
    r = np.random.default_rng(seed)
    A = r.normal(size=(d, d))
    return torch.from_numpy(np.linalg.cholesky(A @ A.T / d + np.eye(d)).astype(np.float32)).to(
        device)


# the heads path's cohort: 32 tenants padded to the dataset's max_n of 136
HEADS_COHORT = (32, 1280, 136, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("K,d,n,C", [(8, 1280, 136, 100), (3, 130, 77, 7), (2, 64, 0, 5),
                                     HEADS_COHORT])
def test_batched_chol_gram_kernel_on_card(cuda_device, K, d, n, C):
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(7)
    A = r.normal(size=(d, d))
    L = torch.from_numpy(np.linalg.cholesky(A @ A.T / d + np.eye(d)).astype(np.float32))
    Z = np.stack([_inputs(n, d, C, seed=8 + k)[0] for k in range(K)])
    Y = np.stack([_inputs(n, d, C, seed=8 + k)[1] for k in range(K)])
    if (K, d, n, C) == HEADS_COHORT:  # padded as a refit's cohort is
        Z, Y = zip(*(_masked_runs(Z[k], Y[k], seed=9 + k) for k in range(K)))
        Z, Y = np.stack(Z), np.stack(Y)
    L, Zc, Yc = L.to(cuda_device), torch.from_numpy(Z).to(cuda_device), torch.from_numpy(Y).to(cuda_device)
    before, single = batched_chol_gram.launches, chol_gram.launches
    G, B = batched_chol_gram(L, Zc, Yc)
    torch.cuda.synchronize()
    assert batched_chol_gram.launches == before + 1 and chol_gram.launches == single
    Gr, Br = batched_chol_gram_ref(L, Zc, Yc)
    _assert_scaled_close(G.cpu().numpy(), Gr.cpu().numpy())
    if n:
        _assert_scaled_close(B.cpu().numpy(), Br.cpu().numpy())
    else:
        assert not B.any()  # no sample rows: B exactly 0
    assert torch.equal(G, G.transpose(1, 2))  # mirrored tiles: exactly symmetric
    for k in range(K):  # one tile loop: each head is the single update, bitwise
        Gk, Bk = chol_gram(L, Zc[k], Yc[k])
        assert torch.equal(G[k], Gk) and torch.equal(B[k], Bk)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("d,n,C", [(1280, 1088, 100), (130, 300, 7), (63, 77, 1)])
def test_chol_gram_padding_rows_change_no_bit_on_card(cuda_device, d, n, C, tile):
    """Zero rows interleaved in runs (−0.0 included) give G and B bitwise
    equal to the same live rows compacted: skipped all-zero panels and
    multiplied zero rows both leave every fmaf chain as it was."""
    Z, Y = _masked_runs(*_inputs(n, d, C, seed=15), seed=16)
    assert np.signbit(Z[~Z.any(axis=1)]).any()
    L = _factor(d, 17, cuda_device)
    Zc, Yc = torch.from_numpy(Z).to(cuda_device), torch.from_numpy(Y).to(cuda_device)
    G, B = chol_update_mod._launch(L, Zc, Yc, tile=tile)
    Gc, Bc = chol_update_mod._launch(L, *_compacted(Zc, Yc), tile=tile)
    assert torch.equal(G, Gc) and torch.equal(B, Bc)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("K,d,n,C", [HEADS_COHORT, (3, 130, 150, 7)])
def test_batched_chol_gram_padding_rows_change_no_bit_on_card(cuda_device, K, d, n, C, tile):
    """Each head's masked rows (−0.0 included) against its live rows moved
    to the front, the cohort cut to the widest head's live rows."""
    Z, Y = zip(*(_masked_runs(*_inputs(n, d, C, seed=18 + k), seed=40 + k) for k in range(K)))
    Zc = torch.from_numpy(np.stack(Z)).to(cuda_device)
    Yc = torch.from_numpy(np.stack(Y)).to(cuda_device)
    L = _factor(d, 19, cuda_device)
    live = [_compacted(Zc[k], Yc[k]) for k in range(K)]
    w = max(z.shape[0] for z, _ in live)
    Zp, Yp = Zc.new_zeros((K, w, d)), Yc.new_zeros((K, w, C))
    for k, (z, y) in enumerate(live):
        Zp[k, :z.shape[0]], Yp[k, :y.shape[0]] = z, y
    G, B = chol_update_mod._launch_batched(L, Zc, Yc, tile=tile)
    Gp, Bp = chol_update_mod._launch_batched(L, Zp, Yp, tile=tile)
    assert w < n and torch.equal(G, Gp) and torch.equal(B, Bp)


# the edges of both Gram instances: d below, at and across a tile, d % 4 != 0
# (the 4-byte copies), the path's width; an empty wave, one row, n not a
# multiple of the 16-row panel; C = 1, C % 4 != 0, the path's classes
GRAM_EDGES = [(d, n, C) for d in (1, 63, 130, 1280) for n in (0, 1, 77) for C in (1, 7, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,C", GRAM_EDGES)
def test_chol_gram_instances_agree_bitwise_on_card(cuda_device, d, n, C):
    Z, Y = _inputs(n, d, C, seed=20)
    Zc, Yc = torch.from_numpy(Z).to(cuda_device), torch.from_numpy(Y).to(cuda_device)
    L = _factor(d, 21, cuda_device)
    G, B = chol_update_mod._launch(L, Zc, Yc, tile=64)
    G2, B2 = chol_update_mod._launch(L, Zc, Yc, tile=128)
    assert torch.equal(G, G2) and torch.equal(B, B2) and torch.equal(G, G.T)
    if n == 0:
        assert not B.any()
    Gb, Bb = chol_update_mod._launch_batched(L, Zc[None], Yc[None], tile=128)
    Gb2, Bb2 = chol_update_mod._launch_batched(L, Zc[None], Yc[None], tile=64)
    assert torch.equal(Gb[0], G) and torch.equal(Bb[0], B)
    assert torch.equal(Gb2[0], G) and torch.equal(Bb2[0], B)


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


@pytest.mark.gpu
def test_current_stream_handle_on_card_is_the_current_stream(cuda_device):
    """On this torch the launches take the private raw-stream getter (the
    cheap path), and it names the same stream as the public API, on the
    default stream and on a side one."""
    from repro_torch.kernels import build

    index = torch.cuda.current_device()
    assert hasattr(torch._C, "_cuda_getCurrentRawStream")
    assert build.current_stream_handle(index) == torch.cuda.current_stream(index).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert build.current_stream_handle(index) == side.cuda_stream


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,tile", [(1280, 1280, 128), (1280, 100, 128), (200, 150, 64),
                                      (33, 190, 128), (1281, 77, 16)])
def test_quant_kernels_on_card_equal_their_plain_versions_bitwise(cuda_device, M, N, tile):
    r = np.random.default_rng(9)
    x = (10.0 * r.normal(size=(M, N))).astype(np.float32)
    x[:tile, :tile] = 0.0  # an all-zero tile: scale 1, payload 0
    xc = torch.from_numpy(x).to(cuda_device)
    acc = torch.from_numpy(r.normal(size=(M, N)).astype(np.float32)).to(cuda_device)
    before = (quantize_tiles.launches, dequant_accumulate.launches)
    q, s = quantize_tiles(xc, tile=tile)
    out = dequant_accumulate(acc, q, s, tile=tile)
    torch.cuda.synchronize()
    assert (quantize_tiles.launches, dequant_accumulate.launches) == (before[0] + 1, before[1] + 1)
    qr, sr = quantize_tiles_ref(xc, tile)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert float(s[0, 0]) == 1.0 and not q[:tile, :tile].any()
    assert torch.equal(out, dequant_acc_ref(acc, q, s, tile))  # one FMA on both sides


# the edges of both rff instances: one sample, d % 4 != 0 (Z's 4-byte
# copies), D % 4 != 0 (Omega's 4-byte copies and psi's scalar stores),
# d < 16 (one masked panel), n and D not multiples of 128, and the paths'
# shapes (the stream wave, the rf shard)
RFF_EDGES = [(1, 37, 130), (37, 130, 130), (130, 37, 4999), (5, 7, 64), (129, 100, 130),
             (300, 12, 4999), (1088, 1280, 5000), (5120, 1280, 5000)]


def _rff_inputs(n, d, D, device, seed=15):
    r = np.random.default_rng(seed)
    Z = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32)).to(device)
    omega = torch.from_numpy((r.normal(size=(d, D)) / np.sqrt(d)).astype(np.float32)).to(device)
    beta = torch.from_numpy(r.uniform(0, 2 * np.pi, size=D).astype(np.float32)).to(device)
    return Z, omega, beta


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,D", RFF_EDGES)
def test_rff_instances_agree_bitwise_on_card(cuda_device, n, d, D):
    torch.backends.cuda.matmul.allow_tf32 = False
    Z, omega, beta = _rff_inputs(n, d, D, cuda_device)
    psi = {tile: rff_mod._launch(Z, omega, beta, tile=tile) for tile in (64, 128)}
    torch.cuda.synchronize()
    err = float((psi[128] - rff_ref(Z, omega, beta)).abs().max())
    assert err <= 1e-5 * math.sqrt(2.0 / D)
    # one fmaf chain an element, in k order, whichever thread runs it
    assert torch.equal(psi[64], psi[128])
    assert torch.equal(psi[128], rff_mod._launch(Z, omega, beta, tile=128))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,D", [(37, 130, 130), (300, 128, 4999), (1088, 1280, 5000)])
def test_rff_on_card_takes_inputs_not_aligned_to_16_bytes(cuda_device, n, d, D):
    """Z and Omega 4 bytes past a 16-byte boundary take the 4-byte copies
    and give the same bits as aligned copies of them."""
    Z, omega, beta = _rff_inputs(n, d, D, cuda_device)
    want = rff_transform(Z, omega, beta)

    def shifted(t):
        flat = torch.zeros(t.numel() + 1, device=cuda_device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    Zs, omegas = shifted(Z), shifted(omega)
    assert Zs.data_ptr() % 16 == 4 and omegas.data_ptr() % 16 == 4
    assert torch.equal(rff_transform(Zs, omega, beta), want)
    assert torch.equal(rff_transform(Z, omegas, beta), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1088, 5120])
def test_rff_rows_do_not_depend_on_their_place_on_card(cuda_device, n):
    """ψ(Z[perm]) == ψ(Z)[perm] and ψ(Z[:k]) == ψ(Z)[:k] bitwise, at the
    stream wave's and the rf shard's n."""
    Z, omega, beta = _rff_inputs(n, 1280, 5000, cuda_device, seed=16)
    psi = rff_transform(Z, omega, beta)
    perm = torch.from_numpy(np.random.default_rng(17).permutation(n)).to(cuda_device)
    assert torch.equal(rff_transform(Z[perm].contiguous(), omega, beta), psi[perm])
    for k in (1, 77, n // 2 + 3):
        assert torch.equal(rff_transform(Z[:k].contiguous(), omega, beta), psi[:k])


# quantize_tiles' edges, each at every cluster size and with x aligned or 4
# bytes past a 16-byte boundary: tile 1 (single elements), 16 (runs of 16),
# 64 with N % 16 != 0 (runs of 4), the wire's two shapes, tile 200 (runs of
# 4, ragged both ways), N % 4 != 0 and a ragged last tile (single
# elements); the first and the last tile all zero
QUANT_EDGES = [(7, 5, 1), (100, 96, 16), (130, 100, 64), (1280, 1280, 128), (1280, 100, 128),
               (450, 600, 200), (33, 190, 128), (129, 77, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_offset", [0, 1])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("M,N,tile", QUANT_EDGES)
def test_quantize_tiles_edges_on_card_bitwise(cuda_device, M, N, tile, cluster, x_offset):
    r = np.random.default_rng(18)
    x0 = (10.0 * r.normal(size=(M, N))).astype(np.float32)
    x0[:tile, :tile] = 0.0
    x0[(-(-M // tile) - 1) * tile:, (-(-N // tile) - 1) * tile:] = 0.0
    flat = torch.zeros(M * N + x_offset, device=cuda_device)
    flat[x_offset:] = torch.from_numpy(x0).reshape(-1).to(cuda_device)
    x = flat[x_offset:].view(M, N)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * x_offset
    before = quantize_tiles.launches
    q, s = quant_mod._quantize(x, tile, cluster=cluster)
    torch.cuda.synchronize()
    assert quantize_tiles.launches == before + 1
    qr, sr = quantize_tiles_ref(x, tile)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert float(s[0, 0]) == 1.0 and float(s[-1, -1]) == 1.0


def _half_way(tiles_down, tiles_across, tile, seed):
    """x whose every entry but one a tile sits exactly half-way between two
    integers of its tile's quantization grid (x / s = k + 1/2 exactly)."""
    r = np.random.default_rng(seed)
    inv = np.float32(1.0 / 127.0)
    x = np.empty((tiles_down * tile, tiles_across * tile), np.float32)
    for i in range(tiles_down):
        for j in range(tiles_across):
            while True:  # an absmax whose scale has <= 15 significant bits
                a = np.float32(r.uniform(1.0, 100.0))
                s = np.float32(a * inv)
                if int(s.view(np.uint32)) & 0x1FF == 0:
                    break
            k = r.integers(-127, 127, size=(tile, tile))
            blk = ((k + 0.5) * np.float64(s)).astype(np.float32)
            blk[0, 0] = a
            x[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = blk
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
def test_quantize_tiles_on_card_near_half_way_inputs_bitwise(cuda_device, ulps):
    """Exact ties and inputs 1 or 2 ulps off them: where the kernel's
    product by fl(1/s) cannot decide the rounding and the division must."""
    x = torch.from_numpy(_half_way(2, 3, 128, seed=19))
    toward = torch.full_like(x, math.copysign(math.inf, ulps))
    for _ in range(abs(ulps)):
        x = torch.nextafter(x, toward)
    xc = x.to(cuda_device)
    q, s = quantize_tiles(xc)
    qr, sr = quantize_tiles_ref(xc, 128)
    assert torch.equal(q, qr) and torch.equal(s, sr)


# the edges of both fed3r_stats instances: d < 64, d not a multiple of 128,
# d % 4 != 0 (the 4-byte copies), n = 1, n not a multiple of the 16-sample
# panel, C = 1, d + C crossing a tile, and the shapes of the three paths
STATS_EDGES = [(1, 37, 1), (37, 37, 5), (17, 200, 1), (100, 120, 20), (513, 1281, 37),
               (104, 1280, 100), (33, 130, 130), (512, 5000, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n,d,C", STATS_EDGES)
def test_fed3r_stats_both_instances_on_card(cuda_device, n, d, C, tile):
    torch.backends.cuda.matmul.allow_tf32 = False
    Z, Y = _inputs(n, d, C, seed=12)
    Zc, Yc = torch.from_numpy(Z).to(cuda_device), torch.from_numpy(Y).to(cuda_device)
    A, b = fed3r_stats_mod._launch(Zc, Yc, tile=tile)
    torch.cuda.synchronize()
    Ar, br = fed3r_stats_ref(Zc, Yc)
    _assert_scaled_close(A.cpu().numpy(), Ar.cpu().numpy())
    _assert_scaled_close(b.cpu().numpy(), br.cpu().numpy())
    assert torch.equal(A, A.T)
    A2, b2 = fed3r_stats_mod._launch(Zc, Yc, tile=tile)
    assert torch.equal(A, A2) and torch.equal(b, b2)
    # both instances run the same fmaf chain an element: the same bits
    A3, b3 = fed3r_stats_mod._launch(Zc, Yc, tile=192 - tile)
    assert torch.equal(A, A3) and torch.equal(b, b3)


@pytest.mark.gpu
def test_fed3r_stats_on_card_takes_inputs_not_aligned_to_16_bytes(cuda_device):
    n, d, C = 40, 256, 12
    Z, Y = _inputs(n, d, C, seed=13)
    flat = torch.zeros(n * d + 1, device=cuda_device)
    flat[1:] = torch.from_numpy(Z).reshape(-1).to(cuda_device)
    Zc = flat[1:].view(n, d)  # contiguous, 4 bytes past a 16-byte boundary
    assert Zc.is_contiguous() and Zc.data_ptr() % 16 == 4
    Yc = torch.from_numpy(Y).to(cuda_device)
    A, b = fed3r_stats(Zc, Yc)
    torch.cuda.synchronize()
    Ar, br = fed3r_stats_ref(Zc, Yc)
    _assert_scaled_close(A.cpu().numpy(), Ar.cpu().numpy())
    _assert_scaled_close(b.cpu().numpy(), br.cpu().numpy())
    assert torch.equal(A, A.T)


# dequant_acc's paths: runs of 16 (N % 16 == 0), of 4 (N % 4 == 0), single
# elements (N % 4 != 0); a tile that is not a multiple of the run (each
# element its own scale); q 4 bytes (runs of 4) and 1 byte (single
# elements) past a 16-byte boundary
DEQUANT_PATHS = [(1280, 1280, 128, 0), (1280, 100, 128, 0), (129, 77, 16, 0),
                 (256, 1280, 8, 0), (96, 96, 6, 0), (50, 100, 6, 0), (64, 100, 128, 100),
                 (64, 1280, 128, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,tile,q_offset", DEQUANT_PATHS)
def test_dequant_acc_paths_on_card_bitwise(cuda_device, M, N, tile, q_offset):
    r = np.random.default_rng(14)
    x = torch.from_numpy((10.0 * r.normal(size=(M, N))).astype(np.float32)).to(cuda_device)
    acc = torch.from_numpy(r.normal(size=(M, N)).astype(np.float32)).to(cuda_device)
    q0, s = quantize_tiles_ref(x, tile)
    flat = torch.zeros(M * N + q_offset, dtype=torch.int8, device=cuda_device)
    flat[q_offset:] = q0.reshape(-1)
    q = flat[q_offset:].view(M, N)  # q[1:] of a (M + 1, N) payload when q_offset == N
    assert q.is_contiguous() and q.data_ptr() % 16 == q_offset % 16
    before = dequant_accumulate.launches
    out = dequant_accumulate(acc, q, s, tile=tile)
    torch.cuda.synchronize()
    assert dequant_accumulate.launches == before + 1
    assert torch.equal(out, dequant_acc_ref(acc, q, s, tile))


@pytest.mark.gpu
def test_int8_engine_launches_two_quant_pairs_per_client_on_card(cuda_device):
    from repro_torch.data.pipeline import pack_client_shards
    from repro_torch.federated.compress import WireFormat
    from repro_torch.federated.engine import AccumulationEngine, EngineConfig

    r = np.random.default_rng(10)
    clients = [(r.normal(size=(int(n), 64)).astype(np.float32),
                r.integers(0, 5, size=int(n)).astype(np.int32)) for n in r.integers(8, 30, size=6)]
    packed = pack_client_shards(clients, 3)
    eng = AccumulationEngine(EngineConfig(n_classes=5, wire=WireFormat(kind="int8", tile=32)),
                             device=cuda_device)
    before = (fed3r_stats.launches, quantize_tiles.launches, dequant_accumulate.launches)
    acc = eng.accumulate(eng.init(64), packed)
    torch.cuda.synchronize()
    after = (fed3r_stats.launches, quantize_tiles.launches, dequant_accumulate.launches)
    assert [a - b for a, b in zip(after, before)] == [6, 12, 12]
    cpu = AccumulationEngine(EngineConfig(n_classes=5, wire=WireFormat(kind="int8", tile=32)),
                             device="cpu")
    ref = cpu.accumulate(cpu.init(64), packed)
    step = sum(float(quantize_tiles_ref(torch.from_numpy(
        (x.T @ x).astype(np.float32)), 32)[1].max()) for x, _ in clients)
    assert float((acc.stats.A.cpu() - ref.stats.A).abs().max()) <= step + REL_TOL * float(
        ref.stats.A.abs().max())


# flash attention: the reference test's tolerances (tests/test_kernels.py);
# in bf16 also each row's error against the plain version on the same inputs
# in fp32, in bf16 ulps of the row's max|o| (chip_smoke.py's FLASH_BF16_ULPS)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
FLASH_BF16_ULPS = 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 128, 2, 2, 32), (2, 256, 4, 2, 64),
                                         (1, 384, 8, 1, 16), (1, 1000, 28, 4, 128),
                                         (2, 77, 8, 2, 64), (1, 300, 4, 1, 256),
                                         (2, 200, 4, 2, 48)])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_card(cuda_device, B, S, H, KV, hd, window, dtype):
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.normal(size=(B, S, n, hd)).astype(np.float32)).to(
        cuda_device, dtype) for n in (H, KV, KV))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)
    assert torch.equal(got, flash_attention(q, k, v, causal=True, window=window))
    if dtype == torch.bfloat16:
        exact = flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window)
        top = exact.abs().amax(-1)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        assert float(((got.float() - exact).abs().amax(-1) / ulp).max()) <= FLASH_BF16_ULPS


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_is_the_logsumexp_of_the_scaled_scores(cuda_device, hd, dtype):
    """The kernel's row log-sum-exp (l from the unrounded p) against an fp32
    logsumexp of the scaled, masked scores (chip_smoke.py's check)."""
    from repro_torch.kernels import flash_attention as fa_mod

    B, S, H, KV, window = 2, 300, 4, 2, 100
    r = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(r.normal(size=(B, S, n, hd)).astype(np.float32)).to(
        cuda_device, dtype) for n in (H, KV, KV))
    lse = torch.empty((B, H, S), device=cuda_device)
    fa_mod._launch(q, k, v, True, window, lse)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float().reshape(B, S, KV, H // KV, hd),
                     k.float()) * hd ** -0.5
    pos = torch.arange(S, device=cuda_device)
    valid = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    want = torch.logsumexp(s.masked_fill(~valid, -1e30), -1).reshape(B, H, S)
    assert float((lse - want).abs().max()) <= 1e-5  # chip_smoke.py's FLASH_LSE_LIMIT


@pytest.mark.gpu
def test_smoke_serving_path_on_card_gives_the_cpu_tokens_in_fp32(cuda_device):
    """qwen2-7b-smoke in fp32: the card's prefill (the fp32 kernel) and
    decode give the CPU's plain path's greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-7b-smoke").replace(dtype="float32")
    params = build_model(cfg).init(seed=0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)))
    kw = dict(gen=6, verbose=False, dtype="float32", prompts=prompts)
    cpu = serve("qwen2-7b-smoke", device="cpu", params=params, **kw)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(cuda_device)

    card = serve("qwen2-7b-smoke", device=cuda_device, params=to_card(params), **kw)
    assert card.prefill_launches == cfg.n_layers and card.decode_launches == 0
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b-smoke", "recurrentgemma-9b-smoke",
                                  "qwen2-vl-2b-smoke"])
def test_family_smoke_serving_path_on_card_gives_the_cpu_tokens_in_fp32(cuda_device, arch):
    """The SSM, hybrid and VLM smoke configs in fp32 (the hybrid's prompt
    longer than its local window): the card's prefill and decode give the
    CPU's plain path's greedy tokens, the prefill launching flash_attention
    once an attention layer (none for the SSM), decode none."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).replace(dtype="float32")
    params = build_model(cfg).init(seed=0, device="cpu")
    r = np.random.default_rng(6)
    prompts = torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 64)))
    patches = (torch.from_numpy((0.1 * r.standard_normal((2, cfg.n_patches, cfg.d_model))
                                 ).astype(np.float32)) if cfg.arch_type == "vlm" else None)
    kw = dict(gen=6, verbose=False, dtype="float32", prompts=prompts, patch_embeds=patches)
    cpu = serve(arch, device="cpu", params=params, **kw)
    card = serve(arch, device=cuda_device, params=tree_map(lambda t: t.to(cuda_device), params),
                 **kw)
    attn_layers = sum(k == "attn" for k in cfg.pattern_for(cfg.n_layers))  # an SSM's: 0
    assert card.prefill_launches == attn_layers and card.decode_launches == 0
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["fedavg", "scaffold", "fedyogi"])
def test_round_step_makes_no_host_sync_on_card(cuda_device, algo):
    """The cohort round engine's step, its cohort already on the card, syncs
    nothing: vmapped local updates, the on-device weighted delta, the server
    step and (Scaffold) the cvar gather and scatter."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.data.pipeline import FederatedDataset
    from repro_torch.federated.algorithms import make_algorithm
    from repro_torch.federated.round_engine import RoundConfig, RoundEngine
    from repro_torch.federated.simulator import linear_head_task, pack_round

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(600, 8)).astype(np.float32)
    labels = rng.integers(0, 4, 600).astype(np.int32)
    fed = FederatedDataset(feats, labels, np.array_split(np.arange(600), 12), 4)
    task = linear_head_task(8, 4, feats[:50], labels[:50],
                            W_init=0.01 * rng.normal(size=(8, 4)), device=cuda_device)
    rc = RoundConfig(algo=make_algorithm(algo), client_lr=0.1, n_total_clients=12,
                     server_lr=0.01 if algo == "fedyogi" else 1.0)
    eng = RoundEngine(rc, task.per_example_loss, task.freeze)
    fc = FederatedConfig(n_clients=12, clients_per_round=4, local_batch_size=16)
    cohort = pack_round(fed, fc, 0, n_batches=4)[1].to(cuda_device)
    state = eng.step(eng.init(task.params0), cohort)  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = eng.step(state, cohort)
        state = eng.step(state, cohort)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.round) == 3


# the full-width FT round (10 clients x 64 sequences x 128 tokens) must fit
# in half the card's 80 GB: the vmapped cohort holds a copy of the params,
# their gradients and bf16 casts a client, plus the activations
FULL_WIDTH_PEAK_LIMIT = 40 * 2**30


@pytest.mark.gpu
def test_full_width_ft_round_memory_on_card(cuda_device):
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    out = train.run("fed3r-mnv2-proxy", rounds=1, n_samples=8192, seq_len=128,
                    n_classes=100, n_clients=100, clients_per_round=10,
                    local_batch_size=64, use_fed3r_init=False, verbose=False)
    peak = torch.cuda.max_memory_allocated()
    state = out["ft"]["state"]
    assert int(state.round) == 1
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
    assert peak <= FULL_WIDTH_PEAK_LIMIT, peak / 2**30
