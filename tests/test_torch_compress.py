"""The port's compressed statistics uplink against the reference's.

* ``quantize_tiles_ref`` / ``dequant_acc_ref`` (the plain versions the CPU
  path runs) equal the reference's Pallas kernels in interpret mode and its
  JITTED oracles bitwise: the reference's compiled quantizer multiplies by
  fl(1/127) and its compiled accumulate is one FMA, and the port computes
  exactly that (its eager oracle divides, so it is never the yardstick).
* ``_fp8_roundtrip`` is bitwise the reference's jitted one; the sketch's Â
  agrees within 1e-5 of max|Â| (eigenvector signs differ, Â does not).
* The engines: the fp32 wire is bitwise the uncompressed port; int8 and
  sketch are held against the reference engine (``use_kernel=False``);
  every format is bitwise invariant to client permutation.
* Error feedback telescopes; ``UplinkCompressor`` prices and names its
  telemetry as the reference does.
* The copy of ``costs.py`` gives the reference's numbers.

Tolerances on A scale with max|A| (fp32 sums in two orders), never a bare
``atol``.
"""
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data.pipeline import pack_arrival_waves as jpack_waves  # noqa: E402
from repro.data.pipeline import pack_client_shards as jpack  # noqa: E402
from repro.federated import compress as jcompress  # noqa: E402
from repro.federated import costs as jcosts  # noqa: E402
from repro.federated.engine import AccumulationEngine as JEngine  # noqa: E402
from repro.federated.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.federated.streaming_engine import StreamConfig as JStreamConfig  # noqa: E402
from repro.federated.streaming_engine import StreamingEngine as JStreamingEngine  # noqa: E402
from repro.kernels.quant import dequant_acc_pallas, quantize_tiles_pallas  # noqa: E402
from repro.kernels.ref import dequant_acc_ref as jdequant_acc_ref  # noqa: E402
from repro.kernels.ref import quantize_tiles_ref as jquantize_tiles_ref  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.core.fed3r import Fed3RStats  # noqa: E402
from repro_torch.data.pipeline import pack_arrival_waves, pack_client_shards  # noqa: E402
from repro_torch.federated import compress, costs  # noqa: E402
from repro_torch.federated.compress import EFState, UplinkCompressor, WireFormat  # noqa: E402
from repro_torch.federated.engine import AccumulationEngine, EngineConfig  # noqa: E402
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine  # noqa: E402
from repro_torch.federated.telemetry import Telemetry  # noqa: E402
from repro_torch.kernels.ops import chol_gram, dequant_accumulate, quantize_tiles  # noqa: E402
from repro_torch.kernels.ref import dequant_acc_ref, expand_tiles, quantize_tiles_ref  # noqa: E402

D, C = 48, 7
STATS_REL = 1e-5  # fp32 sums of ≤ 100 products in two orders, relative to max|A|
# a symmetric eigendecomposition in two libraries: Â = ZᵀZ agrees to a few
# fp32 ulps of its largest eigenvalue
SKETCH_REL = 1e-5

jquantize = jax.jit(jquantize_tiles_ref, static_argnames=("tile",))
jdequant = jax.jit(jdequant_acc_ref, static_argnames=("tile",))


def _t(a):
    return torch.from_numpy(np.array(a))


def _clients(rng, K=6, d=D, n_classes=C, lo=5, hi=20):
    """The reference test's clusters (tests/test_compress.py): separable classes."""
    out = {}
    centers = rng.normal(size=(n_classes, d)).astype(np.float32) * 3.0
    for k in range(K):
        n = int(rng.integers(lo, hi))
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        out[k] = (centers[y] + rng.normal(size=(n, d)).astype(np.float32), y)
    return out


def _stats(x, y, n_classes=C):
    return fed3r.client_stats(_t(x), _t(y), n_classes)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def half_way_matrix(tiles_down, tiles_across, tile, seed):
    """An fp32 matrix whose every entry but one a tile sits exactly half-way
    between two integers of its tile's quantization grid (x/s = k + ½ with no
    rounding anywhere), so round-half-to-even decides each of them."""
    r = np.random.default_rng(seed)
    inv = np.float32(1.0 / 127.0)
    x = np.empty((tiles_down * tile, tiles_across * tile), np.float32)
    for i in range(tiles_down):
        for j in range(tiles_across):
            while True:  # an absmax whose scale has ≤ 15 significant bits
                a = np.float32(r.uniform(1.0, 100.0))
                s = np.float32(a * inv)
                if int(s.view(np.uint32)) & 0x1FF == 0:
                    break
            k = r.integers(-127, 127, size=(tile, tile))
            blk = ((k + 0.5) * np.float64(s)).astype(np.float32)  # exact: ≤ 23 bits
            blk[0, 0] = a  # the tile's absmax: every other |x| ≤ 126.5·s < a
            x[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = blk
    return x


# ---------------------------------------------------------------------------
# The kernels' plain versions against the reference kernels, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tile", [
    ((128, 128), 128),  # exactly one tile
    ((256, 128), 64),   # aligned multi-tile
    ((200, 150), 64),   # ragged both dims
    ((33, 190), 128),   # smaller than one tile in M
    ((1281, 77), 16),   # many small tiles, ragged
])
def test_quantize_tiles_equals_reference_kernel_bitwise(shape, tile):
    x = (10.0 * np.random.default_rng(0).normal(size=shape)).astype(np.float32)
    q, s = quantize_tiles(_t(x), tile=tile)  # a CPU tensor: the plain version
    qp, sp = quantize_tiles_pallas(jnp.asarray(x), tile=tile, interpret=True)
    qj, sj = jquantize(jnp.asarray(x), tile=tile)
    assert q.dtype == torch.int8 and tuple(q.shape) == shape
    assert tuple(s.shape) == (-(-shape[0] // tile), -(-shape[1] // tile))
    for ref_q, ref_s in ((qp, sp), (qj, sj)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("shape,tile", [((200, 150), 64), ((128, 128), 128), ((1281, 77), 16)])
def test_dequant_accumulate_equals_reference_kernel_bitwise(shape, tile):
    r = np.random.default_rng(1)
    x = r.normal(size=shape).astype(np.float32)
    acc = r.normal(size=shape).astype(np.float32)
    qp, sp = quantize_tiles_pallas(jnp.asarray(x), tile=tile, interpret=True)
    out = dequant_accumulate(_t(acc), _t(qp), _t(sp), tile=tile)
    want_p = dequant_acc_pallas(jnp.asarray(acc), qp, sp, tile=tile, interpret=True)
    want_j = jdequant(jnp.asarray(acc), qp, sp, tile=tile)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_j))
    # the roundtrip is a faithful int8 reconstruction of x
    assert float((out - _t(acc) - _t(x)).abs().max()) <= float(np.abs(x).max()) / 127.0


def _exact_fma_f32(q, s, acc):
    """fp32(q·s + acc) rounded once, half to even, from exact rationals."""
    from fractions import Fraction

    exact = Fraction(int(q)) * Fraction(float(s)) + Fraction(float(acc))
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.float32(c).view(np.uint32)) & 1))
    return np.float32(best)


def test_dequant_acc_ref_is_one_fma():
    """One rounding, on random data (against ``torch.addcmul``, a fused
    multiply-add on the CPU) and on sums that land on an fp32 tie after a
    float64 rounding, where a plain float64 sum double-rounds."""
    r = np.random.default_rng(2)
    acc = r.normal(size=(64, 64)).astype(np.float32)
    q = r.integers(-127, 128, size=(64, 64)).astype(np.int8)
    s = (r.uniform(0.01, 1.0, size=(4, 4))).astype(np.float32)
    out = dequant_acc_ref(_t(acc), _t(q), _t(s), tile=16)
    fused = torch.addcmul(_t(acc), _t(q).float(), expand_tiles(_t(s), 16, 64, 64))
    assert torch.equal(out, fused)
    unfused = _t(acc) + _t(q).float() * expand_tiles(_t(s), 16, 64, 64)
    assert not torch.equal(out, unfused)  # the data does tell one rounding from two
    # acc = 1 and q·s = 2⁻²⁴ + 2⁻⁵⁴·k: the float64 sum rounds to the fp32 tie
    # 1 + 2⁻²⁴, which a second rounding sends to 1; the exact sum is above it
    qs = np.array([1, 3, 5, 7], np.int8)
    ss = np.array([np.float32(2.0**-24 + 2.0**-47), np.float32((2.0**-24 + 2.0**-48) / 3),
                   np.float32((2.0**-24 + 2.0**-46) / 5), np.float32((2.0**-24 - 2.0**-47) / 7)],
                  np.float32)
    accs = np.ones(4, np.float32)
    got = dequant_acc_ref(_t(accs[None]), _t(qs[None]), _t(ss[None]), tile=1)[0]
    want = [_exact_fma_f32(q_, s_, a_) for q_, s_, a_ in zip(qs, ss, accs)]
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))


def test_quantize_zero_tile_scale_is_one():
    x = torch.zeros((64, 64))
    x[:32, :32] = 3.0  # one live tile beside three all-zero ones
    q, s = quantize_tiles(x, tile=32)
    assert torch.equal(s, torch.tensor([[3.0 * np.float32(1 / 127), 1.0], [1.0, 1.0]]))
    assert not q[32:].any() and not q[:, 32:].any()
    assert bool((q[:32, :32] == 127).all())


def test_quantize_rounds_half_way_to_even():
    x = half_way_matrix(2, 3, 32, seed=3)
    q, s = quantize_tiles(_t(x), tile=32)
    ratio = x.astype(np.float64) / np.repeat(np.repeat(s.numpy(), 32, 0), 32, 1)
    tie = np.abs(ratio - np.floor(ratio) - 0.5) == 0.0
    assert tie.sum() == x.size - 6  # every entry but the tiles' absmax is a tie
    np.testing.assert_array_equal(q.numpy()[tie], np.round(ratio[tie]))  # numpy: half to even
    assert bool((q.numpy()[tie] % 2 == 0).all())
    qp, sp = quantize_tiles_pallas(jnp.asarray(x), tile=32, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sp))


def test_quant_wrappers_validate_and_launch_nothing_on_the_cpu():
    x = torch.ones((8, 8))
    before = (quantize_tiles.launches, dequant_accumulate.launches)
    q, s = quantize_tiles(x, tile=4)
    dequant_accumulate(x, q, s, tile=4)
    assert (quantize_tiles.launches, dequant_accumulate.launches) == before
    with pytest.raises(TypeError):
        quantize_tiles(x.double(), tile=4)
    with pytest.raises(ValueError):
        quantize_tiles(x.T[:, :4], tile=4)  # not contiguous
    with pytest.raises(ValueError):
        quantize_tiles(x, tile=0)
    with pytest.raises(ValueError):  # a scale grid of another tile
        dequant_accumulate(x, q, s, tile=2)
    with pytest.raises(TypeError):
        dequant_accumulate(x, q.to(torch.int32), s, tile=4)


# ---------------------------------------------------------------------------
# Wire formats
# ---------------------------------------------------------------------------


def test_wireformat_validation_and_bytes():
    with pytest.raises(ValueError):
        WireFormat(kind="int4")
    with pytest.raises(ValueError):
        WireFormat(tile=0)
    with pytest.raises(ValueError):
        WireFormat(rank=0)
    for kind in costs.WIRE_KINDS:
        fmt = WireFormat(kind=kind, tile=64, rank=8)
        assert fmt.wire_bytes(1280, 100) == jcompress.WireFormat(
            kind=kind, tile=64, rank=8).wire_bytes(1280, 100)


def test_fp8_is_native_and_never_degrades():
    assert compress.fp8_supported()
    assert WireFormat(kind="fp8").resolved().kind == "fp8"


def test_fp8_fallback_warns_once_and_records_the_event(monkeypatch):
    monkeypatch.setattr(compress, "fp8_supported", lambda: False)
    compress._warn_fp8_fallback.cache_clear()
    tel = Telemetry()
    monkeypatch.setattr(compress, "get_telemetry", lambda: tel)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                resolved = WireFormat(kind="fp8", tile=32).resolved()
            StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=1e-2,
                                         wire=WireFormat(kind="fp8")), device="cpu")
        fallback = [w for w in caught if "falling back to int8" in str(w.message)]
        assert len(fallback) == 1 and issubclass(fallback[0].category, RuntimeWarning)
        assert resolved == WireFormat(kind="int8", tile=32)
        assert "fp8_fallback" in tel.events_jsonl()
    finally:
        compress._warn_fp8_fallback.cache_clear()


@pytest.mark.parametrize("shape,tile", [((48, 48), 16), ((200, 150), 64), ((1280, 100), 128)])
def test_fp8_roundtrip_equals_reference_bitwise(shape, tile):
    x = (5.0 * np.random.default_rng(4).normal(size=shape)).astype(np.float32)
    got = compress._fp8_roundtrip(_t(x), tile)
    want = jax.jit(jcompress._fp8_roundtrip, static_argnames=("tile",))(jnp.asarray(x), tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # e4m3 carries a 3-bit mantissa: relative error ≤ 2⁻⁴ of the tile's scale range
    assert float((got - _t(x)).abs().max()) <= float(np.abs(x).max()) / 8


@pytest.mark.parametrize("rank", [8, 16, 48])
def test_sketch_matches_reference(rank):
    r = np.random.default_rng(5)
    Z = r.normal(size=(24, D)).astype(np.float32)
    A = Z.T @ Z  # PSD of rank 24
    got = compress.unsketch(compress.sketch_psd(_t(A), rank))
    want = jcompress.unsketch(jcompress.sketch_psd(jnp.asarray(A), rank))
    assert _scaled_err(got.numpy(), want) <= SKETCH_REL
    if rank >= 24:  # the whole spectrum: exact up to rounding
        assert _scaled_err(got.numpy(), A) <= SKETCH_REL


def test_fp32_roundtrips_are_identities():
    r = np.random.default_rng(6)
    A, b = _t(r.normal(size=(D, D)).astype(np.float32)), _t(r.normal(size=(D, C)).astype(np.float32))
    Ah, bh = compress.wire_roundtrip(A, b, WireFormat())
    assert Ah is A and bh is b
    assert compress.matrix_roundtrip(A, WireFormat()) is A
    accA, accb = A * 2, b * 3
    fa, fb = compress.roundtrip_add(accA, accb, A, b, WireFormat())
    assert torch.equal(fa, accA + A) and torch.equal(fb, accb + b)
    assert torch.equal(compress.matrix_roundtrip_add(accA, A, WireFormat()), accA + A)
    ef = compress.ef_init(D, C, device="cpu")
    Ah, bh, ef2 = compress.compress_stats_ef(A, b, ef, WireFormat())
    assert Ah is A and bh is b and ef2 is ef


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_roundtrip_add_equals_reference_jitted(kind):
    """The engines' fold primitive.  int8: bitwise the reference's compiled
    one (one FMA per entry).  fp8: the port adds the dequantized payload
    (acc + Â, two roundings) where XLA may fuse the dequantizing product into
    the add, so the two differ by at most one rounding of the sum."""
    r = np.random.default_rng(7)
    A, b, accA, accb = (r.normal(size=s).astype(np.float32) for s in ((D, D), (D, C), (D, D), (D, C)))
    fmt, jfmt = WireFormat(kind=kind, tile=16), jcompress.WireFormat(kind=kind, tile=16)
    fa, fb = compress.roundtrip_add(_t(accA), _t(accb), _t(A), _t(b), fmt)
    ja, jb = jax.jit(lambda *a: jcompress.roundtrip_add(*a, jfmt, use_kernel=False))(
        jnp.asarray(accA), jnp.asarray(accb), jnp.asarray(A), jnp.asarray(b))
    if kind == "int8":
        np.testing.assert_array_equal(fa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(fb.numpy(), np.asarray(jb))
    else:
        Ah, bh = compress.wire_roundtrip(_t(A), _t(b), fmt)
        assert torch.equal(fa, _t(accA) + Ah) and torch.equal(fb, _t(accb) + bh)
        ulp = np.spacing(np.abs(np.asarray(ja))).max()
        assert float(np.abs(fa.numpy() - np.asarray(ja)).max()) <= ulp
    m = compress.matrix_roundtrip(_t(A), fmt)
    jm = jax.jit(lambda x: jcompress.matrix_roundtrip(x, jfmt, use_kernel=False))(jnp.asarray(A))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert torch.equal(compress.matrix_roundtrip_add(_t(accA), _t(A), fmt), fa)
    with pytest.raises(ValueError):
        compress.matrix_roundtrip(_t(A), WireFormat(kind="sketch"))


def test_quant_spectral_bound_matches_reference():
    S = np.random.default_rng(8).normal(size=(32, 32)).astype(np.float32)
    for kind in ("fp32", "sketch", "int8", "fp8"):
        got = float(compress.quant_spectral_bound(_t(S), WireFormat(kind=kind)))
        want = float(jcompress.quant_spectral_bound(jnp.asarray(S), jcompress.WireFormat(kind=kind)))
        assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    assert float(compress.quant_spectral_bound(_t(S), WireFormat(kind="int8"))) > 0.0


def test_psd_cholesky_with_a_bound():
    """A clean PD Gram factors bit-identically whatever the bound; one pushed
    indefinite by quantization-scale noise factors finite with it, and the
    same bound serves a batch."""
    G_pd = torch.eye(16) * 2.0
    plain = torch.linalg.cholesky_ex(G_pd)[0]
    assert torch.equal(compress.psd_cholesky(G_pd, torch.tensor(0.5)), plain)
    noise = np.random.default_rng(9).normal(size=(16, 16)).astype(np.float32) * 0.1
    G_bad = torch.eye(16) * 1e-4 + _t((noise + noise.T) / 2.0)
    assert int(torch.linalg.cholesky_ex(G_bad)[1]) != 0
    assert not bool(torch.isfinite(fed3r.psd_cholesky(G_bad)).all())  # the rounding bound is too small
    L = compress.psd_cholesky(G_bad, torch.tensor(1.0))
    assert bool(torch.isfinite(L).all())
    want = torch.linalg.cholesky_ex(G_bad + 1.0 * torch.eye(16))[0]  # the first retry took
    assert torch.equal(L, want)
    batch = fed3r.psd_cholesky(torch.stack([G_pd, G_bad]), bound=torch.tensor([0.5, 1.0]))
    assert torch.equal(batch[0], plain) and torch.equal(batch[1], want)
    Lj = jcompress.psd_cholesky(jnp.asarray(G_bad.numpy()), jnp.float32(1.0))
    assert _scaled_err(L.numpy(), Lj) <= 1e-5


# ---------------------------------------------------------------------------
# Error feedback and the uplink compressor
# ---------------------------------------------------------------------------


def test_error_feedback_telescopes():
    """Over R rounds the EF aggregate error stays within one quantization
    step; the deterministic no-EF error accumulates and is strictly worse."""
    clients = _clients(np.random.default_rng(0), K=4)
    R = 10

    def total_err(error_feedback):
        up = UplinkCompressor(WireFormat(kind="int8", tile=16, error_feedback=error_feedback),
                              telemetry=Telemetry())
        tot, exact, step = fed3r.init_stats(D, C, "cpu"), fed3r.init_stats(D, C, "cpu"), 0.0
        for _ in range(R):
            for k, (x, y) in clients.items():
                s = _stats(x, y)
                tot = fed3r.merge(tot, up.upload(k, s))
                exact = fed3r.merge(exact, s)
                step = max(step, float(quantize_tiles(s.A, tile=16)[1].max()))
        return float((tot.A - exact.A).abs().max()), step, tot, exact

    e_ef, step, tot_ef, exact = total_err(True)
    e_no, _, _, _ = total_err(False)
    assert e_ef < e_no and e_no / max(e_ef, 1e-12) > 2.0  # telescoping, not luck
    assert e_ef <= len(clients) * step  # each client off by its last residual only
    xs = _t(np.concatenate([x for x, _ in clients.values()]))
    p_ef = fed3r.predict(fed3r.solve(tot_ef, 1e-1), xs).argmax(1)
    p_exact = fed3r.predict(fed3r.solve(exact, 1e-1), xs).argmax(1)
    assert float((p_ef == p_exact).float().mean()) >= 0.995


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_compress_stats_ef_equals_reference(kind):
    """Error-compensated uploads of one client against the reference's
    compiled algebra.  One upload: Â and b̂ bitwise; the residual x − Â
    within one fp32 rounding (XLA may fuse the dequantizing product into the
    subtraction, one rounding where the port has two).  Repeated uploads,
    each package carrying its own residual: Â within one quantization step."""
    r = np.random.default_rng(10)
    fmt, jfmt = WireFormat(kind=kind, tile=16), jcompress.WireFormat(kind=kind, tile=16)
    jfn = jax.jit(lambda A, b, eA, eb: jcompress.compress_stats_ef(
        A, b, jcompress.EFState(eA=eA, eb=eb), jfmt, use_kernel=False))
    ef, jef = compress.ef_init(D, C, device="cpu"), jcompress.ef_init(D, C)
    for i in range(3):
        A, b = r.normal(size=(D, D)).astype(np.float32), r.normal(size=(D, C)).astype(np.float32)
        Ah, bh, ef = compress.compress_stats_ef(_t(A), _t(b), ef, fmt)
        jAh, jbh, jef = jfn(jnp.asarray(A), jnp.asarray(b), jef.eA, jef.eb)
        if i == 0:
            np.testing.assert_array_equal(Ah.numpy(), np.asarray(jAh))
            np.testing.assert_array_equal(bh.numpy(), np.asarray(jbh))
            for got, want, x in ((ef.eA, jef.eA, A), (ef.eb, jef.eb, b)):
                ulp = float(np.spacing(np.abs(x).max()))  # x − Â rounds at x's scale
                assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= ulp
        else:  # one int8 step or one e4m3 step (2⁻³ of |x|) of the tile's scale
            step = float(np.abs(A).max() + 1.0) * (1 / 127 if kind == "int8" else 1 / 8)
            assert float(np.abs(Ah.numpy() - np.asarray(jAh)).max()) <= step


def test_uplink_compressor_accounting_and_telemetry_names():
    clients = _clients(np.random.default_rng(1), K=3)
    tel = Telemetry()
    cm = costs.CostModel(b=2.22e6, d=D, C=C)
    fmt = WireFormat(kind="int8", tile=16)
    up = UplinkCompressor(fmt, cost_model=cm, telemetry=tel)
    jup = jcompress.UplinkCompressor(jcompress.WireFormat(kind="int8", tile=16), use_kernel=False)
    for k, (x, y) in clients.items():
        got = up.upload(k, _stats(x, y))
        s = jfed3r.client_stats(jnp.asarray(x), jnp.asarray(y), C)
        want = jup.upload(k, s)
        assert _scaled_err(got.A.numpy(), want.A) <= STATS_REL
        assert float(got.n) == float(want.n)
    assert up.uploads == jup.uploads == 3
    assert up.bytes_sent == jup.bytes_sent and up.bytes_fp32 == jup.bytes_fp32
    assert up.compression_ratio == jup.compression_ratio >= 3.5
    assert up.compression_ratio == costs.stats_wire_bytes(D, C) / fmt.wire_bytes(D, C)
    labels = dict(kind="int8", inst=0)
    assert tel.counter("wire_uploads_total", **labels).value == 3
    assert tel.counter("wire_bytes_sent_total", **labels).value == up.bytes_sent
    assert tel.counter("wire_bytes_fp32_total", **labels).value == up.bytes_fp32
    assert tel.gauge("wire_compression_ratio", **labels).value == up.compression_ratio
    assert tel.gauge("wire_cost_model_drift", **labels).value == 1.0
    assert tel.histogram("span_seconds", stage="upload", engine="uplink").count == 3
    e0, e1 = up._residuals[0], up._residuals[1]
    assert isinstance(e0, EFState) and not torch.equal(e0.eA, e1.eA)


# ---------------------------------------------------------------------------
# The accumulation engine under each wire
# ---------------------------------------------------------------------------


def _engine(fmt):
    return AccumulationEngine(EngineConfig(n_classes=C, wire=fmt), device="cpu")


def _accumulate(clients, fmt, per_shard=3):
    eng = _engine(fmt)
    return eng, eng.accumulate(eng.init(D), pack_client_shards(clients, per_shard))


def test_engine_fp32_wire_is_bitwise_the_uncompressed_port():
    clients = _clients(np.random.default_rng(3))
    _, acc_wire = _accumulate(clients, WireFormat(kind="fp32"))
    eng = AccumulationEngine(EngineConfig(n_classes=C), device="cpu")
    acc = eng.accumulate(eng.init(D), pack_client_shards(clients, 3))
    for got, want in zip(acc_wire.stats, acc.stats):
        assert torch.equal(got, want)
    assert torch.equal(acc_wire.class_counts, acc.class_counts)


@pytest.mark.parametrize("kind,kw", [("fp32", {}), ("int8", {"tile": 16}), ("int8", {"tile": 128}),
                                     ("sketch", {"rank": 32})])
def test_engine_matches_reference_engine(kind, kw):
    """The port's engine against the reference's (``use_kernel=False``) on
    the same packed clients.  Under int8 a client's A_k may differ between
    the packages by fp32 reassociation, which can move an entry across a
    rounding boundary of its quantization grid: one step s_k at most."""
    clients = _clients(np.random.default_rng(4), K=8, lo=10, hi=30)
    _, acc = _accumulate(clients, WireFormat(kind=kind, **kw), per_shard=4)
    jeng = JEngine(JEngineConfig(n_classes=C, use_kernel=False,
                                 wire=jcompress.WireFormat(kind=kind, **kw)))
    jacc = jeng.accumulate(jeng.init(D), jpack(clients, clients_per_shard=4))
    scale = float(np.abs(np.asarray(jacc.stats.A)).max())
    steps = 0.0
    if kind == "int8":
        steps = sum(float(quantize_tiles(_stats(x, y).A, tile=kw["tile"])[1].max())
                    for x, y in clients.values())
    rel = SKETCH_REL if kind == "sketch" else STATS_REL
    assert float(np.abs(acc.stats.A.numpy() - np.asarray(jacc.stats.A)).max()) <= \
        steps + rel * scale
    assert _scaled_err(acc.stats.b.numpy(), jacc.stats.b) <= STATS_REL + (steps > 0) * 1e-2
    assert float(acc.stats.n) == float(jacc.stats.n)
    np.testing.assert_array_equal(acc.class_counts.numpy(), np.asarray(jacc.class_counts))


def test_engine_int8_fold_is_two_quantize_and_two_dequant_calls_per_client(monkeypatch):
    calls = {"quantize_tiles": 0, "dequant_accumulate": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(compress, "quantize_tiles", counted("quantize_tiles", quantize_tiles))
    monkeypatch.setattr(compress, "dequant_accumulate",
                        counted("dequant_accumulate", dequant_accumulate))
    clients = _clients(np.random.default_rng(5), K=5)
    _accumulate(clients, WireFormat(kind="int8", tile=16), per_shard=2)  # 6 slots, 5 clients
    assert calls == {"quantize_tiles": 12, "dequant_accumulate": 12}  # padded slots fold too


@pytest.mark.parametrize("kind,kw", [("fp32", {}), ("int8", {"tile": 16}), ("fp8", {"tile": 16}),
                                     ("sketch", {"rank": 32})])
def test_engine_client_permutation_invariant(kind, kw):
    """Canonical fold order makes A bitwise invariant to the presentation
    order of the same clients, under every wire format."""
    clients = _clients(np.random.default_rng(6))
    perm = {k: clients[k] for k in reversed(sorted(clients))}
    fmt = WireFormat(kind=kind, **kw)
    _, acc_a = _accumulate(clients, fmt)
    _, acc_b = _accumulate(perm, fmt)
    assert torch.equal(acc_a.stats.A, acc_b.stats.A) and torch.equal(acc_a.stats.b, acc_b.stats.b)


@pytest.mark.parametrize("kind,kw", [("int8", {"tile": 16}), ("fp8", {"tile": 16}),
                                     ("sketch", {"rank": 32})])
def test_engine_compressed_classifier_agrees(kind, kw):
    clients = _clients(np.random.default_rng(7), K=8, lo=10, hi=30)
    _, acc32 = _accumulate(clients, WireFormat(), per_shard=4)
    _, accc = _accumulate(clients, WireFormat(kind=kind, **kw), per_shard=4)
    xs = _t(np.concatenate([x for x, _ in clients.values()]))
    ys = _t(np.concatenate([y for _, y in clients.values()]))
    acc_32 = float(fed3r.accuracy(fed3r.solve(acc32.stats, 1e-1), xs, ys))
    acc_c = float(fed3r.accuracy(fed3r.solve(accc.stats, 1e-1), xs, ys))
    assert abs(acc_32 - acc_c) <= 0.005


# ---------------------------------------------------------------------------
# The streaming engine under each wire
# ---------------------------------------------------------------------------


def _waves(npr, T=5, P=2, d=D, n_classes=C):
    """The reference test's arrivals: early waves hold far fewer samples than d."""
    centers = npr.normal(size=(n_classes, d)).astype(np.float32) * 3.0
    waves = []
    for _ in range(T):
        wave = []
        for _ in range(P):
            n = int(npr.integers(4, 12))
            y = npr.integers(0, n_classes, size=n).astype(np.int32)
            wave.append((centers[y] + npr.normal(size=(n, d)).astype(np.float32), y))
        waves.append(wave)
    return waves


def _stream(waves, fmt):
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=1e-2, wire=fmt), device="cpu")
    state, _ = eng.absorb(eng.init(D), pack_arrival_waves(waves))
    return eng, state


def test_streaming_fp32_wire_is_bitwise_the_uncompressed_port():
    waves = _waves(np.random.default_rng(6))
    _, s_wire = _stream(waves, WireFormat(kind="fp32"))
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=1e-2), device="cpu")
    s_plain, _ = eng.absorb(eng.init(D), pack_arrival_waves(waves))
    assert torch.equal(s_wire.L, s_plain.L) and torch.equal(s_wire.W, s_plain.W)


# the reference stream and the port's, same arrivals: W = L⁻ᵀL⁻¹b on
# rank-deficient early waves at λ = 1e-2 amplifies the fp32 reassociation of
# the Grams (the uncompressed streams already differ by ~5e-5 of max|W| here)
STREAM_W_REL = 1e-3


@pytest.mark.parametrize("kind,kw", [("fp32", {}), ("int8", {"tile": 16}), ("fp8", {"tile": 16}),
                                     ("sketch", {"rank": 40})])
def test_streaming_matches_reference_stream(kind, kw):
    waves = _waves(np.random.default_rng(7))
    _, state = _stream(waves, WireFormat(kind=kind, **kw))
    jeng = JStreamingEngine(JStreamConfig(n_classes=C, ridge_lambda=1e-2, use_kernel=False,
                                          wire=jcompress.WireFormat(kind=kind, **kw)))
    jstate, _ = jeng.absorb(jeng.init(D), jpack_waves(waves))
    assert bool(np.isfinite(np.asarray(jstate.W)).all())
    assert _scaled_err(state.W.numpy(), jstate.W) <= STREAM_W_REL
    assert float(state.n) == float(jstate.n)


@pytest.mark.parametrize("kind,kw", [("int8", {"tile": 16}), ("sketch", {"rank": 40})])
def test_streaming_compressed_finite_and_close(kind, kw):
    """Rank-deficient early waves make the quantized Gram indefinite; the
    guarded factorization keeps the stream finite, and W lossy but sane
    (the reference's bound, for the formats the reference bounds: fp8 at
    tile 16 moves W by 0.9 of max|W| on these waves in both packages)."""
    waves = _waves(np.random.default_rng(7))
    _, s32 = _stream(waves, WireFormat())
    eng, sc = _stream(waves, WireFormat(kind=kind, **kw))
    assert eng.dispatches == 1
    assert bool(torch.isfinite(sc.L).all()) and bool(torch.isfinite(sc.W).all())
    assert float((sc.W - s32.W).abs().max() / s32.W.abs().max()) < 0.5


def test_streaming_int8_permutation_invariant():
    """Concurrent arrivals presented in another order: the same state, bitwise."""
    waves = _waves(np.random.default_rng(8), P=3)
    ids = [[3 * t + i for i in range(len(w))] for t, w in enumerate(waves)]
    cfg = StreamConfig(n_classes=C, ridge_lambda=1e-2, wire=WireFormat(kind="int8", tile=16))
    eng = StreamingEngine(cfg, device="cpu")
    a, _ = eng.absorb(eng.init(D), pack_arrival_waves(waves, client_ids=ids))
    b, _ = eng.absorb(eng.init(D), pack_arrival_waves([w[::-1] for w in waves],
                                                      client_ids=[i[::-1] for i in ids]))
    assert torch.equal(a.L, b.L) and torch.equal(a.b, b.b) and torch.equal(a.W, b.W)


def test_absorb_stats_under_a_lossy_wire_sizes_the_guard_by_it():
    """``absorb_stats`` does not roundtrip reduced statistics under "merge",
    but factors with the wire's noise bound, as the reference does: on
    rank-deficient statistics (where the plain factorization fails) the
    factor is the guarded one with that bound; on well-conditioned ones it
    agrees with the reference's."""
    int8 = WireFormat(kind="int8", tile=16)
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=1e-2, wire=int8), device="cpu")
    state = eng.init(D)
    few = _clients(np.random.default_rng(9), K=3, lo=4, hi=8)
    # large features: the Gram's fp32 rounding dwarfs λ on its null space
    st = fed3r.merge(*(_stats(30.0 * x, y) for x, y in few.values()))
    G = chol_gram(state.L, torch.zeros((0, D)), torch.zeros((0, C)))[0] + st.A
    assert int(torch.linalg.cholesky_ex(G)[1]) != 0  # the guard has work to do
    out = eng.absorb_stats(state, st.A, st.b, st.n)
    assert torch.equal(out.L, fed3r.psd_cholesky(G, bound=compress.quant_spectral_bound(st.A, int8)))
    assert bool(torch.isfinite(out.W).all())

    many = _clients(np.random.default_rng(10), K=3, lo=40, hi=80)
    st = fed3r.merge(*(_stats(x, y) for x, y in many.values()))
    out = eng.absorb_stats(state, st.A, st.b, st.n)
    jeng = JStreamingEngine(JStreamConfig(n_classes=C, ridge_lambda=1e-2, use_kernel=False,
                                          wire=jcompress.WireFormat(kind="int8", tile=16)))
    js = jeng.absorb_stats(jeng.init(D), jnp.asarray(st.A.numpy()), jnp.asarray(st.b.numpy()),
                           jnp.asarray(st.n.numpy()))
    assert _scaled_err(out.L.numpy(), js.L) <= STATS_REL
    assert _scaled_err(out.W.numpy(), js.W) <= STREAM_W_REL


# ---------------------------------------------------------------------------
# The copy of costs.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,C_", [(1280, 100), (48, 7), (130, 1203)])
def test_costs_copy_prices_every_wire_as_the_reference(d, C_):
    for kind in costs.WIRE_KINDS:
        for tile, rank in ((128, 16), (16, 40)):
            assert costs.stats_wire_bytes(d, C_, kind, tile, rank) == \
                jcosts.stats_wire_bytes(d, C_, kind, tile, rank)
    with pytest.raises(ValueError):
        costs.stats_wire_bytes(d, C_, "bf16")
    cm, jcm = costs.CostModel(b=2.22e6, d=d, C=C_), jcosts.CostModel(b=2.22e6, d=d, C=C_)
    for kind in costs.WIRE_KINDS:
        assert cm.compressed_stats_bytes(kind, 7, tile=64, rank=8) == \
            jcm.compressed_stats_bytes(kind, 7, tile=64, rank=8)
        assert cm.wire_compression_ratio(kind) == jcm.wire_compression_ratio(kind)
    assert cm.tenant_stats_bytes(3) == jcm.tenant_stats_bytes(3) == cm.compressed_stats_bytes("fp32", 3)
    for alg in ("fedavg", "scaffold", "fedavg-lp", "fed3r", "fed3r+ft-feat", "fed3r-personalized",
                "personalized-ft"):
        assert cm.comm_per_client(alg) == jcm.comm_per_client(alg)
        assert cm.comp_per_client(alg, 50.0) == jcm.comp_per_client(alg, 50.0)
    rates = dict(ici_bw=50e9, dcn_bw=12.5e9)  # the reference's defaults, stated
    for wire in costs.WIRE_KINDS:
        assert cm.two_stage_allreduce(8, 2, wire=wire, **rates) == \
            jcm.two_stage_allreduce(8, 2, wire=wire)
    assert cm.serving_qps_roofline(1.97e14, 8.1e11) == jcm.serving_qps_roofline()
    tiers = [dict(name="edge", fan_in=4, wire="int8", bandwidth=1e9),
             dict(name="cloud", fan_in=2, wire="fp32", bandwidth=5e9)]
    assert cm.tiered_allreduce(tiers) == jcm.tiered_allreduce(tiers)
    assert cm.straggler_tail(16, 0.2) == jcm.straggler_tail(16, 0.2)
    assert cm.personalization_vs_model_push_ratio() == jcm.personalization_vs_model_push_ratio()


def test_costs_copy_prices_fed3r_rf_and_names_a_missing_D():
    """The FED3R-RF pricing row: the reference's numbers where D is set, and
    a ValueError naming D where it is not (the reference fails an assert)."""
    cm = costs.CostModel(b=2.22e6, d=1280, C=100, D=5000)
    jcm = jcosts.CostModel(b=2.22e6, d=1280, C=100, D=5000)
    assert cm.comm_per_client("fed3r-rf") == jcm.comm_per_client("fed3r-rf")
    assert cm.comp_per_client("fed3r-rf", 500.0) == jcm.comp_per_client("fed3r-rf", 500.0)
    np.testing.assert_array_equal(cm.cumulative_comm_bytes("fed3r-rf", 5, 10),
                                  jcm.cumulative_comm_bytes("fed3r-rf", 5, 10))
    no_rf = costs.CostModel(b=2.22e6, d=1280, C=100)
    for call in (lambda: no_rf.comm_per_client("fed3r-rf"),
                 lambda: no_rf.comp_per_client("fed3r-rf", 500.0)):
        with pytest.raises(ValueError, match="D=0"):
            call()
    with pytest.raises(ValueError, match="bandwidth"):
        cm.tiered_allreduce([dict(fan_in=2)])
    assert math.isclose(costs.CIFAR100.wire_compression_ratio("int8"), 7_065_600 / 1_766_840)
