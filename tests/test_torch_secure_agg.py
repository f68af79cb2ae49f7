"""The port's secure aggregation (paper App. B) against the reference's.

* The cohort quantizer is bitwise the reference's (which runs eagerly, so
  its shared scale is the true quotient max|x| / 127), and so is the
  shared-scale dequantization.
* Integer masks mod 2³²: masked uploads differ from the plain ones, and
  their ring sum is BITWISE the unmasked integer sum; with clients dropped,
  the recovered survivor sum is bitwise the survivors' sum.  The ring
  arithmetic wraps explicitly (int64 sums folded back to int32).
* Float masks cancel to fp32 tolerance, scaled to max|A| (each entry sums
  masks of magnitude ~10 across the cohort, so the cancellation error is a
  few ulps of that, not of A).
* The masks are the port's own (``torch.Generator``; the reference's
  ``jax.random`` bits are not reproducible in PyTorch), so the comparisons
  with the reference are on what the protocol guarantees: the sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data.pipeline import pack_personal_cohort as jpack_personal_cohort  # noqa: E402
from repro.federated import compress as jcompress  # noqa: E402
from repro.federated.personalization import cohort_stats as jcohort_stats  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import pack_personal_cohort  # noqa: E402
from repro_torch.federated import compress, secure_agg  # noqa: E402
from repro_torch.federated.personalization import (  # noqa: E402
    PersonalizationEngine,
    PersonalizeConfig,
    cohort_stats,
)

D, C = 48, 7
# float masks N(0, 10²) summed over a cohort of K: the residue after
# cancellation is a few fp32 ulps of the masks' partial sums (~10·√K)
FLOAT_MASK_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _clients(rng, K=4, d=D, n_classes=C, lo=5, hi=20):
    """The reference test's clusters (tests/test_compress.py)."""
    out = {}
    centers = rng.normal(size=(n_classes, d)).astype(np.float32) * 3.0
    for k in range(K):
        n = int(rng.integers(lo, hi))
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        out[k] = (centers[y] + rng.normal(size=(n, d)).astype(np.float32), y)
    return out


def _cohort(seed, K):
    clients = _clients(np.random.default_rng(seed), K=K)
    cohort = sorted(clients)
    stats = [fed3r.client_stats(_t(x), _t(y), C) for x, y in (clients[k] for k in cohort)]
    return clients, cohort, stats


def _int_sum(payloads):
    """The plain (unmasked) integer sum, in int64: no wrap can hide here."""
    return [sum(p[i].to(torch.int64) for p in payloads) for i in range(2)]


def test_ring_arithmetic_wraps_mod_2_32():
    big = torch.tensor([2**31 - 1, -(2**31), 5, -7], dtype=torch.int32)
    one = torch.tensor([1, 1, 2**31 - 1, -(2**31)], dtype=torch.int32)
    got = secure_agg.ring_add(big, one)
    assert got.dtype == torch.int32
    assert got.tolist() == [-(2**31), -(2**31) + 1, -(2**31) + 4, 2**31 - 7]
    assert torch.equal(secure_agg.ring_sub(got, one), big)
    # torch's own int32 addition wraps the same way on the CPU
    assert torch.equal(big + one, got)


def test_cohort_quantize_equals_reference_bitwise():
    clients, cohort, stats = _cohort(8, 4)
    payloads, sA, sb = compress.cohort_quantize_int8(stats, tile=16)
    jstats = [jfed3r.Fed3RStats(A=jnp.asarray(s.A.numpy()), b=jnp.asarray(s.b.numpy()),
                                n=jnp.asarray(s.n.numpy())) for s in stats]
    jpayloads, jsA, jsb = jcompress.cohort_quantize_int8(jstats, tile=16)
    np.testing.assert_array_equal(sA.numpy(), np.asarray(jsA))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    for p, jp in zip(payloads, jpayloads):
        assert p.qA.dtype == torch.int32 and p.qb.dtype == torch.int32
        np.testing.assert_array_equal(p.qA.numpy(), np.asarray(jp.qA))
        np.testing.assert_array_equal(p.qb.numpy(), np.asarray(jp.qb))
    total = compress.IntPayload(*(t.to(torch.int32) for t in _int_sum(payloads)))
    jtotal = jcompress.IntPayload(qA=sum(p.qA for p in jpayloads), qb=sum(p.qb for p in jpayloads))
    A_sum, b_sum = compress.dequantize_int_sum(total, sA, sb, tile=16)
    jA_sum, jb_sum = jcompress.dequantize_int_sum(jtotal, jsA, jsb, tile=16)
    np.testing.assert_array_equal(A_sum.numpy(), np.asarray(jA_sum))
    np.testing.assert_array_equal(b_sum.numpy(), np.asarray(jb_sum))


@pytest.mark.parametrize("K", [2, 4, 7])
def test_quantized_masks_cancel_exactly(K):
    _, cohort, stats = _cohort(8, K)
    payloads, sA, sb = compress.cohort_quantize_int8(stats, tile=16)
    masked = [secure_agg.mask_quantized_payload(p, k, cohort, seed=11)
              for k, p in zip(cohort, payloads)]
    for m, p in zip(masked, payloads):  # each masked upload hides its payload
        assert m.qA.dtype == torch.int32
        assert float((m.qA != p.qA).float().mean()) > 0.99
    agg = secure_agg.secure_aggregate_quantized(masked)
    plain = _int_sum(payloads)
    assert torch.equal(agg.qA.to(torch.int64), plain[0])
    assert torch.equal(agg.qb.to(torch.int64), plain[1])
    # the masked integer sum dequantizes to the true cohort aggregate
    A_sum, b_sum = compress.dequantize_int_sum(agg, sA, sb, tile=16)
    exact = fed3r.merge(*stats)
    assert float((A_sum - exact.A).abs().max() / exact.A.abs().max()) < 0.02
    assert float((b_sum - exact.b).abs().max() / exact.b.abs().max()) < 0.02


@pytest.mark.parametrize("dropped", [[1], [0, 3], [2, 4, 5], [0, 1, 2, 3, 4]])
def test_quantized_dropout_recovery_is_bitwise(dropped):
    _, cohort, stats = _cohort(12, 6)
    payloads, _, _ = compress.cohort_quantize_int8(stats, tile=16)
    masked = {k: secure_agg.mask_quantized_payload(p, k, cohort, seed=3)
              for k, p in zip(cohort, payloads)}
    survivors = [k for k in cohort if k not in dropped]
    masked_sum = secure_agg.secure_aggregate_quantized([masked[k] for k in survivors])
    assert not torch.equal(masked_sum.qA.to(torch.int64),
                           _int_sum([payloads[k] for k in survivors])[0])  # orphans remain
    rec = secure_agg.recover_survivor_sum_quantized(masked_sum, survivors, dropped, seed=3)
    want = _int_sum([payloads[k] for k in survivors])
    assert torch.equal(rec.qA.to(torch.int64), want[0])
    assert torch.equal(rec.qb.to(torch.int64), want[1])


def test_float_masks_cancel_and_dropout_recovers_to_tolerance():
    _, cohort, stats = _cohort(9, 5)
    masked = [secure_agg.mask_statistics(s, k, cohort, seed=5) for k, s in zip(cohort, stats)]
    assert float((masked[0].A - stats[0].A).abs().max()) > 1.0  # actually masked
    exact = fed3r.merge(*stats)
    agg = secure_agg.secure_aggregate(masked)
    for got, want in zip(agg, exact):
        assert float((got - want).abs().max()) <= FLOAT_MASK_ATOL * max(float(want.abs().max()), 1)
    survivors, dropped = [0, 2, 3], [1, 4]
    rec = secure_agg.recover_survivor_sum(
        secure_agg.secure_aggregate([masked[k] for k in survivors]), survivors, dropped, seed=5)
    want = fed3r.merge(*(stats[k] for k in survivors))
    for got, w in zip(rec, want):
        assert float((got - w).abs().max()) <= FLOAT_MASK_ATOL * max(float(w.abs().max()), 1)


def test_masks_are_deterministic_pair_specific_and_uniform_over_the_ring():
    like = compress.IntPayload(qA=torch.zeros((64, 64), dtype=torch.int32),
                               qb=torch.zeros((64, 8), dtype=torch.int32))
    m = secure_agg._pair_mask_int(7, 0, 1, like)
    again = secure_agg._pair_mask_int(7, 0, 1, like)
    other = secure_agg._pair_mask_int(7, 0, 2, like)
    assert torch.equal(m.qA, again.qA) and not torch.equal(m.qA, other.qA)
    v = m.qA.to(torch.int64).flatten()
    # 4096 draws of a uniform int32: both halves of the ring, reaching its ends
    assert float((v < 0).float().mean()) == pytest.approx(0.5, abs=0.05)
    assert int(v.max()) > 2**31 * 0.99 and int(v.min()) < -(2**31) * 0.99
    assert abs(float(v.double().mean())) < 2**31 * 0.05
    f = secure_agg._pair_mask(7, 0, 1, compress.IntPayload(
        qA=torch.zeros((64, 64)), qb=torch.zeros((64, 8))))
    assert float(f.qA.std()) == pytest.approx(10.0, rel=0.05)


def test_quantized_paths_reject_non_int32_and_overlapping_sets():
    bad = compress.IntPayload(qA=torch.zeros((8, 8)), qb=torch.zeros((8, 2)))
    with pytest.raises(TypeError):
        secure_agg.mask_quantized_payload(bad, 0, [0, 1], seed=0)
    with pytest.raises(TypeError):
        secure_agg.dropout_mask_correction_quantized([0], [1], 0, bad)
    good = compress.IntPayload(qA=torch.zeros((8, 8), dtype=torch.int32),
                               qb=torch.zeros((8, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        secure_agg.dropout_mask_correction_quantized([0, 1], [1], 0, good)
    with pytest.raises(ValueError):
        secure_agg.dropout_mask_correction([0, 1], [1], 0, fed3r.init_stats(8, 2, "cpu"))


# the reference's own tolerance between the secure and plain cohort states
# (tests/test_personalization.py), scaled to the statistics' magnitude here
INTEROP_W_ATOL = 1e-4


def test_masked_client_stats_sum_to_unmasked_cohort():
    """The secure-aggregation interop of the per-tenant heads (twin of the
    reference's ``test_personalization.py``): masked per-client uploads,
    whose sum is the cohort's statistics; the heads built on that sum agree
    with those built on the plain statistics, and the statistics with the
    reference's cohort statistics."""
    Dp, Cp, lam = 24, 6, 1e-2
    rng = np.random.default_rng(12)
    clients = [(rng.normal(size=(int(n), Dp)).astype(np.float32),
                rng.integers(0, Cp, size=int(n)).astype(np.int32))
               for n in rng.integers(20, 60, size=5)]
    packed = pack_personal_cohort(clients, client_ids=list(range(5)))
    per_client = [fed3r.client_stats(_t(packed.inputs[k]), _t(packed.labels[k]), Cp,
                                     _t(packed.mask[k])) for k in range(5)]
    cohort = list(range(5))
    masked = [secure_agg.mask_statistics(s, k, cohort, seed=7) for k, s in enumerate(per_client)]
    assert float((masked[0].A - per_client[0].A).abs().max()) > 1.0
    agg = secure_agg.secure_aggregate(masked)
    plain = cohort_stats(packed, Cp, device="cpu")
    jplain = jcohort_stats(jpack_personal_cohort(clients, client_ids=list(range(5))), Cp)
    for got, want, jwant in ((agg.A, plain.A, jplain.A), (agg.b, plain.b, jplain.b)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= FLOAT_MASK_ATOL * scale
        assert float(np.abs(want.numpy() - np.asarray(jwant)).max()) <= 1e-5 * scale
    eye = lam * torch.eye(Dp)
    st_plain = fed3r.Fed3RFactored(L=fed3r.psd_cholesky(plain.A + eye), b=plain.b)
    st_agg = fed3r.Fed3RFactored(L=fed3r.psd_cholesky(agg.A + eye), b=agg.b)
    eng = PersonalizationEngine(PersonalizeConfig(n_classes=Cp, alpha_grid=(0.0, 0.5, 1.0, 2.0)),
                                device="cpu")
    alphas = [1.0] * packed.cohort
    h1, h2 = eng.solve_at(st_plain, packed, alphas), eng.solve_at(st_agg, packed, alphas)
    assert float((h1.W - h2.W).abs().max()) <= INTEROP_W_ATOL
