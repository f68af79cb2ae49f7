"""The frozen operation, byte and FLOP counts against hand counts."""
import pytest

from perfbench import yardstick


def test_fed3r_stats_work_by_hand():
    # 10 live rows, d 4, C 3: A's upper triangle 10 x (4 + 3 + 2 + 1) multiply-adds,
    # b 10 x 4 additions (one-hot labels); Z 40 floats and 10 labels read, A 16 and
    # b 12 written
    flops, nbytes = yardstick.fed3r_stats_work(10, 4, 3)
    assert flops == 2 * 10 * (4 + 3 + 2 + 1) + 10 * 4
    assert nbytes == 4 * (40 + 10 + 16 + 12)
    assert yardstick.stats_sample_flops(4, 3) == flops / 10


def test_rff_work_by_hand():
    flops, nbytes = yardstick.rff_work(7, 5, 11)
    assert flops == 2 * 7 * 5 * 11
    assert nbytes == 4 * (7 * 5 + 5 * 11 + 11 + 7 * 11)


def test_bound_takes_the_larger_term():
    assert yardstick.bound_s(67e12, 0.0, 67e12) == 1.0
    assert yardstick.bound_s(0.0, 3.35e12, 67e12) == 1.0


@pytest.mark.parametrize("count_mismatch", [False, True])
def test_kernel_roofline_pct(count_mismatch):
    d, C = 64, 10
    rows = [5, 0, 12]
    times = [1e-5, 2e-5] if count_mismatch else [1e-5, 2e-5, 3e-5]
    record = {"launches": {"fed3r_stats": rows},
              "kernels": [("void fed3r_stats_kernel<64, 4, 4, true>(...)", t) for t in times]
              + [("void rff_kernel<...>", 1.0)]}
    pct = yardstick.kernel_roofline_pct(record, "fed3r_stats",
                                        lambda n: yardstick.fed3r_stats_work(n, d, C))
    if count_mismatch:
        assert pct is None
        return
    bound = sum(yardstick.bound_s(*yardstick.fed3r_stats_work(n, d, C), 67e12) for n in rows)
    assert pct == pytest.approx(100 * bound / 6e-5)
