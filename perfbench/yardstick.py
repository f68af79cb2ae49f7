"""The yardstick: the card's peaks and the work each kernel and step needs.

Frozen here, apart from the program: the port's own counts
(``kernels/build.py::count_work``, ``launch/flops.py``,
``launch/time_kernels.py``) count the rows as launched, padding included;
these count what the live rows need, so padding shows as a lower share.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor-core bf16; fp32 off the tensor cores
PEAK_BYTES_S = 3.35e12  # HBM3
F32 = 4


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the memory's rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_S)


def fed3r_stats_work(n_live: int, d: int, C: int) -> tuple:
    """(FLOPs, bytes) one ``fed3r_stats`` launch needs for ``n_live`` rows:
    A's upper triangle with its diagonal, a multiply-add a pair; b's rows
    summed by label, since Y is one-hot (an addition a feature a row, not a
    GEMM over Y).  Z's live rows and their labels (4 bytes each) read once,
    A and b written once, in fp32."""
    flops = n_live * d * (d + 1) + n_live * d
    nbytes = F32 * (n_live * d + n_live + d * d + d * C)
    return flops, nbytes


def rff_work(n_live: int, d: int, D: int) -> tuple:
    """(FLOPs, bytes) one ``rff`` launch needs for ``n_live`` rows: the
    (n, d) x (d, D) product; Z's live rows, Omega and beta read once, psi's
    live rows written once, in fp32."""
    flops = 2.0 * n_live * d * D
    nbytes = F32 * (n_live * d + d * D + D + n_live * D)
    return flops, nbytes


def stats_sample_flops(d: int, C: int) -> float:
    """One live sample's share of the statistics (A's upper triangle, and b
    as a sum by label); the same count as :func:`fed3r_stats_work`."""
    return fed3r_stats_work(1, d, C)[0]


def rff_sample_flops(d: int, D: int) -> float:
    return 2.0 * d * D


def kernel_roofline_pct(record: dict, kernel: str, work) -> "float | None":
    """A kernel's share of its roofline over the traced window: the sum of
    its launches' bounds over the sum of their device times.  The launches
    are ``record["launches"][kernel]`` (live rows each), the device times
    those of the profiled kernels whose name holds ``<kernel>_kernel``;
    None where the two counts differ or the kernel never ran."""
    rows = record.get("launches", {}).get(kernel)
    times = [t for name, t in record.get("kernels", ()) if f"{kernel}_kernel" in name]
    if not rows or len(rows) != len(times) or sum(times) <= 0:
        return None
    peak = PEAK_FLOPS["float32"]  # the port's kernels multiply in IEEE fp32
    bound = sum(bound_s(*work(n), peak) for n in rows)
    return 100.0 * bound / sum(times)
