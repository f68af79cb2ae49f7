"""``fed3r_stats``'s share of its roofline (``kernels/fed3r_stats.py``,
``csrc/fed3r_stats.cu``): each launch's bound from the live rows of its slot
(:func:`perfbench.yardstick.fed3r_stats_work`), over the launches' device times
in the profiler's trace."""
from perfbench import yardstick


def read(record):
    d, C = record["dims"]["d"], record["dims"]["C"]
    return yardstick.kernel_roofline_pct(record, "fed3r_stats",
                                         lambda n: yardstick.fed3r_stats_work(n, d, C))
