"""``rff``'s share of its roofline (``kernels/rff.py``, ``csrc/rff.cu``): each
launch's bound from the live rows of its shard (:func:`perfbench.yardstick.rff_work`),
over the launches' device times in the profiler's trace."""
from perfbench import yardstick


def read(record):
    cfg = record["config"]
    if "n_random_features" not in cfg:
        return None
    return yardstick.kernel_roofline_pct(
        record, "rff", lambda n: yardstick.rff_work(n, cfg["d"], cfg["n_random_features"]))
