"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window.  The
last line of standard output is the result; the numbers compared with the
reference, each beside its limit, are the last lines of standard error.
Kernels build into ``build/`` in the checkout, once.  With no CUDA card, or
fewer than the cell needs, it exits 1 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        import repro_torch
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 1
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        print(f"repro_torch comes from {repro_torch.__file__}, not this checkout", file=sys.stderr)
        return 1
    from perfbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
