"""The 95th percentile of the traced window's round times (host clock, from the
start of ``pack_client_shards`` to the round's statistics folded and
synchronised): the server's latency a round of uploads, inflated by the
profiler's host overhead, so a per-layer reading and not end to end."""
import numpy as np


def read(record):
    rounds = record["rounds"]
    return 1e3 * float(np.percentile([r["round_s"] for r in rounds], 95)) if rounds else None
