"""Host time of ``data/pipeline.py::pack_client_shards`` a round: all the window's
packing time over its rounds (host clock)."""


def read(record):
    rounds = record["rounds"]
    return 1e3 * sum(r["pack_s"] for r in rounds) / len(rounds) if rounds else None
