"""Live rows over the rows packed and computed, over the window (entry and packing:
``data/pipeline.py::pack_client_shards``, ``federated/engine.py::AccumulationEngine``),
counted from the ``mask`` of each ``PackedClients`` the port returned."""


def read(record):
    rows = sum(r["rows"] for r in record["rounds"])
    return 100.0 * sum(r["live"] for r in record["rounds"]) / rows if rows else None
