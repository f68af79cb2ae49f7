"""Device time of a closed-form solve (``core/fed3r.py::solve``): CUDA events
around each solve of the window, their total over their count."""


def read(record):
    spans = record["spans_ms"].get("solve")
    return sum(spans) / len(spans) if spans else None
