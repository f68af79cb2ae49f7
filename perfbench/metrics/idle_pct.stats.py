"""The share of the traced window in which no operation ran on the card, from the
profiler's device timeline."""


def read(record):
    if "busy_s" not in record:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["trace_window_s"])
