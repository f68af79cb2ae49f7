"""The whole step's share of the card's peak: the FLOPs the window's live samples
need (the family's ``sample_flops``: the feature pass and the statistics; padding
and recomputation not counted), over the window and the data sheet's peak in the
configuration's compute type."""
from perfbench import yardstick


def read(record):
    peak = yardstick.PEAK_FLOPS[record["config"]["compute_dtype"]]
    flops = record["samples"] * record["sample_flops"]
    return 100.0 * flops / (record["window_s"] * peak) if flops else None
