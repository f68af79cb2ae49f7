"""Data of the port: partitioners, synthetic generators, client packing."""
