"""Partition specs, the ambient mesh the layers read, and cutting parameters
into a rank's blocks."""
