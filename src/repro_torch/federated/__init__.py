"""Federated runtime of the port: engine, drivers, sampling, telemetry.

Import the submodules directly (``repro_torch.federated.engine``, ...).
"""
