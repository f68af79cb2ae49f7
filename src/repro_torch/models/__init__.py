"""Backbones of the port: the dense transformer path in PyTorch."""
from repro_torch.models.model import (  # noqa: F401
    Model,
    build_model,
)
