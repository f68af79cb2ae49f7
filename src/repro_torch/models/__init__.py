"""Backbones of the port in PyTorch: the dense, MoE, SSM, hybrid and VLM families."""
from repro_torch.models.model import (  # noqa: F401
    Model,
    build_model,
)
