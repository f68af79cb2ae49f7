"""Architecture configs of the PyTorch port.

Each module defines ``CONFIG`` (the configuration, with source citation) and
``REDUCED`` (a smoke-test variant of the same family) registered as
``<name>-smoke``.  The port carries the FED3R proxy backbone and Qwen2-7B
(the dense serving path); the reference's other backbones are ported with
their model families.
"""
from repro_torch.configs.base import (  # noqa: F401
    Fed3RConfig,
    FederatedConfig,
    ModelConfig,
    get_config,
    list_configs,
    register,
)

ARCH_MODULES = [
    "fed3r_mnv2_proxy",
    "qwen2_7b",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    import importlib

    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
