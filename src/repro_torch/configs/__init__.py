"""Architecture configs of the PyTorch port.

Each module defines ``CONFIG`` (the configuration, with source citation) and
``REDUCED`` (a smoke-test variant of the same family) registered as
``<name>-smoke``.  The port carries the FED3R proxy backbone, the four
dense decoders (Qwen2-7B, Command R+, DeepSeek-Coder, Minitron) and the two
MoE decoders (DeepSeekMoE 16B, Llama-4 Scout); the reference's SSM,
hybrid, VLM and audio backbones are ported with their model families.
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
    "command_r_plus_104b",
    "minitron_8b",
    "deepseek_moe_16b",
    "qwen2_7b",
    "deepseek_coder_33b",
    "llama4_scout_17b_a16e",
    "fed3r_mnv2_proxy",
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
