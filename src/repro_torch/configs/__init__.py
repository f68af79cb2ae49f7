"""Architecture configs of the PyTorch port.

Each module defines ``CONFIG`` (the configuration, with source citation) and
``REDUCED`` (a smoke-test variant of the same family) registered as
``<name>-smoke``.  The port carries the FED3R proxy backbone, the four
dense decoders (Qwen2-7B, Command R+, DeepSeek-Coder, Minitron), the two
MoE decoders (DeepSeekMoE 16B, Llama-4 Scout), the SSM (Mamba2 1.3B), the
hybrid (RecurrentGemma 9B), the VLM (Qwen2-VL 2B) and the audio
encoder-decoder (Whisper large-v3): every config of the reference.
``ASSIGNED_ARCHS`` lists the ten assigned architectures, as the
reference's does.
"""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    Fed3RConfig,
    FederatedConfig,
    ModelConfig,
    ShapeConfig,
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
    "mamba2_1_3b",
    "recurrentgemma_9b",
    "qwen2_vl_2b",
    "whisper_large_v3",
]

ASSIGNED_ARCHS = [
    "command-r-plus-104b",
    "minitron-8b",
    "deepseek-moe-16b",
    "qwen2-vl-2b",
    "mamba2-1.3b",
    "recurrentgemma-9b",
    "qwen2-7b",
    "deepseek-coder-33b",
    "llama4-scout-17b-a16e",
    "whisper-large-v3",
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
