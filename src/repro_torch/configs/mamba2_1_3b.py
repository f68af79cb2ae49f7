"""Mamba2 1.3B — attention-free state-space model with SSD.

Source: [arXiv:2405.21060]: 48 layers, d_model=2048, ssm_state=128,
vocab=50280.  d_inner = 2*d_model = 4096, headdim=64 -> 64 SSD heads,
ngroups=1, causal conv width 4, chunked SSD scan (chunk=256).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-1.3b",
        arch_type="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,  # unused for ssm
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_conv=4,
        ssm_ngroups=1,
        norm_type="rmsnorm",
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="mamba2-1.3b-smoke",
        n_layers=2,
        d_model=128,
        ssm_state=16,
        ssm_headdim=32,
        ssm_chunk=32,
        vocab_size=512,
    )
)
