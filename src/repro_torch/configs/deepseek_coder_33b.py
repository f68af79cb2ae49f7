"""DeepSeek-Coder 33B — llama-architecture dense decoder.

Source: [arXiv:2401.14196]: 62 layers, d_model=7168, 56 heads (GQA kv=8),
d_ff=19200, vocab=32256, SwiGLU, RMSNorm, untied, rope theta 100000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-coder-33b",
        arch_type="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab_size=32_256,
        qkv_bias=False,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=False,
        rope_theta=100_000.0,
        source="arXiv:2401.14196",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="deepseek-coder-33b-smoke",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
    )
)
