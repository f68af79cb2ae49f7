"""Qwen2 7B — dense GQA decoder with QKV bias.

Source: [arXiv:2407.10671]: 28 layers, d_model=3584, 28 heads (GQA kv=4),
d_ff=18944, vocab=152064, QKV bias, SwiGLU, RMSNorm, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-7b",
        arch_type="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152_064,
        qkv_bias=True,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        source="arXiv:2407.10671",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="qwen2-7b-smoke",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
    )
)
