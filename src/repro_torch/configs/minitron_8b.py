"""Minitron 8B — width-pruned Nemotron-4 15B dense decoder.

Source: [arXiv:2407.14679]: 32 layers, d_model=4096, 32 heads (GQA kv=8),
d_ff=16384, vocab=256000.  Nemotron family uses squared-ReLU (non-gated)
MLPs; we model that with the non-gated ``gelu`` MLP type, LayerNorm-1p ≈
layernorm, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minitron-8b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256_000,
        qkv_bias=False,
        mlp_type="gelu",
        norm_type="layernorm",
        tie_embeddings=False,
        rope_theta=10_000.0,
        source="arXiv:2407.14679",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="minitron-8b-smoke",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
    )
)
