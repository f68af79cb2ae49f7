"""RecurrentGemma 9B — Griffin hybrid: RG-LRU recurrent blocks + local attention.

Source: [arXiv:2402.19427]: 38 layers, d_model=4096, 16 heads (MQA kv=1),
d_ff=12288, vocab=256000, block pattern (rec, rec, attn) — i.e. local
attention every third layer — local window 2048, lru_width=4096.

38 = 12 x (rec, rec, attn) + 2 remainder rec layers: the reference stacks 12
homogeneous super-blocks and unrolls the 2 remainder layers; the port runs
the 38 layers as one list in layer order (see models/transformer.py).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        block_pattern=("rec", "rec", "attn"),
        lru_width=4096,
        local_window=2048,
        mlp_type="geglu",
        norm_type="rmsnorm",
        tie_embeddings=True,
        rope_theta=10_000.0,
        source="arXiv:2402.19427",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="recurrentgemma-9b-smoke",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        lru_width=128,
        local_window=32,
        vocab_size=512,
    )
)
