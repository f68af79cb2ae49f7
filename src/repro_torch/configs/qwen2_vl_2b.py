"""Qwen2-VL 2B — VLM decoder with M-RoPE and dynamic-resolution ViT frontend.

Source: [arXiv:2409.12191]: 28 layers, d_model=1536, 12 heads (GQA kv=2),
d_ff=8960, vocab=151936, QKV bias, M-RoPE rotary sections (t,h,w)=(16,24,24)
over the 64 rotary half-dims (head_dim=128).

The ViT/merger vision frontend is a STUB per the assignment carve-out:
the batch supplies precomputed patch embeddings of shape
(B, n_patches, d_model) which the decoder consumes prepended to the text
tokens, with 3-D (temporal, height, width) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        n_patches=256,  # stub: 16x16 patch grid per image
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        source="arXiv:2409.12191",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="qwen2-vl-2b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mrope_sections=(4, 6, 6),
        n_patches=16,  # 4x4 grid
    )
)
