"""Command R+ 104B — dense GQA decoder, parallel attn+FFN blocks, no bias.

Source: [hf:CohereForAI/c4ai-command-r-v01] (scaled per assignment):
64 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000.
Cohere models use LayerNorm, tied embeddings, and the parallel-block
formulation x + attn(norm(x)) + mlp(norm(x)).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="command-r-plus-104b",
        arch_type="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256_000,
        qkv_bias=False,
        mlp_type="swiglu",
        norm_type="layernorm",
        tie_embeddings=True,
        parallel_block=True,
        rope_theta=8_000_000.0,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="command-r-plus-104b-smoke",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
    )
)
