"""Llama-4 Scout 17B-A16E — MoE decoder, 16 experts top-1 + shared expert.

Source: [hf:meta-llama/Llama-4-Scout-17B-16E]: 48 layers, d_model=5120,
40 heads (GQA kv=8), expert FFN hidden 8192, vocab=202048, MoE 16 experts
top-1 with one always-on shared expert per layer (early-fusion multimodal
in the public model; text backbone per the assignment).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        arch_type="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=16,
        n_shared_experts=1,
        top_k=1,
        d_expert=8192,
        capacity_factor=1.25,
        router_aux_coef=0.01,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=False,
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="llama4-scout-17b-a16e-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        d_expert=128,
        n_experts=4,
        n_shared_experts=1,
        top_k=1,
        vocab_size=512,
    )
)
