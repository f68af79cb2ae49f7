"""DeepSeekMoE 16B — fine-grained MoE: 2 shared + 64 routed experts, top-6.

Source: [arXiv:2401.06066]: 28 layers, d_model=2048, 16 heads (MHA: kv=16),
per-expert FFN hidden 1408, vocab=102400.  Every layer is MoE (the public
model keeps layer 0 dense; the assignment pins d_ff=1408 so we treat all
layers uniformly as MoE with 2 always-on shared experts of the same size).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102_400,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_expert=1408,
        capacity_factor=1.25,
        router_aux_coef=0.01,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=False,
        rope_theta=10_000.0,
        source="arXiv:2401.06066",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="deepseek-moe-16b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=96,
        d_expert=96,
        n_experts=4,
        n_shared_experts=1,
        top_k=2,
        vocab_size=512,
    )
)
