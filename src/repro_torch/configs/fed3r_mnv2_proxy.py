"""Paper-scale proxy backbone for FED3R experiments.

The paper uses an ImageNet-pretrained MobileNetV2 whose feature space is
d=1280.  Offline we cannot ship MobileNetV2 weights, so the FED3R-family
benchmarks use either (a) raw synthetic feature vectors of d=1280 (data-level
φ) or (b) this small dense transformer with d_model=1280 as a stand-in
extractor for the end-to-end FED3R+FT drivers.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="fed3r-mnv2-proxy",
        arch_type="dense",
        n_layers=6,
        d_model=1280,
        n_heads=10,
        n_kv_heads=10,
        head_dim=128,
        d_ff=3072,
        vocab_size=8192,
        mlp_type="gelu",
        norm_type="layernorm",
        tie_embeddings=True,
        source="paper proxy (MobileNetV2 feature dim d=1280)",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="fed3r-mnv2-proxy-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
)
