"""Whisper large-v3 — encoder-decoder audio model (transformer backbone only).

Source: [arXiv:2212.04356]: 32 encoder + 32 decoder layers, d_model=1280,
20 heads (MHA: kv=20), d_ff=5120, vocab=51866, GELU MLP, LayerNorm,
learned decoder positions, sinusoidal encoder positions.

The mel-spectrogram + conv1d feature frontend is a STUB per the assignment
carve-out: the batch supplies precomputed frame embeddings of shape
(B, 1500, d_model) (``batch["audio_frames"]``; ``launch/shapes.py``'s
``input_specs``) directly to the encoder stack.  ``n_positions`` stays the
base default (32768 learned decoder positions), as in the reference.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        arch_type="audio",
        n_layers=32,  # decoder layers
        n_encoder_layers=32,
        is_encoder_decoder=True,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51_866,
        n_audio_frames=1500,
        qkv_bias=True,
        mlp_type="gelu",
        norm_type="layernorm",
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )
)

REDUCED = register(
    CONFIG.replace(
        name="whisper-large-v3-smoke",
        n_layers=2,
        n_encoder_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_audio_frames=32,
    )
)
