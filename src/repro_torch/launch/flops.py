"""Analytic MODEL_FLOPS (6·N·D family) for the roofline usefulness ratio.

The port of the reference's ``launch/flops.py``, over the port's parameter
trees: pass :func:`repro_torch.launch.shapes.abstract_params` (the
parameters on the meta device: shapes, no storage) or real parameters.
The counts equal the reference's for every config, including its count of
an encoder-decoder: every backbone parameter, the encoder's too, times the
decoder tokens (Whisper's 1500 frames a clip are not counted apart).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tree import tree_leaves


def param_breakdown(cfg: ModelConfig, abstract_params: Any) -> Dict[str, float]:
    total = sum(float(t.numel()) for t in tree_leaves(abstract_params))
    embed = cfg.padded_vocab * cfg.d_model
    lm_head = 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model
    dec_pos = cfg.n_positions * cfg.d_model if cfg.arch_type == "audio" else 0
    backbone = total - embed - lm_head - dec_pos

    inactive = 0.0
    if cfg.arch_type == "moe":
        per_expert = 3 * cfg.d_model * cfg.d_expert  # swiglu expert
        inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return {
        "total": total,
        "backbone": backbone,
        "backbone_active": backbone - inactive,
        "embed": embed + lm_head + dec_pos,
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig, abstract_params: Any) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference) + unembedding matmul."""
    pb = param_breakdown(cfg, abstract_params)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    head = mult * cfg.d_model * cfg.vocab_size * (
        tokens if shape.kind != "prefill" else shape.global_batch
    )  # prefill emits last-position logits only
    return mult * pb["backbone_active"] * tokens + head
