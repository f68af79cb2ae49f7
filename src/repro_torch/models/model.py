"""Model facade of the dense path: init / forward / extract_features.

The port of the reference's ``models/model.py``.  ``build_model(cfg)``
returns a :class:`Model` of plain functions over a parameter dict:

    {"embed": {"embedding": (padded_vocab, d)},
     "final_norm": {...},
     "layers": [per-layer dict, ...]}

with the reference's names and layouts (the reference's stacked
``(n_layers, …)`` leaves are a list here; :mod:`repro_torch.models.convert`
turns one into the other).

Batch dict contract: ``tokens`` (B, S) int — always present.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.federated.dist import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_apply, norm_apply, norm_init, rope_angles, unembed_apply

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


class ForwardOut(NamedTuple):
    hidden: torch.Tensor  # (B, S, d) post-final-norm hidden states
    logits: Optional[torch.Tensor]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn on the generator's device."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"{cfg.arch_type!r} models: the port has the dense path only")
    params: Dict[str, Any] = {
        "embed": {
            "embedding": 0.02 * torch.randn(
                (cfg.padded_vocab, cfg.d_model), generator=gen, device=gen.device
            )
        },
        "final_norm": norm_init(cfg, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "kernel": 0.02 * torch.randn(
                (cfg.d_model, cfg.padded_vocab), generator=gen, device=gen.device
            )
        }
    params["layers"] = tfm.stacked_block_init(gen, cfg, "attn", cfg.n_layers)
    return params


def forward(
    cfg: ModelConfig,
    params: dict,
    batch: Dict[str, torch.Tensor],
    *,
    mode: str = "train",
    return_logits: bool = True,
) -> ForwardOut:
    if cfg.arch_type != "dense" or mode != "train":
        raise NotImplementedError(
            f"forward of a {cfg.arch_type!r} model in mode {mode!r}: the port has "
            "the dense train/feature path only"
        )
    x = embed_apply(params["embed"], batch["tokens"], compute_dtype(cfg))
    S = x.shape[1]
    angles = rope_angles(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    h = tfm.apply_stack(
        cfg, "attn", params["layers"], x, angles=angles, window=cfg.sliding_window, mode=mode
    )
    h = norm_apply(cfg, params["final_norm"], h)
    logits = unembed_apply(cfg, params, h) if return_logits else None
    return ForwardOut(h, logits)


def extract_features(
    cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """φ(x): pooled final hidden state, (B, d_feat) fp32 — the FED3R feature map."""
    h = forward(cfg, params, batch, mode="train", return_logits=False).hidden
    h = h.to(torch.float32)
    if cfg.feature_pooling == "last":
        return h[:, -1, :]
    return h.mean(dim=1)


class Model:
    """Bound function bundle for one architecture config."""

    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        self.cfg = cfg
        self.forward = functools.partial(forward, cfg)
        self.extract_features = functools.partial(extract_features, cfg)

    def init(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> dict:
        """Random parameters from ``seed``, drawn on ``device``."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return init_params(self.cfg, gen)

    @staticmethod
    def param_count(params) -> int:
        return sum(t.numel() for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
