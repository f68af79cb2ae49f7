"""Model facade of the decoder-only families: init / forward / loss / prefill / decode / features.

The port of the reference's ``models/model.py`` for ``arch_type`` "dense",
"moe", "ssm", "hybrid" and "vlm".  ``build_model(cfg)`` returns a
:class:`Model` of plain functions over a parameter dict:

    {"embed": {"embedding": (padded_vocab, d)},
     "final_norm": {...},
     "layers": [per-layer dict, ...]}

(an MoE layer holds ``"moe"`` where a dense one holds ``"mlp"``; an SSM
layer ``"ssm"``; a hybrid's layers are ``"rec"`` and ``"attn"`` blocks in
the order of ``cfg.pattern_for``) with the reference's names and layouts
(the reference's stacked ``(n_layers, …)`` leaves, and the hybrid's
super-block and remainder trees, are a list here;
:mod:`repro_torch.models.convert` turns one into the other).

Batch dict contract:
  * ``tokens``        (B, S) int — always present (decode: (B, 1));
  * ``labels``        (B, S) int — ``lm_loss`` (next-token targets);
  * ``patch_embeds``  (B, n_patches, d) — VLM only, prepended to the text
    outside decode (the stub vision frontend), with 3-D M-RoPE positions.

Caches are a list of per-layer dicts (``make_cache``): KV rings, SSM
states, RG-LRU states; decode updates them in place.  The forward returns
the MoE load-balance loss summed over the layers (0 for any other model),
which ``lm_loss`` adds at ``router_aux_coef``.  Audio models raise
``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.federated.dist import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    embed_apply,
    mrope_angles,
    norm_apply,
    norm_init,
    rope_angles,
    unembed_apply,
)
from repro_torch.tree import tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")  # the arch_types the port runs
_FAMILIES_LATER = "audio models are ROADMAP Queue 1 item 11"


class ForwardOut(NamedTuple):
    hidden: torch.Tensor  # (B, S, d) post-final-norm hidden states
    logits: Optional[torch.Tensor]
    cache: Optional[List[dict]] = None  # per-layer caches (prefill / decode)
    aux_loss: Optional[torch.Tensor] = None  # MoE load-balance scalar, fp32 (0 for dense)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_family(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet."""
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"{what} of a {cfg.arch_type!r} model: the port runs the {', '.join(FAMILIES)} "
            f"families ({_FAMILIES_LATER})")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn on the generator's device."""
    check_family(cfg, "models")
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
    if cfg.arch_type == "hybrid":
        params["layers"] = tfm.hybrid_init(gen, cfg)
    else:
        kind = "ssm" if cfg.arch_type == "ssm" else "attn"
        params["layers"] = tfm.stacked_block_init(gen, cfg, kind, cfg.n_layers)
    return params


def vlm_positions_3d(cfg: ModelConfig, seq_idx: torch.Tensor) -> torch.Tensor:
    """Map flat sequence indices to Qwen2-VL (t, h, w) M-RoPE positions, (3, S).

    Image tokens occupy indices [0, n_patches) on a g×g grid with t = 0;
    a text token at index i ≥ n_patches gets ``g + (i − n_patches)`` in all
    three streams (text positions continue after the spatial extent).
    """
    g = int(round(cfg.n_patches ** 0.5))
    is_img = seq_idx < cfg.n_patches
    text = g + (seq_idx - cfg.n_patches)
    t = torch.where(is_img, 0, text)
    h = torch.where(is_img, seq_idx // g, text)
    w = torch.where(is_img, seq_idx % g, text)
    return torch.stack([t, h, w], dim=0)


def _angles_for(cfg: ModelConfig, seq_idx: torch.Tensor) -> Optional[torch.Tensor]:
    """Rotary angles for a run of sequence indices (S,): None for an SSM."""
    if cfg.arch_type == "ssm":
        return None
    if cfg.arch_type == "vlm":
        return mrope_angles(vlm_positions_3d(cfg, seq_idx), cfg.hd, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(seq_idx, cfg.hd, cfg.rope_theta)


def forward(
    cfg: ModelConfig,
    params: dict,
    batch: Dict[str, torch.Tensor],
    *,
    mode: str = "train",
    cache: Optional[List[dict]] = None,
    decode_pos: Optional[int] = None,
    cache_capacity: Optional[int] = None,
    return_logits: bool = True,
    drops: Optional[moe_mod.DropTally] = None,
) -> ForwardOut:
    """The forward in ``mode`` "train" (also the feature pass),
    "prefill" (returns the filled caches) or "decode" (one token at absolute
    position ``decode_pos``; ``cache`` is updated in place and returned).
    A VLM's ``batch["patch_embeds"]`` precede its text outside decode, and
    its decode positions count them.  ``drops`` sums the entries the MoE
    layers' capacity dropped."""
    check_family(cfg, "forward")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    dtype = compute_dtype(cfg)
    x = embed_apply(params["embed"], batch["tokens"], dtype)
    if cfg.arch_type == "hybrid":
        # gemma-style scaling by √d rounded to the compute dtype first (the
        # reference's jnp.asarray(d ** 0.5, dtype)); a Python scalar, so no
        # host-to-device copy
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device="cpu").item()
    if cfg.arch_type == "vlm" and mode != "decode":
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    S = x.shape[1]
    if mode == "decode":
        if decode_pos is None:
            raise ValueError("decode needs decode_pos")
        decode_pos = int(decode_pos)
        seq_idx = torch.full((1,), decode_pos, device=x.device)
    else:
        seq_idx = torch.arange(S, device=x.device)
    angles = _angles_for(cfg, seq_idx)

    window = cfg.sliding_window
    capacity = cache_capacity
    if capacity is not None and window is not None:
        capacity = min(capacity, window)
    if cfg.arch_type == "hybrid":
        h, new_cache, aux = tfm.apply_hybrid(
            cfg, params["layers"], x, angles=angles, mode=mode, cache=cache,
            decode_pos=decode_pos,
            cache_capacity=min(capacity, cfg.local_window) if capacity else None,
        )
    else:
        kind = "ssm" if cfg.arch_type == "ssm" else "attn"
        h, new_cache, aux = tfm.apply_stack(
            cfg, kind, params["layers"], x, angles=angles, window=window, mode=mode,
            cache=cache, decode_pos=decode_pos, cache_capacity=capacity, drops=drops,
        )
    h = norm_apply(cfg, params["final_norm"], h)
    logits = unembed_apply(cfg, params, h) if return_logits else None
    return ForwardOut(h, logits, new_cache, aux)


def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: Union[str, torch.device] = "cuda") -> List[dict]:
    """Empty per-layer caches: KV rings of ``capacity`` slots (clamped to the
    sliding window; a hybrid's to its local window), SSM or RG-LRU states."""
    check_family(cfg, "caches")
    dtype, dev = compute_dtype(cfg), resolve_device(device)
    if cfg.sliding_window is not None:
        capacity = min(capacity, cfg.sliding_window)
    if cfg.arch_type == "ssm":
        return tfm.stacked_ssm_cache(cfg, cfg.n_layers, batch, dtype, dev)
    if cfg.arch_type == "hybrid":
        return tfm.hybrid_cache(cfg, batch, min(capacity, cfg.local_window), dtype, dev)
    return tfm.stacked_attn_cache(cfg, cfg.n_layers, batch, capacity, dtype, dev)


def prefill(
    cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor], cache_capacity: int,
    drops: Optional[moe_mod.DropTally] = None,
) -> Tuple[torch.Tensor, List[dict]]:
    """(last position's logits (B, V), the filled caches); ``drops`` sums
    the entries the MoE layers' capacity dropped."""
    out = forward(
        cfg, params, batch, mode="prefill", cache_capacity=cache_capacity,
        return_logits=False,  # unembed only the last position (B·V, not B·S·V)
        drops=drops,
    )
    logits = unembed_apply(cfg, params, out.hidden[:, -1:, :])
    return logits[:, 0, :], out.cache


def decode_step(
    cfg: ModelConfig,
    params: dict,
    cache: List[dict],
    token: torch.Tensor,  # (B, 1) int
    pos: int,  # absolute position of this token
) -> Tuple[torch.Tensor, List[dict]]:
    """(this token's logits (B, V), the caches, updated in place)."""
    out = forward(cfg, params, {"tokens": token}, mode="decode", cache=cache, decode_pos=pos)
    return out.logits[:, 0, :], out.cache


def lm_loss(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy, fp32 log-softmax (``batch["labels"]``
    (B, S) int, over a VLM's text positions), plus ``router_aux_coef`` times
    the MoE load-balance loss."""
    out = forward(cfg, params, batch, mode="train")
    logits = out.logits.to(torch.float32)
    if cfg.arch_type == "vlm":  # logits cover [patches | text]; labels cover text
        logits = logits[:, cfg.n_patches:, :]
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    return (lse - picked).mean() + cfg.router_aux_coef * out.aux_loss


def extract_features(
    cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """φ(x): pooled final hidden state, (B, d_feat) fp32 — the FED3R feature
    map (a VLM pools its text positions only)."""
    h = forward(cfg, params, batch, mode="train", return_logits=False).hidden
    h = h.to(torch.float32)
    if cfg.arch_type == "vlm":
        h = h[:, cfg.n_patches:, :]
    if cfg.feature_pooling == "last":
        return h[:, -1, :]
    return h.mean(dim=1)


class Model:
    """Bound function bundle for one architecture config."""

    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        self.cfg = cfg
        self.forward = functools.partial(forward, cfg)
        self.loss = functools.partial(lm_loss, cfg)
        self.extract_features = functools.partial(extract_features, cfg)
        self.prefill = functools.partial(prefill, cfg)
        self.decode_step = functools.partial(decode_step, cfg)
        self.make_cache = functools.partial(make_cache, cfg)

    def init(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> dict:
        """Random parameters from ``seed``, drawn on ``device``."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return init_params(self.cfg, gen)

    @staticmethod
    def param_count(params) -> int:
        return sum(t.numel() for t in tree_leaves(params))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
