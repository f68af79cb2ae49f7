"""Configuration system of the PyTorch port (a copy of the reference's).

Every architecture is described by a single frozen ``ModelConfig``
dataclass.  Configs are plain data — importing a config module imports no
framework and touches no device.  The fields are the reference package's,
unchanged, so one config means the same model in both packages; the port's
model code reads the dense-path fields only (``models/``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Complete architectural description of one backbone.

    The same dataclass covers all six architecture families (dense / moe /
    ssm / hybrid / vlm / audio); family-specific fields default to inert
    values so that dense configs stay small.
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation for the config numbers

    # --- attention ---------------------------------------------------------
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    parallel_block: bool = False  # Command-R style parallel attn+FFN
    attn_logit_softcap: Optional[float] = None

    # --- MLP ---------------------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0  # per-expert FFN hidden size (d_ff used for shared/dense)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    moe_every: int = 1  # MoE layer every N layers (1 = all layers MoE)

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (RecurrentGemma / Griffin) ----------------------------------
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 2048

    # --- VLM (Qwen2-VL) ------------------------------------------------------
    mrope_sections: Tuple[int, ...] = ()  # rotary dim split (t, h, w)
    n_patches: int = 0  # stub image tokens prepended per example

    # --- audio enc-dec (Whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 0  # stub conv-frontend output frames
    n_positions: int = 32_768  # learned-position table size (enc-dec decoder)

    # --- numerics / structure -----------------------------------------------
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    # Block remat: checkpoint only every Nth layer boundary; the backward
    # pass recomputes within a block.  Cuts saved-activation memory ~N×
    # for deep/wide models (command-r: 64 × 100MB saves -> 8 × 100MB).
    remat_block_size: int = 1
    # Sequence parallelism: shard the residual stream's seq dim over the TP
    # axis (Korthikanti et al.).  Opt-in: helps wide models whose per-layer
    # remat saves dominate; hurts row-parallel-fallback archs.
    sequence_parallel: bool = False
    scan_layers: bool = True
    attn_impl: str = "xla"  # xla | flash (pallas); read by no model code

    # int8 KV cache (symmetric per-token-per-head scales): 2× decode-memory
    # reduction for cache-resident serving (EXPERIMENTS.md §Perf).
    kv_cache_quant: bool = False

    # --- FED3R feature head ---------------------------------------------------
    feature_pooling: str = "mean"  # mean | last
    feature_dim: Optional[int] = None  # defaults to d_model

    # Embedding/classifier tables are padded to a multiple of this so the
    # vocab dim shards evenly on any power-of-two mesh axis (standard
    # practice; padded logit columns are masked to -inf in unembed_apply).
    vocab_pad_to: int = 128

    # ------------------------------------------------------------------ utils
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_feat(self) -> int:
        return self.feature_dim if self.feature_dim is not None else self.d_model

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def pattern_for(self, n_layers: int) -> Tuple[str, ...]:
        """Expand ``block_pattern`` to an explicit per-layer type list."""
        if not self.block_pattern:
            base = {"ssm": "ssm"}.get(self.arch_type, "attn")
            return tuple(base for _ in range(n_layers))
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Number of homogeneous scan "super blocks" and unrolled remainder layers
    # for hybrid patterns (scan requires homogeneous carry structure).
    @property
    def n_superblocks(self) -> int:
        if not self.block_pattern:
            return self.n_layers
        return self.n_layers // len(self.block_pattern)

    @property
    def n_remainder_layers(self) -> int:
        if not self.block_pattern:
            return 0
        return self.n_layers % len(self.block_pattern)

    def validate(self) -> None:
        assert self.arch_type in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"), self.arch_type
        if self.arch_type != "ssm":
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA requires n_heads % n_kv_heads == 0"
        if self.arch_type == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.arch_type == "ssm":
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_headdim == 0
        if self.arch_type == "hybrid":
            assert self.lru_width > 0 and self.block_pattern
        if self.arch_type == "audio":
            assert self.is_encoder_decoder and self.n_audio_frames > 0
        if self.arch_type == "vlm":
            assert self.mrope_sections and self.n_patches > 0


# ---------------------------------------------------------------------------
# FED3R configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fed3RConfig:
    """Hyper-parameters of the paper's technique (Sections 4.1-4.4)."""

    ridge_lambda: float = 0.01  # Tikhonov λ (paper App. C: λ = 0.01)
    n_classes: int = 1000
    normalize_classifier: bool = True  # W*_c <- W*_c / ||W*_c||
    # Random features (FED3R-RF): 0 disables the RFF map.
    n_random_features: int = 0
    rff_sigma: float = 1000.0  # paper App. C: σ = 1000 (RBF)
    # FT phase
    softmax_temperature: float = 0.1  # paper App. C / Fig. 7
    ft_strategy: str = "feat"  # full | lp | feat
    stats_dtype: str = "float32"

    @property
    def stats_dim(self) -> int:
        """Dimensionality of the RR statistics space (d or D)."""
        return self.n_random_features if self.n_random_features > 0 else 0


# ---------------------------------------------------------------------------
# Federated-simulation configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FederatedConfig:
    n_clients: int = 100
    clients_per_round: int = 10
    n_rounds: int = 50
    local_epochs: int = 1
    local_batch_size: int = 50
    client_lr: float = 0.1
    client_weight_decay: float = 4e-5
    server_lr: float = 1.0
    server_momentum: float = 0.0
    algorithm: str = "fedavg"  # fedavg | fedavgm | fedprox | scaffold
    prox_mu: float = 0.01
    sample_with_replacement: bool = False
    dirichlet_alpha: float = 0.0  # 0 => one-class-per-client (most heterogeneous)
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # Lazy-import the per-arch modules on first lookup.
        from repro_torch import configs as _c  # noqa: F401

        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _c

    _c.load_all()
    return sorted(_REGISTRY)
