"""(shape, dtype) input specs for every (architecture × input shape).

The port of the reference's ``launch/shapes.py``.  ``input_specs(cfg,
shape)`` returns :class:`TensorSpec` stand-ins (no tensor is allocated)
for the step function that the shape's kind runs:

  train_4k     -> train_step   {tokens, labels [, patch_embeds | audio_frames]}
  prefill_32k  -> prefill_step {tokens [, patch_embeds | audio_frames]}
  decode_32k   -> decode_step  {token, pos, cache}
  long_500k    -> decode_step  (sub-quadratic archs; dense archs use the
                                sliding-window variant — see variant_for)

For VLM the text length is ``seq_len − n_patches`` so the total processed
sequence equals the assigned seq_len exactly; for audio the encoder frames
are the stub frontend's output (B, 1500, d) and seq_len applies to the
decoder tokens.  The decode cache is the port's: one tree a layer
(``models/model.py::make_cache``), each leaf the reference's stacked leaf
without its leading ``n_layers``; ``pos`` stands for the Python int the
port's decode step takes.

:func:`abstract_params` and the decode caches run the port's own init and
cache code under :class:`_OnMeta`, which puts every tensor it makes on the
meta device (shapes and dtypes, no storage) and skips the random draws:
the counterpart of ``jax.eval_shape``, so a 104 B-parameter config is
counted on any host.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.tree import tree_map

# Sliding-window width used for the long_500k variant of full-attention archs.
LONG_CONTEXT_WINDOW = 8192

# Archs that cannot run long_500k at all (full-attn enc-dec decoder; the
# cross-attention source is fixed 1500 frames and a 500k autoregressive
# transcript has no modeling meaning).
LONG_500K_SKIPS = ("whisper-large-v3",)

# Archs that are natively sub-quadratic (no variant needed for long_500k).
NATIVE_SUBQUADRATIC = ("mamba2-1.3b", "recurrentgemma-9b")


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


class _OnMeta(TorchFunctionMode):
    """Every factory call lands on the meta device and draws nothing; an
    in-place truncated-normal fill (a data-dependent rejection loop) keeps
    its meta tensor as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.init.trunc_normal_:
            return args[0]
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def _specs(tree: Any) -> Any:
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def variant_for(cfg: ModelConfig, shape: ShapeConfig) -> Optional[ModelConfig]:
    """Config actually run for (arch, shape); None => skip (documented)."""
    if shape.name != "long_500k":
        return cfg
    if cfg.name in LONG_500K_SKIPS:
        return None
    if cfg.arch_type in ("ssm", "hybrid"):
        return cfg  # natively sub-quadratic decode
    # dense/moe/vlm: sliding-window variant (ring-buffer KV cache)
    return cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)


def _tok(b: int, s: int) -> TensorSpec:
    return TensorSpec((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract inputs for the step run by ``shape.kind``."""
    B, S = shape.global_batch, shape.seq_len
    dt = model_lib.compute_dtype(cfg)

    if shape.kind in ("train", "prefill"):
        text = S - cfg.n_patches if cfg.arch_type == "vlm" else S
        specs: Dict[str, Any] = {"tokens": _tok(B, text)}
        if shape.kind == "train":
            specs["labels"] = _tok(B, text)
        if cfg.arch_type == "vlm":
            specs["patch_embeds"] = TensorSpec((B, cfg.n_patches, cfg.d_model), dt)
        elif cfg.arch_type == "audio":
            specs["audio_frames"] = TensorSpec((B, cfg.n_audio_frames, cfg.d_model), dt)
        return {"batch": specs}

    if shape.kind == "decode":
        with _OnMeta():
            cache = model_lib.make_cache(cfg, B, S, device="cpu")
        return {"cache": _specs(cache), "token": _tok(B, 1), "pos": TensorSpec((), torch.int32)}

    raise ValueError(shape.kind)


def abstract_params(cfg: ModelConfig) -> Any:
    """The port's full parameter tree on the meta device (no allocation)."""
    with _OnMeta():
        return model_lib.init_params(cfg, torch.Generator())
