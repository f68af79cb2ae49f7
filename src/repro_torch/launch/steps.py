"""Step functions of the dense serving path.

The port of the reference's ``launch/steps.py`` for inference:

* ``prefill_step`` — forward + KV ring-cache construction (the attention
  through ``ops.flash_attention``, once a layer);
* ``decode_step`` — one token against the caches, updated in place.

PyTorch runs eagerly, so a step is a plain closure over the config (the
reference jits them) and hides nothing but that binding.  The module stays
so that the port keeps the reference's layout: ``launch/serve.py`` takes
its steps from here, as the reference's does, and the train step joins
them here.  ``make_train_step``, the classification loss and the statistics
step wait for the gradient path (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


def make_prefill_step(cfg: ModelConfig, cache_capacity: int) -> Callable:
    """(params, batch) -> (last position's logits (B, V), caches)."""

    def prefill_step(params, batch):
        return model_lib.prefill(cfg, params, batch, cache_capacity)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, caches, token (B, 1), pos) -> (logits (B, V), caches)."""

    def decode_step(params, cache, token, pos):
        return model_lib.decode_step(cfg, params, cache, token, pos)

    return decode_step
