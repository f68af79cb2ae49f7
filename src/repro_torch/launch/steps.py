"""Step functions of the backbones: train, classification loss, statistics,
prefill and decode.

The port of the reference's ``launch/steps.py``:

* ``train_step`` — one centralized SGD step (fwd + bwd + parameter update)
  with microbatching and mixed precision; the LM-pretraining shape.
  Frozen-subtree masks multiply gradients by a 0/1 tree.
* ``cls_per_example_loss`` — the classification objective of the FED3R+FT
  phase (backbone features → softmax head) in the per-example form the
  cohort round engine (:mod:`repro_torch.federated.round_engine`) consumes.
* ``fed3r_stats_step`` — the paper's statistics pass on the engine's core:
  backbone features → one ``fed3r_stats`` launch → (A, b) accumulation.
* ``prefill_step`` — forward + cache construction (KV rings, SSM and
  RG-LRU states; the attention through ``ops.flash_attention``, once an
  attention layer);
* ``decode_step`` — one token against the caches, updated in place.

PyTorch runs eagerly, so a step is a plain closure over the config (the
reference jits them) and hides nothing but that binding.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fed3r
from repro_torch.core.random_features import RFFParams, rff_map
from repro_torch.federated import engine as engine_lib
from repro_torch.federated.simulator import softmax_ce
from repro_torch.launch.mesh import data_axes
from repro_torch.models import model as model_lib
from repro_torch.tree import tree_map


def make_train_step(
    cfg: ModelConfig,
    lr: float = 1e-2,
    freeze: Optional[Any] = None,
    num_microbatches: int = 1,
) -> Callable:
    """(params, batch) -> (params', loss): local SGD with gradient
    accumulation and mixed precision.

    * ``num_microbatches`` splits the step's batch into M sequential
      microbatches — activation memory scales 1/M while the SGD update
      stays the mean of the microbatch gradients.
    * Mixed precision: the fp32 master params are cast ONCE a step to a
      bf16 compute copy; gradients are taken w.r.t. that copy (bf16, summed
      in bf16 across microbatches) and applied to the fp32 master.
    """
    grads_of = torch.func.grad_and_value(lambda pp, b: model_lib.lm_loss(cfg, pp, b))

    def train_step(params, batch):
        pc = tree_map(
            lambda p: p.to(torch.bfloat16) if p.is_floating_point() else p, params)
        if num_microbatches <= 1:
            grads, loss = grads_of(pc, batch)
        else:
            M = num_microbatches

            def split(a):
                if a.shape[0] % M:
                    raise ValueError(f"batch of {a.shape[0]} does not split into {M} microbatches")
                return a.reshape((M, a.shape[0] // M) + tuple(a.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), pc)
            losses = []
            for i in range(M):
                g, loss = grads_of(pc, {k: v[i] for k, v in mb.items()})
                grads = tree_map(lambda a, x: (a + x).to(a.dtype), grads, g)
                losses.append(loss)
            grads = tree_map(lambda g: g / M, grads)
            loss = torch.stack(losses).mean()
        if freeze is not None:
            grads = tree_map(lambda g, f: g * f, grads, freeze)
        params = tree_map(
            lambda p, g: (p - lr * g.to(torch.float32)).to(p.dtype), params, grads)
        return params, loss

    return train_step


def make_cls_per_example_loss(cfg: ModelConfig) -> Callable:
    """Per-example softmax-classification loss over backbone features.

    Params are ``{"backbone": ..., "head": {"W", "b"}}``; the batch is the
    round engine's ``{"x": tokens, "y": class labels, "mask": ...}`` dict.
    Returns ``(batch_size,)`` losses — masking/averaging happens inside the
    engine's ``local_update``, so padding rows contribute exactly nothing.
    """

    def per_example_loss(params, batch):
        feats = model_lib.extract_features(cfg, params["backbone"], {"tokens": batch["x"]})
        logits = feats @ params["head"]["W"] + params["head"]["b"]
        return softmax_ce(logits, batch["y"])

    return per_example_loss


def make_prefill_step(cfg: ModelConfig, cache_capacity: int) -> Callable:
    """(params, batch[, drops]) -> (last position's logits (B, V), caches);
    an MoE model adds its dropped entries to ``drops``."""

    def prefill_step(params, batch, drops=None):
        return model_lib.prefill(cfg, params, batch, cache_capacity, drops)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, caches, token (B, 1), pos) -> (logits (B, V), caches)."""

    def decode_step(params, cache, token, pos):
        return model_lib.decode_step(cfg, params, cache, token, pos)

    return decode_step


def make_fed3r_stats_step(
    cfg: ModelConfig,
    n_classes: int,
    rff_params: Optional[RFFParams] = None,
    *,
    aggregation: str = "merge",
    mesh: Any = None,
) -> Callable:
    """(params, stats, batch{tokens, class_labels[, mask]}) -> stats'.

    One statistics mini-round on the accumulation engine's core
    (:func:`repro_torch.federated.engine.shard_stats`): extract φ over the
    batch, optionally map through shared random features, accumulate A/b
    through one ``fed3r_stats`` launch.  An optional per-sample
    ``batch["mask"]`` supports packed batches (padding rows contribute
    exactly nothing).  ``aggregation`` is the engine's server backend:
    ``"merge"`` (the sum IS the aggregation); ``"psum"``: this rank's
    batch statistics all-reduced over the data axes of ``mesh`` before they
    fold into ``stats``.
    """
    axes = data_axes(mesh) if mesh is not None else ()

    @torch.no_grad()
    def stats_step(params, stats: fed3r.Fed3RStats, batch) -> fed3r.Fed3RStats:
        feats = model_lib.extract_features(cfg, params, batch)
        if rff_params is not None:
            feats = rff_map(rff_params, feats)
        new = engine_lib.shard_stats(feats, batch["class_labels"], n_classes, batch.get("mask"))
        return fed3r.merge(stats, engine_lib.aggregate(new, aggregation, axes, mesh))

    return stats_step
