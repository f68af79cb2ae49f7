"""Carry the reference package's parameters and caches over to the port.

:func:`params_from_jax` takes the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)`` on the reference side) and
returns the port's parameter dict on ``device``: the same names and
layouts (``lm_head``, Qwen2's ``bq``/``bk``/``bv`` included; an MoE layer's
``router``, ``(E, …)`` expert stacks and fused ``shared`` MLP), with the
stacked ``(n_layers, …)`` layer leaves sliced into a list of per-layer
dicts.  :func:`cache_from_jax` does the same for a KV ring cache, keeping
each leaf's dtype (bf16, fp32, int8, int32).  :func:`tree_from_jax` carries
a whole reference tree across — the FT params ``{"backbone", "head"}``,
the simulator's ``(M, W, bias)``, a ``ServerState`` — with a backbone's
stacked layers sliced as :func:`params_from_jax` slices them.  This is how
the tests make both packages compute the same function from the same
state.  It imports no jax: the input is numpy already.
"""
from __future__ import annotations

from typing import Any, List, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.federated.algorithms import ServerState
from repro_torch.federated.dist import resolve_device
from repro_torch.models.model import FAMILIES
from repro_torch.tree import tree_leaves


def _to_torch(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=dev)


def _take(tree: Any, i: int, axis: int = 0) -> Any:
    """Layer ``i`` of a stacked layer tree, the layer axis being ``axis``."""
    if isinstance(tree, dict):
        return {k: _take(v, i, axis) for k, v in tree.items()}
    return np.take(np.asarray(tree), i, axis=axis)


def _leaf(a: Any, dev: torch.device) -> torch.Tensor:
    # a copy: decode writes the port's cache in place
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(
    cfg: ModelConfig, params_np: dict, device: Union[str, torch.device] = "cuda"
) -> dict:
    """The reference's ``init_params`` pytree (numpy leaves) → port params."""
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_type!r} models: the port has the dense and MoE paths only")
    dev = resolve_device(device)
    out = {k: _to_torch(v, dev) for k, v in params_np.items() if k != "layers"}
    stacked = params_np["layers"]
    out["layers"] = [_to_torch(_take(stacked, i), dev) for i in range(cfg.n_layers)]
    return out


def cache_from_jax(
    cfg: ModelConfig, cache_np: dict, device: Union[str, torch.device] = "cuda"
) -> List[dict]:
    """The reference's stacked ring cache (numpy leaves, ``(n_layers, …)``) →
    the port's list of per-layer cache dicts, dtypes kept."""
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_type!r} caches: the port has the dense and MoE paths only")
    dev = resolve_device(device)
    return [{k: _leaf(np.asarray(v)[i], dev) for k, v in cache_np.items()}
            for i in range(cfg.n_layers)]


def _unstack(tree: Any, axis: int) -> List[Any]:
    """A stacked layer tree → a list of per-layer trees along ``axis``."""
    n = np.asarray(next(tree_leaves(tree))).shape[axis]
    return [_take(tree, i, axis) for i in range(n)]


def tree_from_jax(tree: Any, device: Union[str, torch.device] = "cuda") -> Any:
    """A reference tree with numpy leaves (``jax.tree.map(np.asarray, t)``)
    → the port's tree on ``device``, each leaf's dtype kept.

    A ``"layers"`` subtree of stacked ``(n_layers, …)`` leaves becomes the
    port's list of per-layer dicts; inside a ``ServerState``'s ``cvars``
    the layer axis follows the client axis.  NamedTuples become the port's
    :class:`~repro_torch.federated.algorithms.ServerState` when their
    fields are its fields, else dicts; ``None`` stays ``None``.
    """
    dev = resolve_device(device)

    def conv(t: Any, axis: int) -> Any:
        if t is None:
            return None
        if hasattr(t, "_fields"):
            fields = {f: conv(v, 1 if f == "cvars" else axis) for f, v in zip(t._fields, t)}
            return ServerState(**fields) if tuple(t._fields) == ServerState._fields else fields
        if isinstance(t, dict):
            return {k: [conv(layer, axis) for layer in _unstack(v, axis)] if k == "layers"
                    else conv(v, axis) for k, v in t.items()}
        return _leaf(t, dev)

    return conv(tree, 0)
