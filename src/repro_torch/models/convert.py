"""Carry the reference package's parameters over to the port.

:func:`params_from_jax` takes the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)`` on the reference side) and
returns the port's parameter dict on ``device``: the same names and
layouts, with the stacked ``(n_layers, …)`` layer leaves sliced into a list
of per-layer dicts.  This is how the tests make both packages compute the
same function.  It imports no jax: the input is numpy already.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.federated.dist import resolve_device


def _to_torch(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=dev)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(
    cfg: ModelConfig, params_np: dict, device: Union[str, torch.device] = "cuda"
) -> dict:
    """The reference's ``init_params`` pytree (numpy leaves) → port params."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"{cfg.arch_type!r} models: the port has the dense path only")
    dev = resolve_device(device)
    out = {k: _to_torch(v, dev) for k, v in params_np.items() if k != "layers"}
    stacked = params_np["layers"]
    out["layers"] = [_to_torch(_layer(stacked, i), dev) for i in range(cfg.n_layers)]
    return out
