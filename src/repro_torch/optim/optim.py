"""Optimizers as pure transforms over trees of tensors (no external deps).

The port of the reference's ``optim/optim.py``: SGD (momentum, decoupled
weight decay) and AdamW as ``init`` / ``update`` pairs, where ``update``
maps (grads, state, params, lr) to (updates, new state) and
:func:`apply_updates` adds the updates to the params.  Nothing is updated
in place.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class OptimizerSpec(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, new_state)


# ---------------------------------------------------------------------------
# SGD (+ momentum, + decoupled weight decay)
# ---------------------------------------------------------------------------


def sgd_init(params, momentum: float = 0.0):
    if momentum == 0.0:
        return {}
    return {"mu": tree_map(torch.zeros_like, params)}


def sgd_update(grads, state, params, lr, *, momentum: float = 0.0, weight_decay: float = 0.0):
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    if momentum:
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        updates = tree_map(lambda m: -lr * m, mu)
        return updates, {"mu": mu}
    return tree_map(lambda g: -lr * g, grads), state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    leaf = next(tree_leaves(params))
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "t": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def adamw_update(
    grads, state, params, lr, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0
):
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.square(), state["v"], grads)
    tc = t.to(torch.float32)
    bc1 = 1 - b1**tc
    bc2 = 1 - b2**tc

    def upd(m_, v_, p):
        step = m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
        return -lr * (step + weight_decay * p)

    updates = tree_map(upd, m, v, params)
    return updates, {"m": m, "v": v, "t": t}


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_optimizer(
    name: str,
    *,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
) -> OptimizerSpec:
    if name == "sgd":
        return OptimizerSpec(
            init=functools.partial(sgd_init, momentum=momentum),
            update=functools.partial(
                sgd_update, momentum=momentum, weight_decay=weight_decay
            ),
        )
    if name == "adamw":
        return OptimizerSpec(
            init=adamw_init,
            update=functools.partial(adamw_update, weight_decay=weight_decay),
        )
    raise ValueError(name)

