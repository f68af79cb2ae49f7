"""The few pytree helpers the port needs in place of ``jax.tree``.

A tree is nested dicts, lists and tuples (NamedTuples included) with
tensor, array or number leaves; ``None`` is an empty subtree, as in JAX
(``torch.utils._pytree`` treats it as a leaf).  Dicts are walked in the
first tree's key order, so trees built in different insertion orders still
map together.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf across trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves in ``tree_map``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree
