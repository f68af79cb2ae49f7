"""Block specs of the dist layer: which block of an array a rank holds.

The port's counterpart of the reference's ``sharding/specs.py``, cut to the
distributed engines' specs.  The reference hands whole arrays to a
``shard_map`` program with a ``PartitionSpec`` per argument; the port runs
one process a rank, so a spec here is the rule that picks the rank's
contiguous block of one axis (:meth:`BlockSpec.block`), and a replicated
spec picks the whole array.  Every engine's packed arrays use
:func:`data_parallel_spec`: the batch-carrying axis — shards for the
statistics engine, cohort for rounds, personalization and the async slot
ring, wave width for the stream — split over the data axes in row-major
order of the axes, so on ``("pod", "data")`` a pod's ranks hold
neighbouring blocks and the intra-pod stage of the psum reduces them first.

The reference's ``sharding/hints.py`` ``"batch"`` token (a sharding
constraint inside a program) needs no counterpart: each rank already holds
only its block.  ``sharding/compat.py`` is a shim over JAX versions.  The
model-parallel rules (``param_specs``, ``batch_specs``, ``cache_specs``)
come with tensor parallelism, ROADMAP Queue 1 item 13; :func:`stats_specs`
row-shards the statistics over ``"model"``, which is always 1 in the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class BlockSpec:
    """Split dim ``axis`` over the mesh axes ``axes`` (``()``: replicated)."""

    axes: Tuple[str, ...] = ()
    axis: int = 0

    def block(self, x: T, index: int, count: int) -> T:
        """Block ``index`` of ``count`` equal contiguous blocks of dim
        ``axis`` (a view; ``x`` itself when replicated)."""
        if not self.axes:
            return x
        size = x.shape[self.axis]
        if size % count:
            raise ValueError(
                f"axis {self.axis} of size {size} does not split over {count} data "
                "shards: pack with mesh= (or num_shards=) so it divides"
            )
        k = size // count
        index_ = (slice(None),) * self.axis + (slice(index * k, (index + 1) * k),)
        return x[index_]


def replicated() -> BlockSpec:
    """Every rank holds the whole array: carried state, parameters, and the
    all-reduced outputs."""
    return BlockSpec()


def data_parallel_spec(axes: Sequence[str], axis: int = 0) -> BlockSpec:
    """Split dim ``axis`` over the (possibly several) data axes."""
    axes = tuple(axes)
    if not axes:
        raise ValueError("data_parallel_spec needs at least one mesh axis")
    return BlockSpec(axes, axis)


def stats_specs(d: int = 0, model_size: int = 1, shard_rows: bool = True) -> Any:
    """FED3R statistics: A (d, d) and b (d, C) row-split over "model" where
    d divides it, n replicated (a ``Fed3RStats`` of specs)."""
    from repro_torch.core.fed3r import Fed3RStats  # core imports the dist layer

    rows = shard_rows and (d == 0 or d % model_size == 0)
    row = BlockSpec(("model",), 0) if rows else replicated()
    return Fed3RStats(A=row, b=row, n=replicated())
