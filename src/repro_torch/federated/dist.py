"""Execution layer shared by the port's engines: device, dispatch, spans.

The port's counterpart of the reference's ``federated/dist.py``, cut to what
the single-process merge backend needs:

* :func:`resolve_device` — the ONE device rule of the port.  Every entry
  point takes ``device=`` and defaults to ``"cuda"``; asking for the card on
  a machine without one raises, and nothing falls back to the CPU.  The CPU
  runs only when the caller asks for it (the tests do).  Which statistics
  backend runs is then decided by the tensor's device alone
  (:func:`repro_torch.kernels.ops.fed3r_stats`): the CUDA kernel for a CUDA
  tensor, its plain PyTorch version for a CPU tensor.
* :class:`DistConfig` — ``aggregation="merge"`` (the engine's left fold IS
  the global sum).  ``"psum"``, meshes and aggregation trees are the
  distributed layer of a later slice and raise ``NotImplementedError``.
* :class:`DistContext` — the per-engine handle: the host dispatch counter
  (homed in the telemetry registry as ``engine_dispatches_total``) and the
  registry's spans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from repro_torch.federated.telemetry import Telemetry, get_telemetry

_DIST_LATER = "the distributed layer is ROADMAP Queue 1 item 8"


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The port's device rule: the card unless the caller asks for the CPU.

    Raises ``RuntimeError`` for a CUDA device on a machine without a card
    rather than falling back to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for a CUDA card, but torch sees none "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


@dataclass(frozen=True)
class DistConfig:
    """Aggregation backend of an engine.

    ``"merge"`` is the single-process backend: the engine's strict left
    fold already produced the global statistics.  ``"psum"`` (an all-reduce
    over a device mesh), ``mesh`` and ``tree`` (the N-tier aggregation tree)
    are not ported yet.
    """

    aggregation: str = "merge"  # "merge"; "psum" waits for the dist layer
    mesh: Optional[Any] = None
    tree: Optional[Any] = None

    def __post_init__(self):
        if self.aggregation not in ("merge", "psum"):
            raise ValueError(f"unknown aggregation backend: {self.aggregation!r}")
        if self.aggregation == "psum" or self.mesh is not None or self.tree is not None:
            raise NotImplementedError(
                f"aggregation={self.aggregation!r} with a mesh or tree: {_DIST_LATER}"
            )


class DistContext:
    """Per-engine handle: dispatch counter, spans, aggregation backend.

    The dispatch counter is the labeled telemetry series
    ``engine_dispatches_total{engine=<name>, inst=<n>}``, one cell per
    context, so N same-type engines stay independently resettable.
    """

    def __init__(
        self,
        cfg: DistConfig,
        *,
        engine: str = "engine",
        telemetry: Optional[Telemetry] = None,
    ):
        self.cfg = cfg
        self.telemetry = get_telemetry() if telemetry is None else telemetry
        inst = self.telemetry.next_instance(f"dist:{engine}")
        self._dispatches = self.telemetry.counter(
            "engine_dispatches_total", engine=engine, inst=inst
        )

    @property
    def dispatches(self) -> int:
        """Host-API entry count (a telemetry counter cell)."""
        return int(self._dispatches.value)

    def dispatch(self) -> None:
        """Record one host-API entry (a plain integer add)."""
        self._dispatches.inc()


class DistDispatchMixin:
    """The engines' public ``.dispatches`` counter, proxied onto the owned
    :class:`DistContext` (``self.dist``)."""

    dist: DistContext

    @property
    def dispatches(self) -> int:
        return self.dist.dispatches
