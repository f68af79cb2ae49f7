"""The fused FED3R statistics kernel (A, b) = (ZᵀZ, ZᵀY) on Hopper.

The port of the TPU kernel ``fed3r_stats_pallas`` (``_stats_kernel``) of the
reference package.  Three pieces:

* the CUDA C++ kernel, ``csrc/fed3r_stats.cu`` (design notes there), built
  for ``sm_90a`` by the port's one builder (:mod:`repro_torch.kernels.build`)
  at the first launch, never at import, into ``build/``
  at the checkout root, keyed by a hash of the source.  An IEEE-fp32 SGEMM
  of the tiles of A on or above the diagonal (each mirrored below it) and
  of b, with 8 × 8 register tiles (4 × 4 in the 64-wide instance) fed
  from a ``cp.async`` ring; its 128-wide instance where the tiles fill
  the card, else a 64-wide one (:func:`pick_tile`).  Each output element
  is one ``fmaf`` chain over the samples in order: A is exactly symmetric
  and a launch bitwise repeatable;
* its plain version, :func:`repro_torch.kernels.ref.fed3r_stats_ref`;
* the wrapper :func:`fed3r_stats`: a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel.  There is no fallback: a CUDA tensor launches
  the kernel or raises.  ``fed3r_stats.launches`` counts kernel launches,
  so a run can show that its main path went through the kernel.  The
  launch path pays per call only what depends on the inputs (the
  capability is checked once per device index, the C function bound once,
  the device guard entered only off the current device).

The kernel multiplies in IEEE fp32 (no TF32) and takes fp32 inputs only;
bf16 inputs are later work.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import fed3r_stats_ref

LIBRARY = _build.CudaLibrary("fed3r_stats", {
    "fed3r_stats_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                           ctypes.c_int),
})
SOURCE = LIBRARY.source
library_path = LIBRARY.path


def __getattr__(name: str):
    # the library handle and nvcc's log live on LIBRARY; these module names
    # read them (``_lib`` is None until the first launch)
    if name == "_lib":
        return LIBRARY.lib
    if name == "build_log":
        return LIBRARY.build_log
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check(Z: torch.Tensor, Y: torch.Tensor) -> None:
    if Z.dim() != 2 or Y.dim() != 2:
        raise ValueError(f"fed3r_stats: Z and Y must be 2-D, got {tuple(Z.shape)}, {tuple(Y.shape)}")
    if Z.shape[0] != Y.shape[0]:
        raise ValueError(
            f"fed3r_stats: Z has {Z.shape[0]} samples but Y has {Y.shape[0]}"
        )
    if Z.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError(
            f"fed3r_stats takes fp32 Z and Y, got {Z.dtype} and {Y.dtype} "
            "(bf16 inputs are not supported yet)"
        )
    if Z.device != Y.device:
        raise ValueError(f"fed3r_stats: Z on {Z.device} but Y on {Y.device}")
    # the same contract on both devices, so the CPU tests check what the card needs
    if not (Z.is_contiguous() and Y.is_contiguous()):
        raise ValueError("fed3r_stats: Z and Y must be contiguous (row-major)")


def pick_tile(d: int, C: int, sms: int) -> int:
    """The kernel's instance for a (d, C) output on a card of ``sms`` SMs:
    128-wide tiles where their T(T+1)/2 + T·Tc blocks fill the card at least
    twice over (two such blocks fit an SM), else 64-wide ones."""
    T, Tc = -(-d // 128), -(-C // 128)
    return 128 if T * (T + 1) // 2 + T * Tc >= 2 * sms else 64


def _launch(Z: torch.Tensor, Y: torch.Tensor, tile: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; ``tile`` 64 or 128 forces an instance, 0 lets
    :func:`pick_tile` choose."""
    n, d = Z.shape
    C = Y.shape[1]
    if max(n, d, C) >= 2**31 or d == 0 or C == 0:
        raise ValueError(f"fed3r_stats: unsupported shape n={n}, d={d}, C={C}")
    if tile not in (0, 64, 128):
        raise ValueError(f"fed3r_stats: tile must be 0, 64 or 128, got {tile!r}")
    sms = _build.require_hopper(Z.device, "fed3r_stats")
    A = torch.empty((d, d), dtype=torch.float32, device=Z.device)
    b = torch.empty((d, C), dtype=torch.float32, device=Z.device)
    err = _build.launch(Z.device, LIBRARY.function("fed3r_stats_launch"), Z.data_ptr(),
                        Y.data_ptr(), A.data_ptr(), b.data_ptr(), n, d, C,
                        tile or pick_tile(d, C, sms))
    LIBRARY.check(err, "fed3r_stats")
    fed3r_stats.launches += 1
    # 2·n·d·(d + C) FLOPs; Z, Y read and A, b written once, fp32
    _build.count_work(2.0 * n * d * (d + C), 4.0 * (n * d + n * C + d * d + d * C))
    return A, b


def fed3r_stats(Z: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, b) = (ZᵀZ, ZᵀY) in fp32.  Z: (n, d) fp32; Y: (n, C) fp32.

    A CUDA tensor launches the CUDA kernel on the current stream; a CPU
    tensor runs the plain version.  Any other device raises.
    """
    _check(Z, Y)
    if Z.device.type == "cuda":
        return _launch(Z, Y)
    if Z.device.type == "cpu":
        return fed3r_stats_ref(Z, Y)
    raise RuntimeError(f"fed3r_stats: no kernel for device {Z.device}")


fed3r_stats.launches = 0
