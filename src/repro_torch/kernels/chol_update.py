"""The fused rank-n Cholesky-Gram update G = L Lᵀ + ZᵀZ, B = ZᵀY on Hopper.

The port of the TPU kernel ``chol_gram_pallas`` (``_chol_gram_kernel``) of
the reference package, the streaming engine's per-wave hot spot
(:mod:`repro_torch.federated.streaming_engine`):

* the CUDA C++ kernel, ``csrc/chol_gram.cu`` (design notes there): one block
  per 64×64 tile of [G | B], sweeping the rows of Lᵀ first (G columns only)
  and the sample rows of [Z | Y] second into one fp32 accumulator per
  element, with no stacked operand in device memory, no atomics and no
  split-K (a launch is bitwise repeatable).  It reads only the lower
  triangle of L, computes the lower tiles of the symmetric G and mirrors
  them.  Bound by arithmetic: ≈ d³/3 FLOPs for L Lᵀ plus n·d·(d+1) for ZᵀZ,
  on the FMA units in IEEE fp32;
* its plain version, :func:`repro_torch.kernels.ref.chol_gram_ref`;
* the wrapper :func:`chol_gram`: a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, with no fallback.  ``chol_gram.launches``
  counts kernel launches.

``L`` must be lower-triangular, as a Cholesky factor is: the kernel does not
read its upper triangle.  ``n = 0`` is legal and gives (L Lᵀ, 0) exactly.

The batched per-head form (``batched_chol_gram_pallas``) is a later slice.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import chol_gram_ref

LIBRARY = _build.CudaLibrary("chol_gram", {
    "chol_gram_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         ctypes.c_int),
})


def _check(L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor) -> None:
    if L.dim() != 2 or Z.dim() != 2 or Y.dim() != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(
            f"chol_gram: L (d, d), Z (n, d) and Y (n, C) expected, got "
            f"{tuple(L.shape)}, {tuple(Z.shape)}, {tuple(Y.shape)}"
        )
    if Z.shape[1] != L.shape[0] or Z.shape[0] != Y.shape[0]:
        raise ValueError(
            f"chol_gram: shapes do not match: L {tuple(L.shape)}, Z {tuple(Z.shape)}, "
            f"Y {tuple(Y.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (L, Z, Y)):
        raise TypeError(
            f"chol_gram takes fp32 L, Z and Y, got {L.dtype}, {Z.dtype}, {Y.dtype}"
        )
    if not (L.device == Z.device == Y.device):
        raise ValueError(f"chol_gram: L on {L.device}, Z on {Z.device}, Y on {Y.device}")
    # the same contract on both devices, so the CPU tests check what the card needs
    if not (L.is_contiguous() and Z.is_contiguous() and Y.is_contiguous()):
        raise ValueError("chol_gram: L, Z and Y must be contiguous (row-major)")


def _launch(L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = L.shape[0]
    n, C = Y.shape
    if max(n, d + C) >= 2**31 or d == 0 or C == 0:
        raise ValueError(f"chol_gram: unsupported shape d={d}, n={n}, C={C}")
    _build.require_hopper(L.device, "chol_gram")
    lib = LIBRARY.load()
    G = torch.empty((d, d), dtype=torch.float32, device=L.device)
    B = torch.empty((d, C), dtype=torch.float32, device=L.device)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = lib.chol_gram_launch(
            L.data_ptr(), Z.data_ptr(), Y.data_ptr(), G.data_ptr(), B.data_ptr(),
            d, n, C, stream,
        )
    LIBRARY.check(err, "chol_gram")
    chol_gram.launches += 1
    return G, B


def chol_gram(
    L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, B) = (L Lᵀ + ZᵀZ, ZᵀY) in fp32.  L: (d, d) lower-triangular;
    Z: (n, d); Y: (n, C); n may be 0.

    A CUDA tensor launches the CUDA kernel on the current stream; a CPU
    tensor runs the plain version.  Any other device raises.
    """
    _check(L, Z, Y)
    if L.device.type == "cuda":
        return _launch(L, Z, Y)
    if L.device.type == "cpu":
        return chol_gram_ref(L, Z, Y)
    raise RuntimeError(f"chol_gram: no kernel for device {L.device}")


chol_gram.launches = 0
