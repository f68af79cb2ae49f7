"""The fused rank-n Cholesky-Gram updates G = L Lᵀ + ZᵀZ, B = ZᵀY on Hopper.

The ports of the TPU kernels ``chol_gram_pallas`` (``_chol_gram_kernel``),
the streaming engine's per-wave hot spot
(:mod:`repro_torch.federated.streaming_engine`), and
``batched_chol_gram_pallas`` (``_batched_chol_gram_kernel``), the
personalization engine's refit over K heads against one shared factor
(:mod:`repro_torch.federated.personalization`):

* the CUDA C++ kernels, ``csrc/chol_gram.cu`` and
  ``csrc/batched_chol_gram.cu``, built on one tile loop,
  ``csrc/chol_gram_tile.cuh`` (design notes there): one block per 64×64
  tile of [G | B] (of head ``blockIdx.z`` in the batched kernel), sweeping
  the rows of Lᵀ first (G columns only) and the sample rows of [Z | Y]
  second into one fp32 accumulator per element, with no stacked operand in
  device memory, no atomics and no split-K (a launch is bitwise
  repeatable, and each head of a batched launch is bitwise the single
  update).  They read only the lower triangle of L, compute the lower tiles
  of the symmetric G and mirror them.  Bound by arithmetic: ≈ d³/3 FLOPs
  for L Lᵀ (a head) plus n·d·(d+1) for ZᵀZ, on the FMA units in IEEE fp32;
* their plain versions, :func:`repro_torch.kernels.ref.chol_gram_ref` and
  :func:`repro_torch.kernels.ref.batched_chol_gram_ref`;
* the wrappers :func:`chol_gram` and :func:`batched_chol_gram`: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel, with no
  fallback.  Their ``launches`` attributes count kernel launches.

``L`` must be lower-triangular, as a Cholesky factor is: the kernels do not
read its upper triangle.  ``n = 0`` is legal and gives (L Lᵀ, 0) exactly.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import batched_chol_gram_ref, chol_gram_ref

LIBRARY = _build.CudaLibrary("chol_gram", {
    "chol_gram_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         ctypes.c_int),
})
BATCHED_LIBRARY = _build.CudaLibrary("batched_chol_gram", {
    "batched_chol_gram_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
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


def _check_batched(L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor) -> None:
    if L.dim() != 2 or Z.dim() != 3 or Y.dim() != 3 or L.shape[0] != L.shape[1]:
        raise ValueError(
            f"batched_chol_gram: L (d, d), Z (K, n, d) and Y (K, n, C) expected, got "
            f"{tuple(L.shape)}, {tuple(Z.shape)}, {tuple(Y.shape)}"
        )
    if Z.shape[2] != L.shape[0] or Z.shape[:2] != Y.shape[:2]:
        raise ValueError(
            f"batched_chol_gram: shapes do not match: L {tuple(L.shape)}, Z {tuple(Z.shape)}, "
            f"Y {tuple(Y.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (L, Z, Y)):
        raise TypeError(
            f"batched_chol_gram takes fp32 L, Z and Y, got {L.dtype}, {Z.dtype}, {Y.dtype}"
        )
    if not (L.device == Z.device == Y.device):
        raise ValueError(
            f"batched_chol_gram: L on {L.device}, Z on {Z.device}, Y on {Y.device}"
        )
    if not (L.is_contiguous() and Z.is_contiguous() and Y.is_contiguous()):
        raise ValueError("batched_chol_gram: L, Z and Y must be contiguous (row-major)")


def _launch_batched(
    L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    d = L.shape[0]
    K, n, C = Y.shape
    if not 1 <= K < 2**16 or max(n, d + C) >= 2**31 or d == 0 or C == 0:
        raise ValueError(f"batched_chol_gram: unsupported shape K={K}, d={d}, n={n}, C={C}")
    _build.require_hopper(L.device, "batched_chol_gram")
    lib = BATCHED_LIBRARY.load()
    G = torch.empty((K, d, d), dtype=torch.float32, device=L.device)
    B = torch.empty((K, d, C), dtype=torch.float32, device=L.device)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = lib.batched_chol_gram_launch(
            L.data_ptr(), Z.data_ptr(), Y.data_ptr(), G.data_ptr(), B.data_ptr(),
            K, d, n, C, stream,
        )
    BATCHED_LIBRARY.check(err, "batched_chol_gram")
    batched_chol_gram.launches += 1
    return G, B


def batched_chol_gram(
    L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G_k, B_k) = (L Lᵀ + Z_kᵀZ_k, Z_kᵀY_k) in fp32 over K heads sharing one
    L.  L: (d, d) lower-triangular; Z: (K, n, d); Y: (K, n, C); n may be 0.
    Returns G (K, d, d) and B (K, d, C).  A per-head weight α_k is the
    caller's pre-scaling Z_k ← √α_k·Z_k, Y_k ← √α_k·Y_k.

    A CUDA tensor launches the CUDA kernel on the current stream (one launch
    for all K heads); a CPU tensor runs the plain version.  Any other device
    raises.
    """
    _check_batched(L, Z, Y)
    if L.device.type == "cuda":
        return _launch_batched(L, Z, Y)
    if L.device.type == "cpu":
        return batched_chol_gram_ref(L, Z, Y)
    raise RuntimeError(f"batched_chol_gram: no kernel for device {L.device}")


batched_chol_gram.launches = 0
