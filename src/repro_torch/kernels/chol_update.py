"""The fused rank-n Cholesky-Gram updates G = L Lᵀ + ZᵀZ, B = ZᵀY on Hopper.

The ports of the TPU kernels ``chol_gram_pallas`` (``_chol_gram_kernel``),
the streaming engine's per-wave hot spot
(:mod:`repro_torch.federated.streaming_engine`), and
``batched_chol_gram_pallas`` (``_batched_chol_gram_kernel``), the
personalization engine's refit over K heads against one shared factor
(:mod:`repro_torch.federated.personalization`):

* the CUDA C++ kernels, ``csrc/chol_gram.cu`` and
  ``csrc/batched_chol_gram.cu``, on one IEEE-fp32 SGEMM tile loop,
  ``csrc/chol_gram_tile.cuh`` (design notes there): one block for each
  tile of G on or below its diagonal (mirrored) and each tile of B, the
  longest factor sweeps first; 8 × 8 register tiles fed from a ``cp.async``
  ring at 128-wide tiles, 4 × 4 at 64-wide ones (:func:`pick_tile`); Z and
  Y read in place and L's lower triangle copied transposed into shared
  memory; all-zero sample panels skipped.  The batched refit forms
  G0 = L Lᵀ once (the same code at n = 0) and starts each head's
  accumulators from it.  Each element is one ``fmaf`` chain (factor rows,
  then sample rows, in order, from +0) with no atomics and no split-K: a
  launch is bitwise repeatable, G exactly symmetric, and each head of a
  batched launch bitwise the single update;
* their plain versions, :func:`repro_torch.kernels.ref.chol_gram_ref` and
  :func:`repro_torch.kernels.ref.batched_chol_gram_ref`;
* the wrappers :func:`chol_gram` and :func:`batched_chol_gram`: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel, with no
  fallback.  Their ``launches`` attributes count wrapper calls that
  launched on the card (a batched call is two kernel launches, counted
  once, and never as a ``chol_gram``).

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
    "chol_gram_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                         ctypes.c_int),
})
BATCHED_LIBRARY = _build.CudaLibrary("batched_chol_gram", {
    "batched_chol_gram_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                                 ctypes.c_int),
})


def pick_tile(d: int, C: int, sms: int, heads: int = 1) -> int:
    """The kernels' instance for a (d, C) output over ``heads`` heads on a
    card of ``sms`` SMs: 128-wide tiles where their (T(T+1)/2 + T·Tc)·heads
    blocks fill the card at least twice over (two such blocks fit an SM),
    else 64-wide ones."""
    T, Tc = -(-d // 128), -(-C // 128)
    return 128 if (T * (T + 1) // 2 + T * Tc) * heads >= 2 * sms else 64


def _tile_arg(tile: int, what: str) -> None:
    if tile not in (0, 64, 128):
        raise ValueError(f"{what}: tile must be 0, 64 or 128, got {tile!r}")


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


def _launch(L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor,
            tile: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; ``tile`` 64 or 128 forces an instance, 0 lets
    :func:`pick_tile` choose."""
    d = L.shape[0]
    n, C = Y.shape
    if max(n, d + C) >= 2**31 or d == 0 or C == 0:
        raise ValueError(f"chol_gram: unsupported shape d={d}, n={n}, C={C}")
    _tile_arg(tile, "chol_gram")
    sms = _build.require_hopper(L.device, "chol_gram")
    G = torch.empty((d, d), dtype=torch.float32, device=L.device)
    B = torch.empty((d, C), dtype=torch.float32, device=L.device)
    err = _build.launch(L.device, LIBRARY.function("chol_gram_launch"), L.data_ptr(),
                        Z.data_ptr(), Y.data_ptr(), G.data_ptr(), B.data_ptr(), d, n, C,
                        tile or pick_tile(d, C, sms))
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
    L: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor, tile: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (G0 = L Lᵀ into a scratch, then the heads);
    ``tile`` 64 or 128 forces the instance of both launches, 0 lets
    :func:`pick_tile` choose each."""
    d = L.shape[0]
    K, n, C = Y.shape
    if not 1 <= K < 2**16 or max(n, d + C) >= 2**31 or d == 0 or C == 0:
        raise ValueError(f"batched_chol_gram: unsupported shape K={K}, d={d}, n={n}, C={C}")
    _tile_arg(tile, "batched_chol_gram")
    sms = _build.require_hopper(L.device, "batched_chol_gram")
    G = torch.empty((K, d, d), dtype=torch.float32, device=L.device)
    B = torch.empty((K, d, C), dtype=torch.float32, device=L.device)
    G0 = torch.empty((d, d), dtype=torch.float32, device=L.device)
    err = _build.launch(L.device, BATCHED_LIBRARY.function("batched_chol_gram_launch"),
                        L.data_ptr(), Z.data_ptr(), Y.data_ptr(), G.data_ptr(), B.data_ptr(),
                        G0.data_ptr(), K, d, n, C, tile or pick_tile(d, 0, sms),
                        tile or pick_tile(d, C, sms, K))
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

    A CUDA tensor launches the CUDA kernel on the current stream (L Lᵀ
    once, then all K heads: one call, counted once in ``launches``); a CPU
    tensor runs the plain version.  Any other device raises.
    """
    _check_batched(L, Z, Y)
    if L.device.type == "cuda":
        return _launch_batched(L, Z, Y)
    if L.device.type == "cpu":
        return batched_chol_gram_ref(L, Z, Y)
    raise RuntimeError(f"batched_chol_gram: no kernel for device {L.device}")


batched_chol_gram.launches = 0
