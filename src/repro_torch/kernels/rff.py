"""The fused random-features map ψ(Z) = √(2/D)·cos(ZΩ + β) on Hopper.

The port of the TPU kernel ``rff_pallas`` (``_rff_kernel``) of the reference
package, which FED3R-RF (paper §4.2) runs before the statistics pass and the
streaming engine runs on every wave:

* the CUDA C++ kernel, ``csrc/rff.cu`` (design notes there): an NN
  IEEE-fp32 SGEMM with bias, cos and scale in its epilogue, so the (n × D)
  pre-activation never reaches device memory.  8 × 8 register tiles of a
  128 × 128 tile (4 × 4 of a 64 × 64 one, :func:`pick_tile`) fed from a
  ``cp.async`` ring of Z and Ω panels; bound by arithmetic (2·n·d·D FLOPs
  on the FMA units, no tensor cores).  Each element of ψ is one ``fmaf``
  chain over k in order, then the accurate ``cosf``: a launch is bitwise
  repeatable, both instances give the same bits, and a sample row's ψ does
  not depend on where it sits in Z, which keeps the rf and streaming
  engines bitwise invariant to the order of clients and arrivals;
* its plain version, :func:`repro_torch.kernels.ref.rff_ref`;
* the wrapper :func:`rff_transform`: a CPU tensor goes to the plain version,
  a CUDA tensor to the kernel, with no fallback.  ``rff_transform.launches``
  counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import rff_ref

LIBRARY = _build.CudaLibrary("rff", {
    "rff_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
})


def _check(Z: torch.Tensor, omega: torch.Tensor, beta: torch.Tensor) -> None:
    if Z.dim() != 2 or omega.dim() != 2 or beta.dim() != 1:
        raise ValueError(
            f"rff_transform: Z (n, d), omega (d, D) and beta (D,) expected, got "
            f"{tuple(Z.shape)}, {tuple(omega.shape)}, {tuple(beta.shape)}"
        )
    if Z.shape[1] != omega.shape[0] or omega.shape[1] != beta.shape[0]:
        raise ValueError(
            f"rff_transform: shapes do not chain: Z {tuple(Z.shape)}, omega "
            f"{tuple(omega.shape)}, beta {tuple(beta.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (Z, omega, beta)):
        raise TypeError(
            f"rff_transform takes fp32 Z, omega and beta, got {Z.dtype}, {omega.dtype}, "
            f"{beta.dtype}"
        )
    if not (Z.device == omega.device == beta.device):
        raise ValueError(
            f"rff_transform: Z on {Z.device}, omega on {omega.device}, beta on {beta.device}"
        )
    # the same contract on both devices, so the CPU tests check what the card needs
    if not (Z.is_contiguous() and omega.is_contiguous() and beta.is_contiguous()):
        raise ValueError("rff_transform: Z, omega and beta must be contiguous (row-major)")


def pick_tile(n: int, D: int, sms: int) -> int:
    """The kernel's instance for an (n, D) ψ on a card of ``sms`` SMs:
    128 × 128 tiles where their blocks fill the card at least twice over
    (two such blocks fit an SM), else 64 × 64 ones."""
    return 128 if -(-n // 128) * -(-D // 128) >= 2 * sms else 64


def _launch(Z: torch.Tensor, omega: torch.Tensor, beta: torch.Tensor,
            tile: int = 0) -> torch.Tensor:
    """Launch the kernel; ``tile`` 64 or 128 forces an instance, 0 lets
    :func:`pick_tile` choose."""
    n, d = Z.shape
    D = omega.shape[1]
    if max(n, d, D) >= 2**31 or D == 0 or -(-n // 64) > 65535:
        raise ValueError(f"rff_transform: unsupported shape n={n}, d={d}, D={D}")
    if tile not in (0, 64, 128):
        raise ValueError(f"rff_transform: tile must be 0, 64 or 128, got {tile!r}")
    sms = _build.require_hopper(Z.device, "rff")
    out = torch.empty((n, D), dtype=torch.float32, device=Z.device)
    if n == 0:
        return out
    err = _build.launch(Z.device, LIBRARY.function("rff_launch"), Z.data_ptr(),
                        omega.data_ptr(), beta.data_ptr(), out.data_ptr(), n, d, D,
                        math.sqrt(2.0 / D), tile or pick_tile(n, D, sms))
    LIBRARY.check(err, "rff")
    rff_transform.launches += 1
    return out


def rff_transform(Z: torch.Tensor, omega: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """ψ(Z) = √(2/D)·cos(ZΩ + β): (n, d) → (n, D) fp32.

    A CUDA tensor launches the CUDA kernel on the current stream; a CPU
    tensor runs the plain version.  Any other device raises.
    """
    _check(Z, omega, beta)
    if Z.device.type == "cuda":
        return _launch(Z, omega, beta)
    if Z.device.type == "cpu":
        return rff_ref(Z, omega, beta)
    raise RuntimeError(f"rff_transform: no kernel for device {Z.device}")


rff_transform.launches = 0
