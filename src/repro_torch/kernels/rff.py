"""The fused random-features map ψ(Z) = √(2/D)·cos(ZΩ + β) on Hopper.

The port of the TPU kernel ``rff_pallas`` (``_rff_kernel``) of the reference
package, which FED3R-RF (paper §4.2) runs before the statistics pass:

* the CUDA C++ kernel, ``csrc/rff.cu`` (design notes there): one block per
  64×64 tile of ψ with the loop over d inside it, and bias, cos and scale
  applied in registers before the single write, so the (n × D)
  pre-activation never reaches device memory.  It is bound by arithmetic
  (2·n·d·D FLOPs of IEEE fp32 FMA) and uses the accurate ``cosf``;
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
                   + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
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


def _launch(Z: torch.Tensor, omega: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    n, d = Z.shape
    D = omega.shape[1]
    if max(n, d, D) >= 2**31 or D == 0:
        raise ValueError(f"rff_transform: unsupported shape n={n}, d={d}, D={D}")
    _build.require_hopper(Z.device, "rff")
    out = torch.empty((n, D), dtype=torch.float32, device=Z.device)
    if n == 0:
        return out
    err = _build.launch(Z.device, LIBRARY.function("rff_launch"), Z.data_ptr(),
                        omega.data_ptr(), beta.data_ptr(), out.data_ptr(), n, d, D,
                        math.sqrt(2.0 / D))
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
