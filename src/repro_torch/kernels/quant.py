"""Tile-wise int8 (de)quantization of the statistics uplink on Hopper.

The ports of the TPU kernels ``quantize_tiles_pallas`` (``_quantize_kernel``)
and ``dequant_acc_pallas`` (``_dequant_acc_kernel``) of the reference
package, the two ends of the compressed uplink
(:mod:`repro_torch.federated.compress`):

* the CUDA C++ kernels, ``csrc/quant.cu`` (design notes there): one block
  per tile; ``quantize_tiles`` takes the tile's absmax, writes its scale
  s = max|x|·fl(1/127) (1 for an all-zero tile) and the payload
  q = clip(rne(x / s), ±127); ``dequant_accumulate`` writes fma(q, s, acc)
  with the tile's scale read once, so no dense dequantized or expanded
  scale array exists.  Every rounding is an explicit ``_rn`` intrinsic, and
  both kernels equal their plain versions bitwise.  Bound by bytes (5 and
  9 bytes an element);
* their plain versions, :func:`repro_torch.kernels.ref.quantize_tiles_ref`
  and :func:`repro_torch.kernels.ref.dequant_acc_ref`;
* the wrappers :func:`quantize_tiles` and :func:`dequant_accumulate`: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel, with no
  fallback.  Their ``launches`` attributes count kernel launches.

NaN inputs are outside the contract (the kernel's max skips NaN, the
reference's propagates it); statistics are finite.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import dequant_acc_ref, quantize_tiles_ref

TILE = 128  # absmax granularity: one fp32 scale per (TILE, TILE) block

LIBRARY = _build.CudaLibrary("quant", {
    "quantize_tiles_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                              ctypes.c_int),
    "dequant_acc_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                           ctypes.c_int),
})


def _grid(M: int, N: int, tile: int) -> Tuple[int, int]:
    return -(-M // tile), -(-N // tile)


def _check_tile(tile: int, what: str) -> None:
    if not isinstance(tile, int) or tile < 1:
        raise ValueError(f"{what}: tile must be an int >= 1, got {tile!r}")


def _check_quantize(x: torch.Tensor, tile: int) -> None:
    _check_tile(tile, "quantize_tiles")
    if x.dim() != 2:
        raise ValueError(f"quantize_tiles: x must be 2-D, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_tiles takes fp32 x, got {x.dtype}")
    # the same contract on both devices, so the CPU tests check what the card needs
    if not x.is_contiguous():
        raise ValueError("quantize_tiles: x must be contiguous (row-major)")


def _check_dequant(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, tile: int) -> None:
    _check_tile(tile, "dequant_accumulate")
    if acc.dim() != 2 or q.shape != acc.shape:
        raise ValueError(
            f"dequant_accumulate: acc (M, N) and q of the same shape expected, got "
            f"{tuple(acc.shape)}, {tuple(q.shape)}"
        )
    if tuple(scales.shape) != _grid(*acc.shape, tile):
        raise ValueError(
            f"dequant_accumulate: scales must be the {_grid(*acc.shape, tile)} tile grid of "
            f"{tuple(acc.shape)} at tile {tile}, got {tuple(scales.shape)}"
        )
    if acc.dtype != torch.float32 or q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            f"dequant_accumulate takes fp32 acc, int8 q and fp32 scales, got {acc.dtype}, "
            f"{q.dtype}, {scales.dtype}"
        )
    if not (acc.device == q.device == scales.device):
        raise ValueError(
            f"dequant_accumulate: acc on {acc.device}, q on {q.device}, scales on {scales.device}"
        )
    if not (acc.is_contiguous() and q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant_accumulate: acc, q and scales must be contiguous (row-major)")


def _launch_ready(x: torch.Tensor, tile: int, what: str) -> ctypes.CDLL:
    M, N = x.shape
    Mt, _ = _grid(M, N, tile)
    if max(M, N) >= 2**31 or Mt > 65535:
        raise ValueError(f"{what}: unsupported shape ({M}, {N}) at tile {tile}")
    _build.require_hopper(x.device, what)
    return LIBRARY.load()


def quantize_tiles(x: torch.Tensor, tile: int = TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile absmax int8 quantization of x (M, N) fp32: ``(q, scales)``.

    q (M, N) int8 and scales (⌈M/tile⌉, ⌈N/tile⌉) fp32 are the wire payload
    (1 byte an element plus one fp32 a tile).  A CUDA tensor launches the
    CUDA kernel on the current stream; a CPU tensor runs the plain version.
    Any other device raises.
    """
    _check_quantize(x, tile)
    if x.device.type == "cpu":
        return quantize_tiles_ref(x, tile)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_tiles: no kernel for device {x.device}")
    M, N = x.shape
    lib = _launch_ready(x, tile, "quantize_tiles")
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scales = torch.empty(_grid(M, N, tile), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return q, scales
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_tiles_launch(x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                                        M, N, tile, stream)
    LIBRARY.check(err, "quantize_tiles")
    quantize_tiles.launches += 1
    return q, scales


def dequant_accumulate(
    acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, tile: int = TILE
) -> torch.Tensor:
    """acc + q·s (M, N) fp32 in one rounding, fma(q, s, acc), as a new tensor.

    The aggregator-side merge: ``scales`` is the tile grid from
    :func:`quantize_tiles`.  A CUDA tensor launches the CUDA kernel on the
    current stream; a CPU tensor runs the plain version.  Any other device
    raises.
    """
    _check_dequant(acc, q, scales, tile)
    if acc.device.type == "cpu":
        return dequant_acc_ref(acc, q, scales, tile)
    if acc.device.type != "cuda":
        raise RuntimeError(f"dequant_accumulate: no kernel for device {acc.device}")
    M, N = acc.shape
    lib = _launch_ready(acc, tile, "dequant_accumulate")
    out = torch.empty((M, N), dtype=torch.float32, device=acc.device)
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.dequant_acc_launch(acc.data_ptr(), q.data_ptr(), scales.data_ptr(),
                                     out.data_ptr(), M, N, tile, stream)
    LIBRARY.check(err, "dequant_accumulate")
    dequant_accumulate.launches += 1
    return out


quantize_tiles.launches = 0
dequant_accumulate.launches = 0
