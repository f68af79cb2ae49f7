"""Tile-wise int8 (de)quantization of the statistics uplink on Hopper.

The ports of the TPU kernels ``quantize_tiles_pallas`` (``_quantize_kernel``)
and ``dequant_acc_pallas`` (``_dequant_acc_kernel``) of the reference
package, the two ends of the compressed uplink
(:mod:`repro_torch.federated.compress`):

* the CUDA C++ kernels, ``csrc/quant.cu`` (design notes there), both
  bound by bytes (5 and 9 bytes an element).  ``quantize_tiles`` takes
  each tile's absmax, writes its scale s = max|x|·fl(1/127) (1 for an
  all-zero tile) and the payload q = clip(rne(x / s), ±127), reading x
  once: a thread-block cluster a tile (:func:`pick_cluster`), each block a
  slab of the tile's rows held in registers, the blocks' maxima exchanged
  through distributed shared memory, 16-byte loads and stores where the
  shape and pointers allow; the payload rounds x·fl(1/s) where that
  provably gives the integer of x / s, and divides where it might not.
  ``dequant_accumulate`` writes fma(q, s, acc) over runs of 16 (or 4)
  consecutive elements of a row, one
  wide load of q and float4 loads and stores, each run's scale read once;
  a scalar path takes rows whose width is not a multiple of 4 and
  pointers not aligned to 16 bytes (the launch function picks the path
  from the pointers and N, and sizes the grid from the SM count that
  :func:`repro_torch.kernels.build.require_hopper` learned once a card).  No dense dequantized or expanded scale array
  exists.  Every rounding is an explicit ``_rn`` intrinsic, and both
  kernels equal their plain versions bitwise;
* their plain versions, :func:`repro_torch.kernels.ref.quantize_tiles_ref`
  and :func:`repro_torch.kernels.ref.dequant_acc_ref`;
* the wrappers :func:`quantize_tiles` and :func:`dequant_accumulate`: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel, with no
  fallback.  Their ``launches`` attributes count kernel launches.  The
  launch path pays per call only what depends on the inputs: the card's
  capability is checked once per device index, the C function is bound
  once, and the device guard is entered only off the current device
  (:func:`repro_torch.kernels.build.launch`).

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
CLUSTERS = (1, 2, 4, 8)  # quantize_tiles' blocks a tile: the portable cluster sizes
QUANT_THREADS = 128  # quantize_tiles' block
HELD = 64  # floats of x a quantize_tiles thread can keep in registers

LIBRARY = _build.CudaLibrary("quant", {
    "quantize_tiles_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                              ctypes.c_int),
    "dequant_acc_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
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


def _launch_ready(x: torch.Tensor, tile: int, what: str) -> int:
    """Refuse a shape the launch cannot take or a card that is not sm_90;
    return the card's SM count."""
    M, N = x.shape
    Mt, _ = _grid(M, N, tile)
    if max(M, N) >= 2**31 or Mt > 65535:
        raise ValueError(f"{what}: unsupported shape ({M}, {N}) at tile {tile}")
    return _build.require_hopper(x.device, what)


def pick_cluster(tiles: int, tile: int, sms: int) -> int:
    """``quantize_tiles``' blocks a tile for ``tiles`` tiles of ``tile`` × ``tile``
    on a card of ``sms`` SMs: the smallest of :data:`CLUSTERS` whose blocks
    fill the card four times over and whose slabs fit what the blocks hold
    (:data:`HELD` floats a thread), but no more blocks than a tile has rows."""
    for c in CLUSTERS:
        if 2 * c > tile or (tiles * c >= 4 * sms and tile * tile <= c * QUANT_THREADS * HELD):
            return c
    return CLUSTERS[-1]


def _quantize(x: torch.Tensor, tile: int, cluster: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel; ``cluster`` 1, 2, 4 or 8 forces the blocks
    a tile, 0 lets :func:`pick_cluster` choose."""
    if cluster != 0 and cluster not in CLUSTERS:
        raise ValueError(f"quantize_tiles: cluster must be 0 or one of {CLUSTERS}, got {cluster!r}")
    M, N = x.shape
    sms = _launch_ready(x, tile, "quantize_tiles")
    grid = _grid(M, N, tile)
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scales = torch.empty(grid, dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return q, scales
    err = _build.launch(x.device, LIBRARY.function("quantize_tiles_launch"), x.data_ptr(),
                        q.data_ptr(), scales.data_ptr(), M, N, tile,
                        cluster or pick_cluster(grid[0] * grid[1], tile, sms))
    LIBRARY.check(err, "quantize_tiles")
    quantize_tiles.launches += 1
    return q, scales


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
    return _quantize(x, tile)


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
    device = acc.device
    if device.type == "cpu":
        return dequant_acc_ref(acc, q, scales, tile)
    if device.type != "cuda":
        raise RuntimeError(f"dequant_accumulate: no kernel for device {device}")
    M, N = acc.shape
    sms = _launch_ready(acc, tile, "dequant_accumulate")
    out = torch.empty_like(acc)  # acc is contiguous fp32 (checked): so is out
    if M == 0 or N == 0:
        return out
    err = _build.launch(device, LIBRARY.function("dequant_acc_launch"), acc.data_ptr(),
                        q.data_ptr(), scales.data_ptr(), out.data_ptr(), M, N, tile, sms)
    LIBRARY.check(err, "dequant_accumulate")
    dequant_accumulate.launches += 1
    return out


quantize_tiles.launches = 0
dequant_accumulate.launches = 0
