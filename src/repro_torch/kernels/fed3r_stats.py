"""The fused FED3R statistics kernel (A, b) = (ZᵀZ, ZᵀY) on Hopper.

The port of the TPU kernel ``fed3r_stats_pallas`` (``_stats_kernel``) of the
reference package.  Three pieces:

* the CUDA C++ kernel, ``csrc/fed3r_stats.cu`` (design notes there), built
  for ``sm_90a`` with ``nvcc`` into a shared library with a plain C
  interface and loaded with ``ctypes``.  The build runs at the first launch
  (or :func:`build`), never at import, into ``build/`` at the checkout root,
  keyed by a hash of the source;
* its plain version, :func:`repro_torch.kernels.ref.fed3r_stats_ref`;
* the wrapper :func:`fed3r_stats`: a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel.  There is no fallback: a CUDA tensor launches
  the kernel or raises.  ``fed3r_stats.launches`` counts kernel launches,
  so a run can show that its main path went through the kernel.

The kernel multiplies in IEEE fp32 (no TF32) and takes fp32 inputs only;
bf16 inputs are later work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import fed3r_stats_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fed3r_stats.cu"
# src/repro_torch/kernels/ → the checkout root, whose build/ git ignores
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the build this process ran ("" if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "fed3r_stats CUDA kernel cannot be built"
    )


def library_path() -> Path:
    """Where the shared library of the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fed3r_stats-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel if this source has no library yet; return its path.

    Compiles to a private temporary name and renames it into place, so
    concurrent builds never load a half-written library.
    """
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fed3r_stats_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.fed3r_stats_launch.restype = ctypes.c_int
            lib.fed3r_stats_error_string.argtypes = [ctypes.c_int]
            lib.fed3r_stats_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def load() -> float:
    """Build (if needed) and load the library; return the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


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


def _launch(Z: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not (Z.is_contiguous() and Y.is_contiguous()):
        raise ValueError("fed3r_stats: Z and Y must be contiguous (row-major)")
    n, d = Z.shape
    C = Y.shape[1]
    if max(n, d, C) >= 2**31 or d == 0 or C == 0:
        raise ValueError(f"fed3r_stats: unsupported shape n={n}, d={d}, C={C}")
    if torch.cuda.get_device_capability(Z.device) != (9, 0):
        raise RuntimeError(
            f"fed3r_stats is built for sm_90a (Hopper); {torch.cuda.get_device_name(Z.device)} "
            f"has compute capability {torch.cuda.get_device_capability(Z.device)}"
        )
    lib = _library()
    A = torch.empty((d, d), dtype=torch.float32, device=Z.device)
    b = torch.empty((d, C), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.fed3r_stats_launch(
            Z.data_ptr(), Y.data_ptr(), A.data_ptr(), b.data_ptr(), n, d, C, stream
        )
    if err != 0:
        msg = lib.fed3r_stats_error_string(err).decode()
        raise RuntimeError(f"fed3r_stats kernel launch failed: cudaError {err} ({msg})")
    fed3r_stats.launches += 1
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
