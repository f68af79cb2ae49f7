"""The one builder of the port's CUDA kernels: nvcc → shared library → ctypes.

Each kernel is one source under ``csrc/`` compiled for ``sm_90a`` into its
own shared library with a plain C interface (seconds to build, against
minutes for a PyTorch extension), then loaded with ``ctypes``.  A
:class:`CudaLibrary` owns one source:

* the library lives in ``build/`` at the checkout root (git-ignored), named
  by a hash of the source, the shared ``csrc/*.cuh`` headers and the flags,
  so an edit rebuilds and an unchanged source is reused;
* the build runs at the first launch (or :meth:`CudaLibrary.load`), never at
  import, and writes to a private temporary name that is renamed into
  place, so concurrent builds never load a half-written library;
* :func:`build_all` starts one ``nvcc`` per source, all at once, and waits
  for them together.

Every source exports ``<name>_error_string(int)`` beside its launch
functions, so a wrapper can name the ``cudaError_t`` a launch returned.
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
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/ → the checkout root, whose build/ git ignores
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# a C signature: (argtypes, restype)
Signature = Tuple[Sequence[type], Optional[type]]


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
        "port's CUDA kernels cannot be built"
    )


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, its shared library and its C functions.

    ``functions`` maps each exported C function to its ctypes signature;
    ``<name>_error_string`` is bound as well.
    """

    def __init__(self, name: str, functions: Dict[str, Signature]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = dict(functions)
        self.functions[f"{name}_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
        self.lib: Optional[ctypes.CDLL] = None
        self.build_log = ""  # nvcc's output of the build this process ran ("" if cached)
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the shared library of the current source (and of the
        ``csrc/*.cuh`` headers it may include) lives."""
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    def _start(self) -> Optional[Tuple[subprocess.Popen, Path, list]]:
        out = self.path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, cmd

    def _finish(self, started: Tuple[subprocess.Popen, Path, list]) -> None:
        proc, tmp, cmd = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        self.build_log = log
        os.replace(tmp, self.path())

    def build(self) -> Path:
        """Compile the source if it has no library yet; return the library's path."""
        started = self._start()
        if started is not None:
            self._finish(started)
        return self.path()

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, binding its C functions."""
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, (argtypes, restype) in self.functions.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = restype
                self.lib = lib
            return self.lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch function returned a nonzero ``cudaError_t``."""
        if err != 0:
            msg = getattr(self.lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: cudaError {err} ({msg})")


def build_all(libraries: Sequence[CudaLibrary]) -> float:
    """Build every library not built yet, one nvcc each, all started together,
    then load them all; return the seconds it took."""
    t0 = time.perf_counter()
    started = [(lib, lib._start()) for lib in libraries]
    for lib, st in started:
        if st is not None:
            lib._finish(st)
    for lib in libraries:
        lib.load()
    return time.perf_counter() - t0


def require_hopper(device, what: str) -> None:
    """The kernels are built for sm_90a only: refuse another card."""
    import torch

    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{what} is built for sm_90a (Hopper); {torch.cuda.get_device_name(device)} "
            f"has compute capability {cap}"
        )
