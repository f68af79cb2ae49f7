"""Causal GQA flash attention on Hopper: the dense backbone's prefill.

The port of the TPU kernel ``flash_attention_pallas`` (``_flash_kernel``) of
the reference package, which the reference names as the fast path of its
prefill attention:

* the CUDA C++ kernel, ``csrc/flash_attention.cu`` (design notes there):
  one block per query tile and head, the loop over key tiles inside the
  block up to the diagonal, an online softmax in the Pallas kernel's order
  (fp32 scores scaled after the product, l summed from the unrounded p, p
  rounded to v's type for the value product), any S >= 1, any head width
  that is a multiple of 8 up to 256.  bf16 runs warp-specialized on the
  tensor cores (``wgmma`` fed by a TMA ring of K/V tiles), fp32 on IEEE
  FMA.  Bound by operations: 4·hd FLOPs a kept (query, key) pair and head;
* its plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`;
* the wrapper :func:`flash_attention`: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, with no fallback.
  ``flash_attention.launches`` counts kernel launches.

``models/attention.py`` calls it for the attention of a prefill (every
layer, once; an encoder layer's with causal off); decode and the train /
feature forward keep the plain attention.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256  # head widths: multiples of 8 up to this
DTYPES = (torch.bfloat16, torch.float32)

LIBRARY = _build.CudaLibrary("flash_attention", {
    "flash_attention_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                               + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 2
                               + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
})


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q (B, S, H, hd) and k, v (B, S, KV, hd) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(
            f"flash_attention: k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "in batch, sequence or head width"
        )
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group over {KV} KV heads")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head width {hd} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]"
        )
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_attention takes q, k, v all bf16 or all fp32, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"flash_attention: window must be None or an int >= 1, got {window!r}")
    # the same contract on both devices, so the CPU tests check what the card needs
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on the current stream.  ``lse``, where given, is an fp32
    (B, H, S) buffer the kernel fills with each row's log-sum-exp m + log l
    (l the sum of the unrounded p): a check of the kernel's arithmetic,
    which the public function never asks for."""
    B, S, H, hd = q.shape
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on 16-byte boundaries")
    if lse is not None and (lse.shape != (B, H, S) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous fp32 ({B}, {H}, {S}) "
                         f"tensor on {q.device}")
    _build.require_hopper(q.device, "flash_attention")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    err = _build.launch(
        q.device, LIBRARY.function("flash_attention_launch"),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B, S, H, k.shape[2], hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        int(causal), window or 0, hd ** -0.5,
    )
    LIBRARY.check(err, "flash_attention")
    flash_attention.launches += 1
    _build.count_work(*flash_work(B, S, H, k.shape[2], hd, causal, window, q.element_size()))
    return out


def kept_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs of S positions the mask keeps."""
    W = window or S
    if causal:
        W = min(W, S)
        return W * (W + 1) // 2 + (S - W) * W
    if W >= S:
        return S * S
    return S * S - (S - W) * (S - W + 1) // 2


def flash_work(B: int, S: int, H: int, KV: int, hd: int, causal: bool,
               window: Optional[int], elem_bytes: int) -> tuple:
    """(FLOPs, bytes) of one launch: 4·hd a kept (query, key) pair and
    head; q, k and v read once and the output written once."""
    flops = 4.0 * hd * kept_pairs(S, causal, window) * H * B
    return flops, float(elem_bytes * B * S * hd * (2 * H + 2 * KV))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked softmax attention, GQA: q (B, S, H, hd), k/v (B, S, KV, hd) → (B, S, H, hd).

    Query position p attends to keys ``k <= p`` (``causal``) and, with a
    ``window`` W, ``k > p - W``.  A CUDA tensor launches the CUDA kernel on
    the current stream; a CPU tensor runs the plain version.  Any other
    device raises.
    """
    _check(q, k, v, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise RuntimeError(f"flash_attention: no kernel for device {q.device}")


flash_attention.launches = 0
