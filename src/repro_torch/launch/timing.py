"""How the port's kernels are timed on the card, and the one-call
yardsticks ``dequant_acc`` and the Gram kernels are held against.

Shared by ``chip_smoke.py``'s ``[kernel]`` lines and
:mod:`repro_torch.launch.time_kernels`, so both read a call the same way:

* :func:`cuda_ms`: back-to-back calls between two CUDA events.  It is the
  slower of the device work and the host's launch path;
* :func:`device_ms`: the same calls captured into one CUDA graph and
  replayed, so the host launches nothing while the events run: the device
  work alone (the wrappers launch on the current stream, the capturing
  one).  ``cuda_ms`` well above ``device_ms`` means host time sets the call;
* :func:`host_us`: the host clock over back-to-back calls with no
  synchronisation: what one call costs the host.

Each takes a callable of no arguments, on the card only.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

GRAPH_CALLS = 50  # calls captured in one graph
GRAPH_REPLAYS = 10
HOST_CALLS = 50


def cuda_ms(fn: Callable[[], object], iters: int = 200, warmup: int = 20,
            budget_ms: float = 400.0) -> float:
    """Mean time of ``fn()`` over back-to-back calls: ``iters`` of them,
    fewer where one call is long (about ``budget_ms`` in all, at least 3)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = max(3, min(iters, int(budget_ms / once)))
    for _ in range(min(warmup, iters)):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable[[], object], calls: int = GRAPH_CALLS,
              replays: int = GRAPH_REPLAYS) -> float:
    """Mean device time of ``fn()``: ``calls`` calls captured into one CUDA
    graph, the graph replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def host_us(fn: Callable[[], object], calls: int = HOST_CALLS) -> float:
    """Mean host time of one call of ``fn()``, with no synchronisation in the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def broadcast_addcmul(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      tile: int) -> Optional[Callable[[], torch.Tensor]]:
    """The one ``torch.addcmul`` that computes fma(q, s, acc) from the
    kernel's own int8 q and tile scales through broadcast views, where the
    tile divides the rows and divides or exceeds the columns; else None.
    Its result has the shape (M / tile, tile, Nt, N / Nt)."""
    M, N = acc.shape
    if M % tile or (N % tile and N > tile):
        return None
    Mt, Nt = s.shape
    tn = min(tile, N)
    a4, q4, s4 = acc.view(Mt, tile, Nt, tn), q.view(Mt, tile, Nt, tn), s.view(Mt, 1, Nt, 1)
    return lambda: torch.addcmul(a4, q4, s4)


def stacked_gram(L: torch.Tensor, Z: torch.Tensor,
                 Y: torch.Tensor) -> Callable[[], torch.Tensor]:
    """The one ``torch.matmul`` that computes [G | B] = [L Lᵀ + ZᵀZ | ZᵀY]
    from operands stacked beforehand: [Lᵀ; Z]ᵀ [[Lᵀ | 0]; [Z | Y]], batched
    over heads where Z (K, n, d) and Y (K, n, C) are 3-D."""
    d, C = L.shape[0], Y.shape[-1]
    if Z.dim() == 2:
        left = torch.cat([L.T, Z], dim=0).T.contiguous()  # (d, d + n)
        right = torch.cat([torch.cat([L.T, L.new_zeros((d, C))], dim=1),
                           torch.cat([Z, Y], dim=1)], dim=0)  # (d + n, d + C)
    else:
        K = Z.shape[0]
        LT = L.T.expand(K, d, d)
        left = torch.cat([LT.transpose(1, 2), Z.transpose(1, 2)], dim=2).contiguous()
        right = torch.cat([torch.cat([LT, L.new_zeros((K, d, C))], dim=2),
                           torch.cat([Z, Y], dim=2)], dim=1).contiguous()
    return lambda: torch.matmul(left, right)
