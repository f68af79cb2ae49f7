"""The traced run: host labels, CUDA-event spans and the profiler's device timeline.

With ``--trace 1`` the driver's window runs under ``torch.profiler`` (CPU
and CUDA activity), its host phases inside ``record_function`` labels, and
the spans a per-layer metric reads are CUDA events.  With ``--trace 0``
every method here is a no-op, so the timed path is the same code without
the instruments.  :func:`digest` turns the profile into the device's busy
seconds over the window, the kernels' device times by name, and the idle
gaps by the host label that was open across them.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List

import torch

WINDOW = "window"


class Tracer:
    def __init__(self, on: bool, device: torch.device):
        self.on = on and device.type == "cuda"
        self.spans: Dict[str, List[tuple]] = {}
        self.prof = None

    def label(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def span(self, name: str):
        """CUDA events around the block, read once the window is over."""
        if not self.on:
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.spans.setdefault(name, []).append((start, end))

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
        self.prof = prof

    def span_ms(self) -> Dict[str, List[float]]:
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.spans.items()}


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every profiled event; the
    labels' projections onto the device's timeline are left out (they span
    the host's label, not device work)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns()
        yield e.name(), on_device, start, start + e.duration_ns()


def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def digest(prof, labels, top: int = 10) -> dict:
    """busy_s, window_s, kernels [(name, seconds)], device_ops and idle_gaps
    (the ``top`` largest, as [name, seconds]) of the profiled window.  A gap
    is charged to the one of ``labels`` open at its midpoint, else to
    "loop" (the driver's own host code)."""
    window, dev, host = None, [], []
    for name, on_device, s, e in _events(prof):
        if on_device:
            dev.append((name, s, e))
        elif name == WINDOW:
            window = (s, e)
        elif name in labels:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the profile holds no window label")
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in dev])
    by_op: Dict[str, float] = {}
    for n, s, e in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    host.sort(key=lambda h: h[1])  # the labels follow one another, none nests
    starts = [hs for _, hs, _ in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        owner = host[i][0] if i >= 0 and host[i][2] >= mid else "loop"
        gaps[owner] = gaps.get(owner, 0.0) + (e - s) / 1e9
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": [(n, (e - s) / 1e9) for n, s, e in dev],
            "device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}
