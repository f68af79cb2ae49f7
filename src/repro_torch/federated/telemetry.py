"""Unified host-side telemetry: one registry for every engine's signals.

Before this module the repo proved its operational claims through eight
disconnected ad-hoc meters: ``DistContext.dispatches``, the serving
engine's hand-rolled ``stage_s`` wall-time dicts, shed/drop tallies,
``ClientHealth`` state flips, and wire-byte fields scattered through
``compress.py``.  This module is the single substrate they all report
through:

* **Counters / gauges** — labeled, plain-Python numeric cells.  Counters
  are monotone by convention but keep a ``set`` method because the
  benchmarks reset dispatch counts between timed sections
  (``engine.dispatches = 0`` still works through the back-compat property
  on :class:`repro_torch.federated.dist.DistDispatchMixin`).
* **Histograms** — log-bucketed (HDR-style): bucket edges grow by
  2^(1/8) (~9% per bucket), so p50/p99/p999 at million-sample scale cost
  a few hundred integer cells instead of a stored sample list, and a
  reported quantile (the geometric bucket midpoint) is within half a
  bucket (≤ ~4.4% relative) of the true order statistic.
* **Spans** — nestable ``with telemetry.span("solve", engine="serving")``
  context managers on the *monotonic* ``time.perf_counter`` clock (the
  wall clock steps backwards under NTP).  Each exit records the stage
  duration into a ``span_seconds`` histogram labeled with the
  ``/``-joined stage path, so per-stage p50/p99 fall out for free.
* **Flight recorder** — a bounded ring (``collections.deque(maxlen=...)``)
  of structured events: client demoted/readmitted, request shed by
  overflow/deadline, staleness drop, chaos fault injected, fp8 fallback,
  secure-agg mask recovery.  Serialized as JSON-lines
  (:meth:`Telemetry.events_jsonl`) for offline replay of a failed chaos
  gate.
* **Exposition** — :meth:`Telemetry.snapshot` (JSON-native dict),
  :meth:`Telemetry.prometheus` (Prometheus text format), and parsers
  (:func:`events_from_jsonl`, :func:`parse_prometheus`) that round-trip
  under test.

The registry is process-global (:func:`get_telemetry`) but injectable:
:func:`set_telemetry` swaps the default (the bench harness installs a
fresh registry per benchmark), and every instrumented component accepts
an explicit ``telemetry=`` handle.

Hard contracts:

* **Zero device work.**  Nothing in this module touches the card on a
  metric path — counters are integer adds, spans are two
  ``perf_counter`` calls, events are deque appends.  The only torch
  import is lazy, inside the optional :meth:`Telemetry.trace_window`
  profiler capture, which is inert unless ``profile_dir`` is set.
* **Near-free when disabled.**  ``Telemetry(enabled=False)`` turns
  spans into a shared no-op context manager and events/histogram
  convenience paths into early returns.  Counters still count — the
  dispatch contract the CI gate asserts is functional, not optional.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

# Log-bucket geometry: 8 buckets per octave → edge ratio 2^(1/8) ≈ 1.0905.
# ~372 buckets cover 1 ns .. 10^5 s, so memory is bounded regardless of
# sample count and a bucket midpoint is within ~4.4% of any sample in it.
_BUCKETS_PER_OCTAVE = 8
_LOG_BASE = math.log(2.0) / _BUCKETS_PER_OCTAVE

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Labeled numeric total (int or float, e.g. wire bytes).

    Plain Python arithmetic — safe on hot paths.  ``set`` exists for the
    benchmarks' reset-between-timed-sections idiom.
    """

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def set(self, value: float) -> None:
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter({self.name}{self.labels}={self.value})"


class Gauge:
    """Labeled last-value cell (compression ratio, model drift, ...)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Gauge({self.name}{self.labels}={self.value})"


class Histogram:
    """Log-bucketed latency histogram (HDR-style, bounded memory).

    ``observe(v)`` drops v into bucket ``floor(log(v) / log(2^(1/8)))``
    (non-positive values land in a dedicated zero bucket); ``quantile(q)``
    walks the cumulative counts and returns the geometric midpoint of the
    selected bucket — within one bucket of the true order statistic.
    """

    __slots__ = ("name", "labels", "counts", "zero_count", "count", "sum", "min", "max")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.counts: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v > 0.0:
            idx = math.floor(math.log(v) / _LOG_BASE)
            self.counts[idx] = self.counts.get(idx, 0) + 1
        else:
            self.zero_count += 1

    @staticmethod
    def bucket_of(v: float) -> int:
        """The bucket index a positive value lands in (tests use this to
        assert 'within one bucket' against raw-sample percentiles)."""
        return math.floor(math.log(float(v)) / _LOG_BASE)

    def quantile(self, q: float) -> float:
        """The q-quantile as the geometric midpoint of its bucket."""
        if self.count == 0:
            return math.nan
        target = max(1.0, q * self.count)
        seen = self.zero_count
        if seen >= target:
            return 0.0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= target:
                return math.exp((idx + 0.5) * _LOG_BASE)
        return self.max  # pragma: no cover - unreachable (counts sum to count)

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def p999(self) -> float:
        return self.quantile(0.999)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Histogram({self.name}{self.labels}, n={self.count})"


class _NullSpan:
    """Shared no-op span (disabled mode): enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: perf_counter at enter, histogram observe at exit.

    Nesting composes the stage path (``tick/solve``) from the per-thread
    span stack, so nested stages get their own histogram series.
    """

    __slots__ = ("_t", "_name", "_labels", "_path", "_t0")

    def __init__(self, t: "Telemetry", name: str, labels: Dict[str, Any]):
        self._t = t
        self._name = name
        self._labels = labels

    def __enter__(self) -> "_Span":
        stack = self._t._span_stack
        self._path = f"{stack[-1]}/{self._name}" if stack else self._name
        stack.append(self._path)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dt = time.perf_counter() - self._t0
        stack = self._t._span_stack
        if stack and stack[-1] == self._path:
            stack.pop()
        self._t.histogram("span_seconds", stage=self._path, **self._labels).observe(dt)
        return False


class Telemetry:
    """The registry: labeled counters/gauges/histograms, spans, and the
    flight-recorder event ring.  Process-global by default
    (:func:`get_telemetry`) but plain to construct and inject."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        ring: int = 4096,
        profile_dir: Optional[str] = None,
    ):
        self.enabled = enabled
        # torch.profiler trace-window target; None keeps trace_window a no-op
        self.profile_dir = profile_dir
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], Gauge] = {}
        self._hists: Dict[Tuple[str, _LabelKey], Histogram] = {}
        self._instances: Dict[str, int] = {}
        self._local = threading.local()
        self.events: deque = deque(maxlen=int(ring))
        self.events_dropped = 0
        self._seq = 0

    # ---- registry -------------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(
                    key, Counter(name, dict(sorted((k, str(v)) for k, v in labels.items())))
                )
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(
                    key, Gauge(name, dict(sorted((k, str(v)) for k, v in labels.items())))
                )
        return g

    def histogram(self, name: str, **labels: Any) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(
                    key, Histogram(name, dict(sorted((k, str(v)) for k, v in labels.items())))
                )
        return h

    def next_instance(self, kind: str) -> int:
        """Monotone per-kind instance ids, so N same-type engines own N
        distinct counter series (the benchmarks construct several serving
        engines and reset/read each one's dispatches independently)."""
        with self._lock:
            n = self._instances.get(kind, 0)
            self._instances[kind] = n + 1
            return n

    # ---- spans ----------------------------------------------------------

    @property
    def _span_stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **labels: Any):
        """Per-stage monotonic-clock span; a shared no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, labels)

    # ---- flight recorder ------------------------------------------------

    def event(self, kind: str, **fields: Any) -> None:
        """Append one structured event to the bounded ring."""
        if not self.enabled:
            return
        ring = self.events
        if ring.maxlen is not None and len(ring) == ring.maxlen:
            self.events_dropped += 1
        self._seq += 1
        ring.append(
            {"seq": self._seq, "wall": time.time(), "kind": kind, "fields": fields}
        )

    def events_jsonl(self) -> str:
        """The event ring as JSON-lines (one event per line)."""
        return "\n".join(json.dumps(ev, sort_keys=True) for ev in self.events)

    # ---- optional profiler window --------------------------------------

    @contextmanager
    def trace_window(self, label: str = "trace") -> Iterator[None]:
        """Optional ``torch.profiler`` capture around a code window.

        Inert (and torch-import-free) unless the registry is enabled AND
        ``profile_dir`` is set — the flag-gated escape hatch for on-device
        stage attribution; host metrics never need it.  The trace lands in
        ``profile_dir/<label>.json`` (Chrome trace format).
        """
        if not (self.enabled and self.profile_dir):
            yield
            return
        import os

        import torch  # lazy: the only torch touch in this module

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir, f"{label}.json"))

    # ---- exposition -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-native dict of every metric + the event ring.

        ``json.loads(json.dumps(snapshot()))`` is identity (round-trip
        under test); bucket keys are stringified for that reason.
        """
        return {
            "counters": [
                {"name": c.name, "labels": c.labels, "value": c.value}
                for c in self._counters.values()
            ],
            "gauges": [
                {"name": g.name, "labels": g.labels, "value": g.value}
                for g in self._gauges.values()
            ],
            "histograms": [
                {
                    "name": h.name,
                    "labels": h.labels,
                    "count": h.count,
                    "sum": h.sum,
                    "min": h.min if h.count else None,
                    "max": h.max if h.count else None,
                    "p50": None if h.count == 0 else h.p50,
                    "p99": None if h.count == 0 else h.p99,
                    "p999": None if h.count == 0 else h.p999,
                    "zero_count": h.zero_count,
                    "buckets": {str(k): v for k, v in sorted(h.counts.items())},
                }
                for h in self._hists.values()
            ],
            "events": list(self.events),
            "events_dropped": self.events_dropped,
        }

    def prometheus(self) -> str:
        """Prometheus text exposition (counters/gauges as-is; histograms as
        summary-style quantile series + ``_count``/``_sum``)."""
        lines: List[str] = []
        seen_type: set = set()

        def emit(name: str, labels: Dict[str, str], value: float, kind: str) -> None:
            if name not in seen_type:
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
                )
                lines.append(f"{name}{{{body}}} {value}")
            else:
                lines.append(f"{name} {value}")

        for c in self._counters.values():
            emit(c.name, c.labels, c.value, "counter")
        for g in self._gauges.values():
            emit(g.name, g.labels, g.value, "gauge")
        for h in self._hists.values():
            emit(h.name + "_count", h.labels, h.count, "gauge")
            emit(h.name + "_sum", h.labels, h.sum, "gauge")
            for q, label in ((0.5, "0.5"), (0.99, "0.99"), (0.999, "0.999")):
                if h.count:
                    emit(h.name, {**h.labels, "quantile": label}, h.quantile(q), "summary")
        return "\n".join(lines) + "\n"

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another registry's :meth:`snapshot` into this one.

        The multi-process aggregation path: subprocess benchmark workers
        (``bench_scaleout.py``, ``bench_tiers.py`` — each pinned to its own
        simulated device count) snapshot their own registries and the
        parent merges them, so dispatch counters and flight-recorder
        events survive the process boundary and ``check_regression.py``
        reads scale-out dispatches from ``telemetry_*.json`` like every
        other bench.  Counters ADD, gauges take the incoming last-write,
        histograms merge bucket-wise (quantiles stay within one bucket of
        the union stream), events append in arrival order (ring bounds
        still apply).
        """
        for c in snap.get("counters", ()):
            self.counter(c["name"], **c.get("labels", {})).inc(c["value"])
        for g in snap.get("gauges", ()):
            self.gauge(g["name"], **g.get("labels", {})).set(g["value"])
        for rec in snap.get("histograms", ()):
            h = self.histogram(rec["name"], **rec.get("labels", {}))
            if not rec.get("count"):
                continue
            h.count += int(rec["count"])
            h.sum += float(rec["sum"])
            h.zero_count += int(rec.get("zero_count", 0))
            if rec.get("min") is not None:
                h.min = min(h.min, float(rec["min"]))
            if rec.get("max") is not None:
                h.max = max(h.max, float(rec["max"]))
            for idx, n in rec.get("buckets", {}).items():
                idx = int(idx)
                h.counts[idx] = h.counts.get(idx, 0) + int(n)
        for ev in snap.get("events", ()):
            self.event(ev.get("kind", "event"), **ev.get("fields", {}))
        self.events_dropped += int(snap.get("events_dropped", 0))

    def reset(self) -> None:
        """Zero every metric in place and clear the event ring (instances
        hold live references to their cells, so cells are zeroed, not
        discarded)."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = 0.0
        for h in self._hists.values():
            h.counts.clear()
            h.zero_count = 0
            h.count = 0
            h.sum = 0.0
            h.min = math.inf
            h.max = -math.inf
        self.events.clear()
        self.events_dropped = 0
        self._seq = 0


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


# ---- parsers (round-trip counterparts of the expositions) ---------------


def events_from_jsonl(text: str) -> List[dict]:
    """Parse :meth:`Telemetry.events_jsonl` back into event dicts."""
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def parse_prometheus(text: str) -> Dict[Tuple[str, _LabelKey], float]:
    """Parse the text exposition back to ``{(name, label_key): value}``.

    Minimal by design (no escapes beyond :func:`_escape_label`'s, which
    our label values never trigger) — it exists so the exposition
    round-trips under test, not as a general Prometheus client.
    """
    out: Dict[Tuple[str, _LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        metric, _, value = line.rpartition(" ")
        if "{" in metric:
            name, _, body = metric.partition("{")
            body = body.rstrip("}")
            labels = {}
            for part in body.split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                labels[k] = v.strip('"')
            key = _label_key(labels)
        else:
            name, key = metric, ()
        out[(name, key)] = float(value)
    return out


def dispatch_summary(snapshot: dict) -> Dict[str, int]:
    """Per-engine host→device dispatch totals from a snapshot.

    Sums the per-instance ``engine_dispatches_total`` series by engine
    name — the exact numbers ``benchmarks/check_regression.py`` gates, so
    the CI gate and the telemetry layer cannot diverge.
    """
    out: Dict[str, int] = {}
    for c in snapshot.get("counters", []):
        if c.get("name") == "engine_dispatches_total":
            eng = c.get("labels", {}).get("engine", "engine")
            out[eng] = out.get(eng, 0) + int(c.get("value", 0))
    return out


# ---- the process-global default (injectable) ----------------------------

_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    """The process-global registry every component defaults to."""
    return _GLOBAL


def set_telemetry(t: Telemetry) -> Telemetry:
    """Swap the process-global registry; returns the previous one.

    Components capture the registry at CONSTRUCTION, so a swap scopes the
    instrumentation of everything built afterwards (the bench harness
    installs a fresh registry per benchmark module this way).
    """
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = t
    return prev
