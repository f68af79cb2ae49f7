"""The port's copy of the telemetry layer (``repro_torch.federated.telemetry``)
against the reference's, on the same calls (the twin of
``tests/test_telemetry.py``'s histogram, exposition, ring, disabled-mode
and span tests):

* histograms: both packages give the same p50 / p99 / p999, each within one
  log bucket of the raw order statistic, and the same zero bucket;
* the snapshot (JSON), Prometheus text and event JSONL round-trip through
  the port's parsers and equal the reference's (an event's ``wall`` clock
  aside);
* the flight recorder is the same bounded ring: capped, drops counted,
  sequence numbers monotone;
* disabled mode is a structural no-op whose counters still count, at the
  reference's overhead bound;
* nested spans record the same stage paths.
"""
import json
import time

import numpy as np
import pytest

from repro.federated import telemetry as jtel
from repro_torch.federated import telemetry as tel

PACKAGES = {"port": tel, "reference": jtel}


def _no_wall(events):
    return [{k: v for k, v in ev.items() if k != "wall"} for ev in events]


def _populated(mod):
    t = mod.Telemetry(ring=128)
    t.counter("engine_dispatches_total", engine="accumulation", inst="0").inc(7)
    t.counter("wire_bytes_sent_total", kind="int8", inst="1").inc(4096)
    t.gauge("wire_compression_ratio", kind="int8", inst="1").set(3.98)
    h = t.histogram("span_seconds", stage="solve", engine="serving")
    for v in (1e-4, 2e-4, 5e-3, 0.0):
        h.observe(v)
    t.event("client_demoted", client=3, round=2)
    t.event("request_shed", reason="overflow", tenant=17)
    return t


def test_histogram_quantiles_match_the_reference_within_one_bucket_of_raw():
    rng = np.random.default_rng(0)
    samples = np.exp(rng.normal(-7.0, 1.5, size=20_000))  # latency-shaped
    hists = {name: mod.Histogram("lat", {}) for name, mod in PACKAGES.items()}
    for s in samples:
        for h in hists.values():
            h.observe(float(s))
    got, want = hists["port"], hists["reference"]
    for q, est in ((0.50, got.p50), (0.99, got.p99), (0.999, got.p999)):
        raw = float(np.quantile(samples, q))
        assert abs(tel.Histogram.bucket_of(est) - tel.Histogram.bucket_of(raw)) <= 1, (q, est, raw)
        assert est == want.quantile(q)
    assert (got.count, got.sum, got.min, got.max) == (want.count, want.sum, want.min, want.max)
    assert got.count == len(samples)
    np.testing.assert_allclose(got.sum, samples.sum(), rtol=1e-6)
    assert got.min <= samples.min() and got.max >= samples.max()
    assert got.counts == want.counts


@pytest.mark.parametrize("package", list(PACKAGES))
def test_zero_and_negative_land_in_the_zero_bucket(package):
    h = PACKAGES[package].Histogram("lat", {})
    for v in (0.0, -1.0, 1.0):
        h.observe(v)
    assert h.zero_count == 2 and h.count == 3
    assert h.quantile(0.5) == 0.0  # the zero bucket holds the median


def test_snapshot_json_roundtrip_equals_the_references():
    snap, want = _populated(tel).snapshot(), _populated(jtel).snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert _no_wall(snap.pop("events")) == _no_wall(want.pop("events"))
    assert snap == want


def test_prometheus_roundtrip_equals_the_references():
    t = _populated(tel)
    text = t.prometheus()
    assert text == _populated(jtel).prometheus()
    parsed = tel.parse_prometheus(text)
    assert parsed == jtel.parse_prometheus(text)
    snap = t.snapshot()
    for c in snap["counters"] + snap["gauges"]:
        key = tuple(sorted((k, str(v)) for k, v in c["labels"].items()))
        assert parsed[(c["name"], key)] == pytest.approx(c["value"])
    for h in snap["histograms"]:
        key = tuple(sorted((k, str(v)) for k, v in h["labels"].items()))
        assert parsed[(h["name"] + "_count", key)] == h["count"]
        assert parsed[(h["name"] + "_sum", key)] == pytest.approx(h["sum"])


def test_events_jsonl_roundtrip_equals_the_references():
    t = _populated(tel)
    back = tel.events_from_jsonl(t.events_jsonl())
    assert back == list(t.events)
    assert [ev["kind"] for ev in back] == ["client_demoted", "request_shed"]
    assert _no_wall(back) == _no_wall(jtel.events_from_jsonl(_populated(jtel).events_jsonl()))


@pytest.mark.parametrize("package", list(PACKAGES))
def test_event_ring_is_bounded_and_counts_drops(package):
    t = PACKAGES[package].Telemetry(ring=64)
    for i in range(10_000):
        t.event("tick", i=i)
    assert len(t.events) == 64
    assert t.events_dropped == 10_000 - 64
    assert [ev["seq"] for ev in t.events] == list(range(10_000 - 63, 10_001))


def test_disabled_mode_is_noop_but_counters_count():
    snaps = {}
    for name, mod in PACKAGES.items():
        t = mod.Telemetry(enabled=False)
        assert t.span("a") is t.span("b", x=1)  # one shared null span
        with t.span("a"):
            pass
        t.event("client_demoted", client=0)
        assert len(t.events) == 0
        c = t.counter("engine_dispatches_total", engine="e", inst="0")
        c.inc()
        assert c.value == 1  # the dispatch contract survives disabling
        snaps[name] = t.snapshot()
    assert snaps["port"]["histograms"] == []  # no span histogram created
    assert snaps["port"] == snaps["reference"]


def test_disabled_mode_overhead_regression():
    t = tel.Telemetry(enabled=False)
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with t.span("stage", engine="x"):
            pass
        t.event("tick")
    wall = time.perf_counter() - t0
    # the reference's bound: ~3 µs an iteration on a shared CI box
    assert wall < 0.3 * (n / 100_000) * 10, f"disabled-mode loop took {wall:.3f}s"


def test_span_paths_nest_as_the_references():
    stages = {}
    for name, mod in PACKAGES.items():
        t = mod.Telemetry()
        with t.span("retire", engine="async"):
            with t.span("fold", engine="async"):
                pass
        stages[name] = {h["labels"]["stage"] for h in t.snapshot()["histograms"]
                        if h["name"] == "span_seconds"}
    assert stages["port"] == stages["reference"] == {"retire", "retire/fold"}
