"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import re

import pytest

from perfbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1] == "perfbench/run.py"
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for e in BENCH[section]:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs_files_and_reductions():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells_name_their_files():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in configs and NAME.match(w["traffic"])
        traffic = harness.load_json(harness.HERE / "traffic" / f"{w['traffic']}.json")
        harness.driver(traffic["driver"])
        cell = harness.load_json(harness.HERE / "workloads" / f"{w['name']}.json")
        assert set(cell["limits"]) == {"A_gap", "b_gap", "solve_resid", "n_gap", "counts_gap"}


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # every cell: setup_s, one more end-to-end metric, one per-layer metric
        assert sum(harness.applies(m, cell) for m in BENCH["end_to_end"]) >= 2
        assert any(harness.applies(m, cell) for m in BENCH["per_layer"])


def test_limits_are_numbers():
    for w in BENCH["workloads"]:
        limits = harness.load_json(harness.HERE / "workloads" / f"{w['name']}.json")["limits"]
        assert all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
        json.dumps(limits, allow_nan=False)
