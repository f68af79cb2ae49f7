"""What ``perfbench/run.py`` loads and reads: no JAX, no JAX package, nothing
under ``benchmarks/``; and the references load nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = harness.ROOT

# a small run through the driver, in a fresh interpreter set up as
# run.py sets itself up, every file it opens recorded
WALK = r"""
import sys, time, json
sys.path[:0] = [{root!r}, {root!r} + "/src"]
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args else None)
import torch
from perfbench import harness
config = {{"family": "rff", "compute_dtype": "float32", "d": 8, "n_random_features": 16,
          "rff_sigma": 4.0, "ridge_lambda": 0.01, "class_scale": 3.0, "noise": 2.0}}
traffic = {{"driver": "stats", "n_clients": 8, "n_samples": 64, "n_classes": 4, "size_sigma": 1.0,
            "label_alpha": 0.1, "clients_per_round": 4, "clients_per_shard": 2, "layout_seed": 1}}
bench = harness.manifest()
cell = bench["workloads"][0]["name"]
ctx = harness.Context(name=cell, config=config, traffic=traffic,
                      cell=harness.load_json(harness.HERE / "workloads" / f"{{cell}}.json"),
                      seed=3, seconds=0, trace=False, device=torch.device("cpu"),
                      t_start=time.perf_counter())
out = harness.driver("stats").run(ctx)
harness.result(bench, ctx, out, {{}})
for m in bench["per_layer"]:
    harness.metric_reader(m["name"])
print(json.dumps({{"modules": sorted(sys.modules),
                  "files": sorted({{getattr(m, "__file__", None) or ""
                                    for m in list(sys.modules.values())}}),
                  "opened": sorted(set(opened))}}))
"""


@pytest.fixture(scope="module")
def walked():
    proc = subprocess.run([sys.executable, "-c", WALK.format(root=str(ROOT))], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_jax_is_loaded(walked):
    tops = {m.split(".")[0] for m in walked["modules"]}
    assert not tops & set(harness.BANNED), sorted(tops & set(harness.BANNED))
    assert "repro_torch" in tops  # compared whole: the port's name begins with "repro"


def test_nothing_comes_from_the_jax_package_or_benchmarks(walked):
    for path in walked["files"] + walked["opened"]:
        p = Path(path).resolve() if path else None
        if p is None:
            continue
        for banned in (ROOT / "benchmarks", ROOT / "src" / "repro"):
            assert banned not in p.parents and p != banned, path


REFERENCES = sorted(p.stem for p in (ROOT / "perfbench" / "reference").glob("*.py"))


@pytest.mark.parametrize("name", REFERENCES)
def test_a_reference_imports_nothing_of_the_port(name):
    tree = ast.parse((ROOT / "perfbench" / "reference" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for mod in mods:
            assert mod.split(".")[0] not in {"repro_torch", *harness.BANNED}, (name, mod)
            assert not mod.startswith(("perfbench.families", "perfbench.drivers")), (name, mod)


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           harness.manifest()["workloads"][0]["name"], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_port_there_is_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           harness.manifest()["workloads"][0]["name"], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           harness.manifest()["workloads"][0]["name"], "--seed", "2147483999",
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
