"""``correct`` comes out false under the control and under each planted fault.

These drive a whole run of the statistics driver on the CPU at a small
size (the harness's look for a card skipped), with the landmarks cell's
limits: a sound run is correct; each control (the reference in the next
lower precision, whole or in one stage, in the program's place) fails every
number it reads; and each fault the cell can have, planted in the timed
path, fails the check.
The exchange between chips does not exist on this one-chip cell.
"""
import time

import pytest
import torch

from perfbench import harness

CELL = "stats-rf-mnv2-landmarks"
CONFIG = {"name": "rf-small", "family": "rff", "compute_dtype": "float32", "d": 32,
          "n_random_features": 96, "rff_sigma": 10.0, "ridge_lambda": 0.01, "class_scale": 3.0,
          "noise": 2.0}
TRAFFIC = {"driver": "stats", "n_clients": 24, "n_samples": 720, "n_classes": 12,
           "size_sigma": 1.0, "label_alpha": 0.1, "clients_per_round": 4,
           "clients_per_shard": 4, "layout_seed": 4}


def _run(control=False):
    bench = harness.manifest()
    cell = harness.load_json(harness.HERE / "workloads" / f"{CELL}.json")
    ctx = harness.Context(name=CELL, config=CONFIG, traffic=TRAFFIC, cell=cell, seed=2**31 + 11,
                          seconds=0, trace=False, device=torch.device("cpu"),
                          t_start=time.perf_counter(), control=control)
    out = harness.driver("stats").run(ctx)
    line = harness.result(bench, ctx, out, {"platform": "cpu"})
    return line, out


def test_a_sound_run_is_correct():
    line, _ = _run()
    assert line["correct"], line["compared"]
    assert list(line)[-1] == "compared"


def test_the_control_fails_every_number_it_reads():
    """Each control (whole, the map alone, the statistics alone) read in the
    program's place fails every number it reads, and the harness's result
    with its readings is not correct."""
    line, out = _run(control=True)
    assert line["correct"]
    assert set(out["control"]) == {"tf32", "tf32_map", "tf32_stats"}
    bench = harness.manifest()
    for control, readings in out["control"].items():
        for name, value in readings.items():
            assert value > line["compared"][name]["limit"], (control, name, value)
        swapped = dict(out, compared={k: {"value": readings.get(k, c["value"]), "limit": c["limit"]}
                                      for k, c in out["compared"].items()})
        ctx = harness.context(CELL, 1, 0, False, torch.device("cpu"), 0.0, bench)
        assert not harness.result(bench, ctx, swapped, {})["correct"], control


def _state_unchanged(monkeypatch):
    from repro_torch.federated.engine import AccumulationEngine

    monkeypatch.setattr(AccumulationEngine, "accumulate",
                        lambda self, acc, packed, params=None: acc)


def _half_the_batch(monkeypatch):
    """Every other slot left out, the rest counted twice (the mean over the rest)."""
    from repro_torch.core.fed3r import Fed3RStats
    from repro_torch.federated.engine import AccumulationEngine, EngineStats

    accumulate = AccumulationEngine.accumulate

    def half(self, acc, packed, params=None):
        mask = packed.mask.copy()
        mask.reshape(-1, mask.shape[-1])[1::2] = 0.0
        new = accumulate(self, acc, packed._replace(mask=mask), params)
        twice = [2 * n - o for n, o in zip(
            (new.stats.A, new.stats.b, new.stats.n, new.class_counts),
            (acc.stats.A, acc.stats.b, acc.stats.n, acc.class_counts))]
        return EngineStats(Fed3RStats(*twice[:3]), twice[3])
    monkeypatch.setattr(AccumulationEngine, "accumulate", half)


def _answer_altered(monkeypatch):
    from repro_torch.core import fed3r

    solve = fed3r.solve
    monkeypatch.setattr(fed3r, "solve", lambda stats, lam, normalize=True:
                        solve(stats, lam, normalize).roll(1, dims=1))


def _label_altered(monkeypatch):
    from repro_torch.data import pipeline

    pack = pipeline.pack_client_shards

    def altered(*args, **kwargs):
        packed = pack(*args, **kwargs)
        packed.labels[0, 0, 0] = (packed.labels[0, 0, 0] + 1) % TRAFFIC["n_classes"]
        return packed
    monkeypatch.setattr(pipeline, "pack_client_shards", altered)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_batch, _answer_altered,
                                   _label_altered], ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    line, _ = _run()
    assert not line["correct"], line["compared"]
