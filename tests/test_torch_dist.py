"""The port's distributed layer on 4 gloo ranks on the CPU, against the reference.

Twins ``tests/test_dist.py``'s mesh, ``DistConfig``, two-stage, packer and
shard-count tests and ``tests/test_system.py:77`` (``aggregate_mesh``) on
the port's one-process-a-rank model: one 4-rank world
(:func:`repro_torch.launch.world.run_world`, a ``file://`` store, a
deadline) runs :func:`repro_torch.launch.dist_check.layer_program`, whose
results the layer tests read.  A second world runs ``launch/train.py``'s
``run`` over the mesh (:func:`repro_torch.launch.dist_check.train_program`)
against the one-process driver, and one ``torchrun`` of its command line
covers ``main`` and :func:`repro_torch.launch.world.init_world`.  The rank
programs live in the package, so no rank imports JAX.  The engines'
sharded runs are in ``tests/test_torch_dist_engines.py``.

Where the reference takes its device count from ``jax.devices()``, the port
counts the world's ranks; a ``"model"`` axis builds, an SSM's backward
runs under it (its gathered gradient against ``jax.grad`` of the
reference), and a cross-attention whose (k, v) the rules split over the
encoder's frames runs under it and matches the reference (the sharded
layers themselves are in ``tests/test_torch_tp.py``,
``tests/test_torch_tp_families.py``, ``tests/test_torch_tp_train.py``
and ``tests/test_torch_layouts.py``).
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    pack_arrival_waves,
    pack_client_shards,
    pack_cohort_batches,
    pack_personal_cohort,
)
from repro_torch.federated.algorithms import make_algorithm  # noqa: E402
from repro_torch.federated.dist import DistConfig, DistContext  # noqa: E402
from repro_torch.federated.personalization import (  # noqa: E402
    PersonalizationEngine,
    PersonalizeConfig,
)
from repro_torch.federated.round_engine import RoundConfig, RoundEngine  # noqa: E402
from repro_torch.launch import dist_check, train  # noqa: E402
from repro_torch.launch.dist_check import C, D, LAM, grid_clients  # noqa: E402
from repro_torch.launch.world import run_world, single_rank_world  # noqa: E402
from repro_torch.sharding.specs import data_parallel_spec, replicated, stats_specs  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_families import check_cross_split, cross_split_reference  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return run_world(dist_check.layer_program, WORLD, backend="gloo", device="cpu",
                     timeout_s=150)


# ---------------------------------------------------------------------------
# host meshes
# ---------------------------------------------------------------------------


def test_make_host_mesh_raises_on_indivisible(ranks):
    raised = ranks[0]["raises"]
    for case in ("model_parallel=world+1", "model_parallel=0", "pods=0", "pods=world+1"):
        assert raised[case][0] == "ValueError", case


def test_tensor_parallelism_raises_naming_its_item(ranks):
    """A "model" axis of 2 builds (host and tier meshes); the layout that
    raised under it until the sharded cross-attention learned it (a
    cross-attention (k, v) split over the frames: Whisper's smoke with 3
    kv heads) now runs, and its prefill and decode logits match the
    reference's unsharded model within 1e-5 of max|logit|."""
    tp = ranks[0]["model_parallel=2"]
    assert tp["host"] == (("data", "model"), ("data",), (WORLD // 2, 2))
    assert tp["tiers"] == (("edge", "model"), ("edge",), (WORLD // 2, 2))
    check_cross_split(tp["cross-attention split"], 2, cross_split_reference())


def test_ssm_backward_under_a_model_axis_matches_the_reference(ranks):
    """An SSM's ``lm_loss`` gradient over (data 2, model 2) on
    ``seeded_factory(0)`` weights, gathered over "model", against
    ``jax.grad`` of the reference's on the same weights and the whole
    batch: each leaf within 1e-5 of its max|g| (A_log, whose gradient sums
    a chunk's decays, within 1e-4)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.sharding.shard import full_params, seeded_factory
    from repro_torch.sharding.specs import map_with_path

    arch = dist_check.SSM_ARCH
    cfg = get_config(arch).replace(dtype="float32")
    whole = full_params(cfg, seeded_factory(0), "cpu")
    layers = whole.pop("layers")
    jparams = {k: jax.tree.map(lambda t: jnp.asarray(t.numpy()), v) for k, v in whole.items()}
    jparams["layers"] = jax.tree.map(lambda *ts: jnp.asarray(np.stack([t.numpy() for t in ts])),
                                     *layers)
    jcfg = jget_config(arch).replace(dtype="float32", scan_layers=False)
    jb = {k: jnp.asarray(v) for k, v in dist_check.grad_batch(cfg).items()}
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jax.grad(
        lambda p: jmodel.lm_loss(jcfg, p, jb))(jparams)), device="cpu")
    got = ranks[0]["model_parallel=2"]["ssm gradient"]
    flat = {}
    map_with_path(got, lambda path, x: flat.__setitem__("/".join(path), x))
    checked = []

    def check(path, w):
        p = "/".join(path)
        rel = 1e-4 if p.endswith("A_log") else 1e-5
        assert float(np.abs(flat[p] - w.numpy()).max()) <= rel * float(w.abs().max()), p
        checked.append(p)

    map_with_path(want, check)
    assert sorted(checked) == sorted(flat)


def test_make_host_mesh_axis_layouts(ranks):
    names, data_axes, dp, shape = ranks[0]["layouts"]["host"]
    assert names == ("data", "model") and data_axes == ("data",)
    assert dp == WORLD and shape == (WORLD, 1)


def test_make_host_mesh_pod_variant_is_three_axis(ranks):
    names, data_axes, dp, shape = ranks[0]["layouts"]["pods"]
    assert names == ("pod", "data", "model") and data_axes == ("pod", "data")
    assert shape == (2, WORLD // 2, 1) and dp == WORLD


def test_make_tier_host_mesh_layout_and_validation(ranks):
    names, data_axes, dp, shape = ranks[0]["layouts"]["tiers"]
    assert names == ("region", "edge", "model") and data_axes == ("region", "edge")
    assert shape == (2, WORLD // 2, 1) and dp == WORLD
    for case in ("tier shape", "tier model name", "tier names"):
        assert ranks[0]["raises"][case][0] == "ValueError", case


def test_n_chips_counts_every_rank(ranks):
    assert ranks[0]["layouts"]["n_chips"] == (WORLD, WORLD, WORLD)


def test_block_specs_pick_a_ranks_block():
    x = torch.arange(24.0).reshape(4, 6)
    spec = data_parallel_spec(("pod", "data"), axis=1)
    assert torch.equal(spec.block(x, 1, 3), x[:, 2:4])
    assert replicated().block(x, 2, 4) is x
    with pytest.raises(ValueError, match="does not split"):
        spec.block(x, 0, 4)
    with pytest.raises(ValueError):
        data_parallel_spec(())
    stats = stats_specs(d=16)
    assert stats.A == stats.b == data_parallel_spec(("model",)) and stats.n == replicated()
    assert stats_specs(d=15, model_size=2).A == replicated()


def test_meshes_need_an_initialized_world():
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        make_host_mesh(device_type="cpu")


# ---------------------------------------------------------------------------
# DistConfig / DistContext
# ---------------------------------------------------------------------------


def test_dist_config_validation(ranks):
    with pytest.raises(ValueError):
        DistConfig(aggregation="allgather")
    with pytest.raises(ValueError, match="DistConfig\\(mesh=...\\)"):
        DistConfig(aggregation="psum")  # no mesh: nothing to reduce over
    cfg = ranks[0]["config"]
    assert cfg["merge+mesh"][0] == "ValueError"  # merge is local


def test_dist_config_resolves_axes_from_mesh(ranks):
    assert ranks[0]["config"]["axis_names"] == ("data",)
    assert ranks[0]["config"]["data_shards"] == WORLD


def test_dist_context_merge_all_reduce_is_identity():
    ctx = DistContext(DistConfig())
    tree = {"a": torch.ones(3)}
    assert ctx.all_reduce(tree) is tree
    assert ctx.local_block(tree["a"]) is tree["a"]
    assert ctx.gather_blocks([tree["a"]])[0] is tree["a"]
    ctx.dispatch()
    ctx.dispatch()
    assert ctx.dispatches == 2


def test_two_stage_psum_equals_flat_psum_on_pod_mesh(ranks):
    out = ranks[0]["two_stage"]
    # exact grid values: any reduction order is bit-identical
    assert np.array_equal(out["two"], out["flat"])
    np.testing.assert_allclose(out["two"], out["rows"].sum(0), rtol=0, atol=0)


def test_every_rank_holds_the_same_bits(ranks):
    for r in ranks[1:]:
        assert dist_check.digest(r) == dist_check.digest(ranks[0])


def test_fed3r_psum_aggregation_on_host_mesh(ranks):
    """The datacenter aggregation (psum over data) == the simulator's merge,
    and == the reference's client statistics of the same samples."""
    agg, full = ranks[0]["aggregate_mesh"]["agg"], ranks[0]["aggregate_mesh"]["full"]
    for got, want in zip(agg, full):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(1)  # layer_program's draw
    feats = rng.normal(size=(4 * WORLD, 8)).astype(np.float32)
    labels = rng.integers(0, 3, size=4 * WORLD).astype(np.int32)
    ref = jfed3r.client_stats(jnp.asarray(feats), jnp.asarray(labels), 3)
    np.testing.assert_allclose(agg[0], np.asarray(ref.A), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(agg[1], np.asarray(ref.b), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# packer dp-padding: fully-masked blocks are exact no-ops
# ---------------------------------------------------------------------------


def _acc(packed):
    return dist_check.run_accumulate(packed)


def test_pack_client_shards_dp_padding_is_bitwise_noop():
    clients = grid_clients(0, [5, 9, 2, 7, 3])
    plain = pack_client_shards(clients, 2, max_n=16)
    padded = pack_client_shards(clients, 2, max_n=16, num_shards=4)
    assert padded.n_shards % 4 == 0 and padded.n_clients == plain.n_clients
    a, b = _acc(plain), _acc(padded)
    for k in ("A", "b", "counts"):
        assert torch.equal(a[k], b[k])


def test_pack_arrival_waves_dp_padding_is_bitwise_noop():
    waves = [grid_clients(t, [6] * (1 + t % 3)) for t in range(4)]
    plain = pack_arrival_waves(waves)
    padded = pack_arrival_waves(waves, num_shards=4)
    assert padded.clients_per_wave % 4 == 0
    a, b = dist_check.run_stream(plain), dist_check.run_stream(padded)
    assert torch.equal(a["L"], b["L"]) and torch.equal(a["W"], b["W"])


def test_pack_cohort_batches_dp_padding_is_noop():
    clients = grid_clients(1, [20, 12, 17])
    plain = pack_cohort_batches(clients, 8, 3)
    padded = pack_cohort_batches(clients, 8, 3, num_shards=4)
    assert padded.cohort % 4 == 0 and padded.n_clients == 3
    params0 = {"W": torch.zeros((D, C), dtype=torch.float32)}
    rc = RoundConfig(algo=make_algorithm("fedavg"), client_lr=0.1, n_total_clients=3)
    eng = RoundEngine(rc, dist_check.linear_loss, {"W": 1.0})
    sa = eng.step(eng.init(params0), plain)
    sb = eng.step(eng.init(params0), padded)
    np.testing.assert_allclose(sa.params["W"].numpy(), sb.params["W"].numpy(), rtol=0, atol=1e-7)


def test_pack_personal_cohort_dp_padding_is_noop():
    clients = grid_clients(2, [12, 9, 15])
    plain = pack_personal_cohort(clients, holdout_frac=0.25)
    padded = pack_personal_cohort(clients, holdout_frac=0.25, num_shards=4)
    assert padded.cohort % 4 == 0 and padded.n_clients == 3
    fac = fed3r.factored_update(
        fed3r.init_factored(D, C, LAM, "cpu"),
        torch.from_numpy(np.concatenate([x for x, _ in clients])),
        torch.from_numpy(np.concatenate([y for _, y in clients])))
    eng = PersonalizationEngine(PersonalizeConfig(n_classes=C), device="cpu")
    ha, hb = eng.solve_heads(fac, plain), eng.solve_heads(fac, padded)
    real = np.asarray(padded.client_ids) >= 0
    assert torch.equal(ha.alpha, hb.alpha[torch.from_numpy(real)])
    np.testing.assert_allclose(ha.W.numpy(), hb.W.numpy()[real], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# shard-count invariance: data-parallel 1 vs 4 on the SAME packed arrays
# ---------------------------------------------------------------------------


def test_shard_count_invariance_stats_and_stream(ranks):
    with single_rank_world("gloo", "cpu") as dev:
        one = dist_check.invariance_program(0, 1, dev)
    four = ranks[0]["invariance"]
    # same A, b, L, W at data-parallel 1 vs 4 — bitwise on the exact grid
    for k in ("A", "b", "L", "Ws"):
        assert np.array_equal(one[k], four[k]), k
    np.testing.assert_allclose(one["W"], four["W"], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the entry point: launch/train.py over the mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    return run_world(dist_check.train_program, WORLD, backend="gloo", device="cpu",
                     timeout_s=150, args=(root,))


@pytest.fixture(scope="module")
def train_one():
    """The one-process driver on the same sizes: phase 1 alone, then one
    and two FT rounds from the seeded head."""
    kw = dict(dist_check.TRAIN, device="cpu", verbose=False)
    return {"phase1": train.run(dist_check.TRAIN_ARCH, **kw),
            "ft1": train.run(dist_check.TRAIN_ARCH, rounds=1, use_fed3r_init=False, **kw),
            "ft2": train.run(dist_check.TRAIN_ARCH, rounds=2, use_fed3r_init=False, **kw)}


def test_train_run_sharded_phase1_matches_one_process(train_ranks, train_one):
    """Phase 1 over 4 ranks (2 shards padded to 4, one a rank): A and b
    within fp32 summation of 4 partials (1e-6 of max|·|) of the one
    process's strict left fold, the same test accuracy, and every rank's
    bits equal."""
    got, want = train_ranks[0], train_one["phase1"]
    for r in train_ranks[1:]:
        assert dist_check.digest(r) == dist_check.digest(got)
    for k in ("A", "b"):
        w = getattr(want["stats"], k).numpy()
        assert float(np.abs(got[k] - w).max()) <= 1e-6 * float(np.abs(w).max()), k
    assert got["fed3r_acc"] == want["fed3r_acc"]


def test_train_run_sharded_ft_round_and_resume_match_one_process(train_ranks, train_one):
    """One FT round over 4 ranks (a cohort of 4, one client a rank), then a
    resume from its checkpoint to round 2: each within the round engine's
    rtol 1e-5, atol 1e-6 of the one-process run of as many rounds."""
    got = train_ranks[0]
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(train_one["ft1"]["ft"]["state"].params["backbone"]),
        tree_leaves(train_one["ft1"]["params0"])))
    assert moved > 1e-3  # the round trains: a real comparison
    for name, key in (("theta1", "ft1"), ("theta2", "ft2")):
        want = train_one[key]["ft"]["state"].params
        for a, b in zip(tree_leaves(got[name]), tree_leaves(want)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    assert got["resumed_rounds"] == [2]
    assert got["ft_acc"] == (train_one["ft1"]["ft"]["ft_acc"], train_one["ft2"]["ft"]["ft_acc"])


def test_train_run_only_rank0_writes_checkpoints(train_ranks):
    """Each rank was given a checkpoint directory of its own: rank 0 wrote
    both rounds' snapshots, the others nothing, and they resumed all the
    same (rank 0's snapshot travels by broadcast)."""
    assert train_ranks[0]["files"] == ["ckpt_1.npz", "ckpt_2.npz"]
    assert all(r["files"] == [] for r in train_ranks[1:])
    assert all(r["resumed_rounds"] == [2] for r in train_ranks)


TORCHRUN_ARGS = ["--rounds", "1", "--clients", "8", "--per-round", "4", "--seq-len", "16",
                 "--local-batch", "8"]


def test_train_main_under_torchrun(tmp_path, capsys, monkeypatch):
    """The command line under ``torchrun`` (4 gloo ranks on the CPU, joined
    over env:// by init_world): rank 0 alone prints, its accuracies equal
    the one-process driver's, and its checkpoint is the only file."""
    ckpt = str(tmp_path / "ck")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(WORLD), "-m", "repro_torch.launch.train", "--backend", "gloo", "--device", "cpu",
           *TORCHRUN_ARGS, "--ckpt-dir", ckpt]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=150)
    finally:  # torchrun's ranks too, whatever happened
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert [ln.split()[0] for ln in lines] == ["[fed3r]", "[ft:feat]"], out
    assert f"over {WORLD} ranks" in lines[0]
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu", *TORCHRUN_ARGS])
    capsys.readouterr()
    train.main()
    one = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]

    def accs(ls):
        return [ln.split("acc=")[1].split()[0] for ln in ls]

    assert accs(lines) == accs(one)
    assert os.listdir(ckpt) == ["ckpt_1.npz"]


def test_train_main_names_its_backend(monkeypatch):
    """More than one rank and no --backend: the driver refuses, and picks
    none itself."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main()
