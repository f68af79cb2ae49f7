"""The port's cohort round engine against its per-client loop and the reference.

Twins ``tests/test_round_engine.py`` on the port (``repro_torch``), on the
CPU, and adds port-against-reference rounds:

* the engine (``torch.func.vmap`` of ``local_update`` over the cohort, the
  weighted delta one ``tensordot``) against ``ReferenceLoop`` for all six
  algorithms, and the Scaffold variates, within the reference test's fp32
  tolerance (rtol 1e-5, atol 1e-6: the two aggregate in different orders);
* freeze strategies (frozen leaves bitwise unchanged), cohort-permutation
  bitwise invariance, padded slots as no-ops — with client 0 in the padded
  cohort, the row a clamped padded id would race for;
* the copied sampler, the ServerState checkpoint round trip, stop/resume
  bitwise;
* ``pack_cohort_batches`` bitwise the reference's, and 3 rounds of the
  linear and the feature-finetune tasks within 1e-5 of max|θ| of the
  reference's engine for every algorithm (fp32 reassociation only: both
  take the same SGD steps on the same packed batches);
* the psum backend's validation, and on a one-rank world its round bitwise
  the merge engine's (the 4-rank rounds are in
  ``tests/test_torch_dist_engines.py``).

Inputs come from the reference's ``make_federated_features`` (numpy), the
head inits from ``numpy.random.default_rng``.  The step under
``torch.cuda.set_sync_debug_mode("error")`` needs the card: it is in
``test_torch_kernels.py``, which runs where JAX is not installed.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.data import make_federated_features  # noqa: E402
from repro.data.pipeline import pack_cohort_batches as jpack_cohort_batches  # noqa: E402
from repro.federated.algorithms import make_algorithm as jmake_algorithm  # noqa: E402
from repro.federated.fed3r_driver import feature_finetune_task as jft_task  # noqa: E402
from repro.federated.round_engine import RoundConfig as JRoundConfig  # noqa: E402
from repro.federated.round_engine import RoundEngine as JRoundEngine  # noqa: E402
from repro.federated.sampling import sample_round as jsample_round  # noqa: E402
from repro.federated.simulator import linear_head_task as jlinear_head_task  # noqa: E402
from repro.federated.simulator import pack_round as jpack_round  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs.base import FederatedConfig  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset, pack_cohort_batches  # noqa: E402
from repro_torch.federated import engine as engine_lib  # noqa: E402
from repro_torch.federated.algorithms import (  # noqa: E402
    make_algorithm,
    server_init,
    server_state_from_tree,
)
from repro_torch.federated.dist import DistConfig  # noqa: E402
from repro_torch.federated.fed3r_driver import feature_finetune_task  # noqa: E402
from repro_torch.federated.round_engine import ReferenceLoop, RoundConfig, RoundEngine  # noqa: E402
from repro_torch.federated.sampling import ClientSampler, sample_round  # noqa: E402
from repro_torch.federated.simulator import linear_head_task, pack_round, run_federated  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.world import single_rank_world  # noqa: E402

N_CLIENTS, C, D = 12, 4, 8
ALGOS = ["fedavg", "fedavgm", "fedprox", "scaffold", "fedadam", "fedyogi"]
RTOL, ATOL = 1e-5, 1e-6  # engine vs loop: the reference test's fp32 tolerance
PORT_REL = 1e-5  # port vs reference engine, relative to max|θ|


@pytest.fixture(scope="module")
def fed_data():
    fed, test = make_federated_features(
        seed=0, n=600, d=D, n_classes=C, n_clients=N_CLIENTS, alpha=0.0, noise=1.5
    )
    pfed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, pfed, np.asarray(test.features), np.asarray(test.labels)


def _W0(seed=1):
    return (0.01 * np.random.default_rng(seed).normal(size=(D, C))).astype(np.float32)


def _kw(**kw):
    base = dict(
        n_clients=N_CLIENTS, clients_per_round=4, n_rounds=3, local_epochs=1,
        local_batch_size=16, client_lr=0.1, algorithm="fedavg", seed=0,
    )
    base.update(kw)
    return base


def _fc(**kw):
    return FederatedConfig(**_kw(**kw))


def _server_lr(algo):
    return 0.01 if algo in ("fedadam", "fedyogi") else 1.0


def _rc(algo_name, **kw):
    algo = make_algorithm(algo_name, server_momentum=0.9 if algo_name == "fedavgm" else 0.0)
    base = dict(algo=algo, client_lr=0.1, n_total_clients=N_CLIENTS, server_lr=_server_lr(algo_name))
    base.update(kw)
    return RoundConfig(**base)


def _task(tf, tl):
    return linear_head_task(D, C, tf, tl, W_init=_W0(), device="cpu")


def _run_both(task, pfed, rc, n_rounds=3):
    eng = RoundEngine(rc, task.per_example_loss, task.freeze)
    ref = ReferenceLoop(rc, task.per_example_loss, task.freeze)
    se, sr = eng.init(task.params0), ref.init(task.params0)
    for rnd in range(n_rounds):
        _, cohort = pack_round(pfed, _fc(), rnd, n_batches=4)
        se = eng.step(se, cohort)
        sr = ref.step(sr, cohort)
    return eng, ref, se, sr


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(a).numpy(), torch.as_tensor(b).numpy(),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# engine vs per-client reference loop — parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ALGOS)
def test_round_engine_matches_reference_loop(fed_data, algo):
    _, pfed, tf, tl = fed_data
    eng, ref, se, sr = _run_both(_task(tf, tl), pfed, _rc(algo))
    for k in ("W", "bias"):
        _close(se.params[k], sr.params[k])
    assert int(se.round) == int(sr.round) == 3
    # dispatch economics: 1 per round vs K+1 per round
    assert eng.dispatches == 3
    assert ref.dispatches == 3 * (4 + 1)


def test_round_engine_scaffold_cvar_state_matches_reference(fed_data):
    fed, pfed, tf, tl = fed_data
    _, _, se, sr = _run_both(_task(tf, tl), pfed, _rc("scaffold"))
    for k in ("W", "bias"):
        _close(se.cvars[k], sr.cvars[k])
        _close(se.c_server[k], sr.c_server[k])
    # ... and against the reference's engine (the table and the server variate)
    jtask = jlinear_head_task(D, C, jnp.asarray(tf), jnp.asarray(tl), W_init=_W0())
    jeng = JRoundEngine(JRoundConfig(algo=jmake_algorithm("scaffold"), client_lr=0.1,
                                     n_total_clients=N_CLIENTS),
                        jtask.per_example_loss, jtask.freeze)
    js = jeng.init(jtask.params0)
    for rnd in range(3):
        js = jeng.step(js, jpack_round(fed, JFederatedConfig(**_kw()), rnd, n_batches=4)[1])
    for k in ("W", "bias"):
        want = np.asarray(js.cvars[k])
        assert float(np.abs(se.cvars[k].numpy() - want).max()) <= PORT_REL * np.abs(want).max()
    # only the sampled rows of the stacked table moved
    sampled = set()
    for rnd in range(3):
        sampled.update(int(k) for k in sample_round(N_CLIENTS, 4, rnd, seed=0))
    w_cvar = se.cvars["W"].numpy()
    for k in range(N_CLIENTS):
        if k not in sampled:
            assert not w_cvar[k].any()


# ---------------------------------------------------------------------------
# port vs reference engine: packed cohorts bitwise, rounds within fp32
# ---------------------------------------------------------------------------


def _jtask(kind, tf, tl, strategy):
    if kind == "linear":
        return jlinear_head_task(D, C, jnp.asarray(tf), jnp.asarray(tl), W_init=_W0())
    return jft_task(D, C, jnp.asarray(_W0()), jnp.asarray(tf), jnp.asarray(tl), strategy=strategy)


def _ptask(kind, tf, tl, strategy):
    if kind == "linear":
        return _task(tf, tl)
    return feature_finetune_task(D, C, _W0(), tf, tl, strategy=strategy, device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind,strategy", [("linear", None), ("finetune", "full"),
                                           ("finetune", "feat")])
def test_rounds_match_the_reference_engine(fed_data, algo, kind, strategy):
    fed, pfed, tf, tl = fed_data
    jtask, ptask = _jtask(kind, tf, tl, strategy), _ptask(kind, tf, tl, strategy)
    ja = jmake_algorithm(algo, server_momentum=0.9 if algo == "fedavgm" else 0.0)
    jeng = JRoundEngine(JRoundConfig(algo=ja, client_lr=0.1, n_total_clients=N_CLIENTS,
                                     server_lr=_server_lr(algo)),
                        jtask.per_example_loss, jtask.freeze)
    peng = RoundEngine(_rc(algo), ptask.per_example_loss, ptask.freeze)
    js, ps = jeng.init(jtask.params0), peng.init(ptask.params0)
    for rnd in range(3):
        _, jc = jpack_round(fed, JFederatedConfig(**_kw()), rnd, n_batches=4)
        _, pc = pack_round(pfed, _fc(), rnd, n_batches=4)
        for a, b in zip(jc, pc):  # the packed cohorts are bitwise the reference's
            assert a.dtype == b.dtype and np.array_equal(a, b)
        js, ps = jeng.step(js, jc), peng.step(ps, pc)
    for k, v in ps.params.items():
        want = np.asarray(js.params[k])
        err = float(np.abs(v.numpy() - want).max())
        assert err <= PORT_REL * np.abs(want).max(), (k, err)
    assert int(ps.round) == int(js.round) == 3


def test_pack_cohort_batches_is_bitwise_the_reference(fed_data):
    fed, _, _, _ = fed_data
    ids = [9, 2, 5]
    clients = [(fed.client(k).features, fed.client(k).labels) for k in ids]
    for kw in (dict(), dict(seed=(3, 1)), dict(seed=(0, 2), cohort_size=5, num_shards=4),
               dict(canonical_order=False)):
        want = jpack_cohort_batches(clients, 8, 6, 2, client_ids=ids, **kw)
        got = pack_cohort_batches(clients, 8, 6, 2, client_ids=ids, **kw)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.cohort == 3 and got.n_clients == 3
    assert pack_cohort_batches(clients, 8, 6, cohort_size=5, num_shards=4).cohort == 8


# ---------------------------------------------------------------------------
# freeze-mask semantics (FED3R+FT strategies)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy,frozen,trainable", [
    ("full", (), ("M", "W", "bias")),
    ("lp", ("M",), ("W", "bias")),
    ("feat", ("W", "bias"), ("M",)),
])
def test_freeze_strategies(fed_data, strategy, frozen, trainable):
    _, pfed, tf, tl = fed_data
    task = feature_finetune_task(D, C, _W0(), tf, tl, strategy=strategy, device="cpu")
    eng = RoundEngine(_rc("fedavg"), task.per_example_loss, task.freeze)
    state = eng.init(task.params0)
    for rnd in range(2):
        _, cohort = pack_round(pfed, _fc(), rnd, n_batches=4)
        state = eng.step(state, cohort)
    for k in frozen:
        assert torch.equal(state.params[k], task.params0[k])
    for k in trainable:
        assert not torch.equal(state.params[k], task.params0[k])


# ---------------------------------------------------------------------------
# cohort permutation invariance (bitwise), padded slots
# ---------------------------------------------------------------------------


def test_round_invariant_under_cohort_permutation(fed_data):
    fed, _, tf, tl = fed_data
    ids = [7, 2, 11, 5]
    clients = [(fed.client(k).features, fed.client(k).labels) for k in ids]
    p1 = pack_cohort_batches(clients, 16, 4, client_ids=ids, seed=(0, 0))
    perm = [2, 0, 3, 1]
    p2 = pack_cohort_batches(
        [clients[i] for i in perm], 16, 4,
        client_ids=[ids[i] for i in perm], seed=(0, 0),
    )
    for a, b in zip(p1, p2):  # identical packed arrays...
        np.testing.assert_array_equal(a, b)
    for algo in ("fedavg", "scaffold"):
        task = _task(tf, tl)
        eng = RoundEngine(_rc(algo), task.per_example_loss, task.freeze)
        s1 = eng.step(eng.init(task.params0), p1)
        s2 = eng.step(eng.init(task.params0), p2)
        # ...hence a bit-identical aggregated round
        for k in ("W", "bias"):
            assert torch.equal(s1.params[k], s2.params[k])
        if algo == "scaffold":
            assert torch.equal(s1.cvars["W"], s2.cvars["W"])


@pytest.mark.parametrize("ids", [[3, 8], [0, 8]])
def test_padded_cohort_slots_are_noops(fed_data, ids):
    """Padded slots (id −1) change nothing: params, the server variate, and
    the stacked variates.  With client 0 in the cohort, a padded slot's
    clamped id is 0 too: its write must not land in row 0."""
    fed, _, tf, tl = fed_data
    clients = [(fed.client(k).features, fed.client(k).labels) for k in ids]
    tight = pack_cohort_batches(clients, 16, 4, client_ids=ids, seed=(0, 0))
    padded = pack_cohort_batches(clients, 16, 4, client_ids=ids, seed=(0, 0), cohort_size=5)
    assert padded.cohort == 5 and padded.n_clients == 2
    for algo in ("fedavg", "scaffold"):
        task = _task(tf, tl)
        eng = RoundEngine(_rc(algo), task.per_example_loss, task.freeze)
        s1 = eng.step(eng.init(task.params0), tight)
        s2 = eng.step(eng.init(task.params0), padded)
        _close(s1.params["W"], s2.params["W"], rtol=1e-6, atol=1e-7)
        if algo == "scaffold":
            _close(s1.c_server["W"], s2.c_server["W"], rtol=1e-6, atol=1e-7)
            _close(s1.cvars["W"], s2.cvars["W"], rtol=1e-6, atol=1e-7)
            for k in range(N_CLIENTS):  # every other row bitwise untouched
                if k not in ids:
                    assert not s2.cvars["W"][k].any()
            assert s2.cvars["W"][ids[0]].abs().max() > 0


def test_padded_only_cohort_leaves_the_state(fed_data):
    """A cohort of padded slots only: no update, every row written back as it was."""
    _, pfed, tf, tl = fed_data
    task = _task(tf, tl)
    eng = RoundEngine(_rc("scaffold"), task.per_example_loss, task.freeze)
    _, cohort = pack_round(pfed, _fc(), 0, n_batches=4)
    state = eng.step(eng.init(task.params0), cohort)
    empty = cohort._replace(mask=np.zeros_like(cohort.mask),
                            client_ids=np.full_like(cohort.client_ids, -1))
    after = eng.step(state, empty)
    for k in ("W", "bias"):
        assert torch.equal(after.params[k], state.params[k])
        assert torch.equal(after.cvars[k], state.cvars[k])
        assert torch.equal(after.c_server[k], state.c_server[k])


# ---------------------------------------------------------------------------
# sampling: both modes, statelessness (the port's copy, and the same draws)
# ---------------------------------------------------------------------------


def test_sampler_with_replacement_honors_the_flag():
    draws = [sample_round(5, 64, r, seed=0, replacement=True) for r in range(4)]
    for r, d in enumerate(draws):
        assert len(d) == 64  # per_round > n_clients is legal with replacement
        np.testing.assert_array_equal(d, jsample_round(5, 64, r, seed=0, replacement=True))
    assert any(len(np.unique(d)) < len(d) for d in draws)


def test_sampler_without_replacement_epoch_exactness():
    per_epoch = []
    for rnd in range(6):  # 6 rounds × 4 = 2 epochs over 12 clients
        per_epoch.extend(sample_round(12, 4, rnd, seed=3).tolist())
    assert sorted(per_epoch[:12]) == list(range(12))
    assert sorted(per_epoch[12:]) == list(range(12))
    assert per_epoch[:12] != list(range(12))


def test_sample_round_is_stateless_and_sampler_delegates():
    for replacement in (False, True):
        a = [sample_round(10, 3, r, seed=1, replacement=replacement) for r in range(5)]
        b = [sample_round(10, 3, r, seed=1, replacement=replacement) for r in range(5)]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        s = ClientSampler(10, 3, replacement=replacement, seed=1)
        for x in a:
            np.testing.assert_array_equal(x, s.sample())
    assert ClientSampler(17, 5).rounds_to_full_coverage() == 4


# ---------------------------------------------------------------------------
# ServerState checkpointing + stop/resume equivalence
# ---------------------------------------------------------------------------


def test_server_state_checkpoint_roundtrip(tmp_path):
    params = {"W": torch.ones((3, 2)), "bias": torch.zeros((2,))}
    state = server_init(make_algorithm("scaffold"), params, n_clients=5)
    state = state._replace(round=torch.tensor(4, dtype=torch.int32))
    path = os.path.join(tmp_path, "ckpt_4.npz")
    save_pytree(path, state)
    back = server_state_from_tree(load_pytree(path), "cpu")
    assert int(back.round) == 4 and back.round.dtype == torch.int32
    assert back.momentum is None and back.opt_m is None  # Nones survive
    assert back.cvars["W"].shape == (5, 3, 2)
    assert torch.equal(state.params["W"], back.params["W"])


@pytest.mark.parametrize("algo", ["fedavg", "scaffold", "fedadam"])
def test_stop_resume_reproduces_uninterrupted_run(fed_data, tmp_path, algo):
    _, pfed, tf, tl = fed_data
    kw = dict(algorithm=algo, n_rounds=6, server_lr=_server_lr(algo))
    straight, _ = run_federated(_task(tf, tl), pfed, _fc(**kw), eval_every=3)
    ckpt = str(tmp_path / algo)
    run_federated(_task(tf, tl), pfed, _fc(**{**kw, "n_rounds": 3}), eval_every=3, ckpt_dir=ckpt)
    resumed, hist = run_federated(_task(tf, tl), pfed, _fc(**kw), eval_every=3,
                                  ckpt_dir=ckpt, resume=True)
    assert hist.rounds == [6]
    for k in ("W", "bias"):
        assert torch.equal(straight[k], resumed[k])


# ---------------------------------------------------------------------------
# the psum backend (tests/test_round_engine.py:316-330); the sharded rounds
# on 4 ranks are in tests/test_torch_dist_engines.py
# ---------------------------------------------------------------------------


def test_psum_and_meshes_raise(fed_data):
    """The reference's validation raises; on a one-rank world the psum
    backend runs, bitwise the merge engine (its all-reduce sums one rank),
    and Scaffold refuses it with the reference's message."""
    _, pfed, tf, tl = fed_data
    with pytest.raises(ValueError):
        DistConfig(aggregation="psum")  # no axes, no mesh
    with pytest.raises(ValueError):
        DistConfig(aggregation="allgather")
    with pytest.raises(ValueError):
        engine_lib.aggregate(None, "allgather")
    task = _task(tf, tl)
    _, cohort = pack_round(pfed, _fc(), 0, n_batches=4)
    with single_rank_world("gloo", "cpu"):
        mesh = make_host_mesh(device_type="cpu")
        psum = DistConfig(aggregation="psum", mesh=mesh)
        with pytest.raises(ValueError, match="scaffold needs the global cohort for the cvar"):
            RoundEngine(_rc("scaffold", dist=psum), task.per_example_loss, task.freeze)
        merge = RoundEngine(_rc("fedavg"), task.per_example_loss, task.freeze)
        eng = RoundEngine(_rc("fedavg", dist=psum), task.per_example_loss, task.freeze)
        want = merge.step(merge.init(task.params0), cohort)
        got = eng.step(eng.init(task.params0), pack_round(pfed, _fc(), 0, n_batches=4,
                                                          mesh=mesh)[1])
        for k in ("W", "bias"):
            assert torch.equal(got.params[k], want.params[k])
        stats = engine_lib.shard_stats(torch.ones(3, 2), torch.zeros(3), 2)
        summed = engine_lib.aggregate(stats, "psum", ("data",), mesh)
        assert torch.equal(summed.A, stats.A) and torch.equal(summed.b, stats.b)
        clients = [(pfed.client(0).features, pfed.client(0).labels)]
        assert pack_cohort_batches(clients, 16, 4, mesh=mesh).cohort == 1
