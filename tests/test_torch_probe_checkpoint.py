"""The port's RR probe, checkpoints, optimizers and schedules, against the reference.

Twins ``tests/test_rf_probe_checkpoint.py:48-110`` on the port and adds:

* the probe's W and accuracy against the reference's ``probe_quality``
  (fp32 reassociation through the ridge solve: within 5e-4 of max|W|,
  accuracies within one test sample);
* checkpoint files cross the packages both ways (the npz + key-path format
  is shared): a ``ServerState`` written by one loads in the other bitwise,
  and a run checkpointed by one package resumes in the other, landing
  within fp32 tolerance of the uninterrupted run (1e-5 of max|θ|);
* ``run_fed3r_ft(resume=True)`` through both packages: stopped after 3
  rounds and resumed for 3 more, bitwise the uninterrupted 6 in each;
* the optimizers and schedules against the reference's values.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_pytree as jload_pytree  # noqa: E402
from repro.checkpoint import save_pytree as jsave_pytree  # noqa: E402
from repro.configs.base import Fed3RConfig as JFed3RConfig  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core.probe import probe_quality as jprobe_quality  # noqa: E402
from repro.data import make_federated_features  # noqa: E402
from repro.federated import run_fed3r_ft as jrun_fed3r_ft  # noqa: E402
from repro.federated.algorithms import make_algorithm as jmake_algorithm  # noqa: E402
from repro.federated.algorithms import server_init as jserver_init  # noqa: E402
from repro.federated.algorithms import server_state_from_tree as jserver_state_from_tree  # noqa: E402
from repro.federated.simulator import linear_head_task as jlinear_head_task  # noqa: E402
from repro.federated.simulator import run_federated as jrun_federated  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import apply_updates as japply_updates  # noqa: E402
from repro.optim import sgd_init as jsgd_init  # noqa: E402
from repro.optim import sgd_update as jsgd_update  # noqa: E402
from repro.optim.schedules import cosine_decay as jcosine_decay  # noqa: E402
from repro.optim.schedules import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.checkpoint import latest_checkpoint, load_pytree, save_pytree  # noqa: E402
from repro_torch.configs.base import Fed3RConfig, FederatedConfig  # noqa: E402
from repro_torch.core.probe import fit_probe, probe_extractor, probe_quality  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset  # noqa: E402
from repro_torch.federated.algorithms import (  # noqa: E402
    make_algorithm,
    server_init,
    server_state_from_tree,
)
from repro_torch.federated.fed3r_driver import run_fed3r_ft  # noqa: E402
from repro_torch.federated.simulator import linear_head_task, run_federated  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw_init,
    adamw_update,
    apply_updates,
    make_optimizer,
    sgd_init,
    sgd_update,
)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N_CLIENTS, C, D = 12, 4, 8
REL = 1e-5  # fp32 reassociation, relative to max|θ|
# the λ = 0.01 ridge solve amplifies A's fp32 reassociation by cond(A + λI)
# (measured 9.4e-5 of max|W| on the clean features below)
PROBE_REL = 5e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# the RR probe
# ---------------------------------------------------------------------------


def test_probe_ranks_feature_quality():
    """§5.4: the RR probe scores clean features above noisy ones, as the
    reference's probe does on the same features."""
    r = np.random.default_rng(0)
    means = 3.0 * r.normal(size=(8, 24))
    labels = r.integers(0, 8, 2000).astype(np.int32)
    clean = (means[labels] + 0.3 * r.normal(size=(2000, 24))).astype(np.float32)
    noisy = (clean + 10.0 * r.normal(size=clean.shape)).astype(np.float32)
    tr = 1600
    accs = []
    for feats in (clean, noisy):
        f, y = torch.from_numpy(feats), torch.from_numpy(labels)
        got = probe_quality(f[:tr], y[:tr], f[tr:], y[tr:], 8)
        want = jprobe_quality(jnp.asarray(feats[:tr]), jnp.asarray(labels[:tr]),
                              jnp.asarray(feats[tr:]), jnp.asarray(labels[tr:]), 8)
        assert _rel(got.W, want.W) <= PROBE_REL
        assert float(got.accuracy) == pytest.approx(float(want.accuracy), abs=1.0 / (2000 - tr))
        accs.append(float(got.accuracy))
    assert accs[0] > accs[1] + 0.05
    # the streaming probe over batches is the one-shot fit
    f, y = torch.from_numpy(clean[:tr]), torch.from_numpy(labels[:tr])
    batches = [({"x": f[i:i + 400]}, y[i:i + 400]) for i in range(0, tr, 400)]
    W = probe_extractor(lambda b: b["x"], batches, 8, 24, device="cpu")
    assert _rel(W, fit_probe(f, y, 8)) <= PROBE_REL


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"w": torch.randn(4, 5), "b": torch.zeros(5)},
        "opt": {"mu": [torch.ones(3), torch.zeros((2, 2))], "t": torch.tensor(7)},
        "meta": {"none_leaf": None, "tup": (torch.ones(2), torch.zeros(1))},
    }
    path = os.path.join(tmp_path, "ckpt_3.npz")
    save_pytree(path, tree)
    back = load_pytree(path)
    np.testing.assert_array_equal(tree["params"]["w"].numpy(), back["params"]["w"])
    assert isinstance(back["opt"]["mu"], list) and len(back["opt"]["mu"]) == 2
    assert isinstance(back["meta"]["tup"], tuple)
    assert back["meta"]["none_leaf"] is None
    assert int(back["opt"]["t"]) == 7
    assert latest_checkpoint(str(tmp_path)) == path
    assert latest_checkpoint(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("algo", ["scaffold", "fedadam", "fedavgm"])
def test_server_state_files_load_across_packages(tmp_path, algo):
    W = np.random.default_rng(1).normal(size=(3, 2)).astype(np.float32)
    jstate = jserver_init(jmake_algorithm(algo), {"W": jnp.asarray(W), "bias": jnp.ones(2)},
                          n_clients=5)._replace(round=jnp.asarray(4, jnp.int32))
    state = server_init(make_algorithm(algo), {"W": torch.from_numpy(W), "bias": torch.ones(2)},
                        n_clients=5)._replace(round=torch.tensor(4, dtype=torch.int32))
    jsave_pytree(str(tmp_path / "from_ref.npz"), jstate)
    save_pytree(str(tmp_path / "from_port.npz"), state)
    # the two writers store the same arrays under the same manifest
    with np.load(tmp_path / "from_ref.npz") as a, np.load(tmp_path / "from_port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a["__meta__"]) == str(b["__meta__"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    back = server_state_from_tree(load_pytree(str(tmp_path / "from_ref.npz")), "cpu")
    jback = jserver_state_from_tree(jload_pytree(str(tmp_path / "from_port.npz")))
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert (back.cvars is None) == (algo != "scaffold")
    assert int(back.round) == int(jback.round) == 4


@pytest.fixture(scope="module")
def fed_data():
    fed, test = make_federated_features(
        seed=0, n=600, d=D, n_classes=C, n_clients=N_CLIENTS, alpha=0.0, noise=1.5
    )
    pfed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, pfed, test, np.asarray(test.features), np.asarray(test.labels)


def _kw(**kw):
    base = dict(n_clients=N_CLIENTS, clients_per_round=4, n_rounds=6, local_epochs=1,
                local_batch_size=16, client_lr=0.1, algorithm="scaffold", seed=0)
    base.update(kw)
    return base


def _W0():
    return (0.01 * np.random.default_rng(1).normal(size=(D, C))).astype(np.float32)


def test_checkpoints_resume_across_packages(fed_data, tmp_path):
    """3 rounds in one package, checkpointed; 3 more in the other, resumed."""
    fed, pfed, test, tf, tl = fed_data
    jtask = lambda: jlinear_head_task(D, C, test.features, test.labels, W_init=_W0())  # noqa: E731
    ptask = lambda: linear_head_task(D, C, tf, tl, W_init=_W0(), device="cpu")  # noqa: E731
    straight, _ = jrun_federated(jtask(), fed, JFederatedConfig(**_kw()), eval_every=3)

    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jrun_federated(jtask(), fed, JFederatedConfig(**_kw(n_rounds=3)), eval_every=3,
                   ckpt_dir=ref_dir)
    resumed_port, hist = run_federated(ptask(), pfed, FederatedConfig(**_kw()), eval_every=3,
                                       ckpt_dir=ref_dir, resume=True)
    assert hist.rounds == [6]
    run_federated(ptask(), pfed, FederatedConfig(**_kw(n_rounds=3)), eval_every=3,
                  ckpt_dir=port_dir)
    resumed_ref, jhist = jrun_federated(jtask(), fed, JFederatedConfig(**_kw()), eval_every=3,
                                        ckpt_dir=port_dir, resume=True)
    assert jhist.rounds == [6]
    for k in ("W", "bias"):
        assert _rel(resumed_port[k], straight[k]) <= REL
        assert _rel(resumed_ref[k], straight[k]) <= REL


def test_run_fed3r_ft_resumes_in_both_packages(fed_data, tmp_path):
    fed, pfed, test, tf, tl = fed_data
    f3, jf3 = Fed3RConfig(n_classes=C), JFed3RConfig(n_classes=C)
    # stage 1 runs up to n_rounds rounds, so the stopped run must still
    # reach full coverage (3 rounds of 4 of the 12 clients) to share stage 1
    kw = _kw(algorithm="fedavgm", n_rounds=6, server_momentum=0.9)

    straight, info = run_fed3r_ft(pfed, tf, tl, f3, FederatedConfig(**kw), strategy="full",
                                  eval_every=3, device="cpu")
    ck = str(tmp_path / "port")
    run_fed3r_ft(pfed, tf, tl, f3, FederatedConfig(**{**kw, "n_rounds": 3}), strategy="full",
                 eval_every=3, ckpt_dir=ck, device="cpu")
    resumed, rinfo = run_fed3r_ft(pfed, tf, tl, f3, FederatedConfig(**kw), strategy="full",
                                  eval_every=3, ckpt_dir=ck, resume=True, device="cpu")
    assert rinfo["fed3r_rounds"] == 0 and "W_init" not in rinfo  # stage 1 skipped
    assert rinfo["ft_history"].rounds == [6]
    for k in ("M", "W", "bias"):
        assert torch.equal(straight[k], resumed[k])

    jstraight, _ = jrun_fed3r_ft(fed, test.features, test.labels, jf3, JFederatedConfig(**kw),
                                 strategy="full", eval_every=3)
    jck = str(tmp_path / "ref")
    jrun_fed3r_ft(fed, test.features, test.labels, jf3,
                  JFederatedConfig(**{**kw, "n_rounds": 3}), strategy="full", eval_every=3,
                  ckpt_dir=jck)
    jresumed, _ = jrun_fed3r_ft(fed, test.features, test.labels, jf3, JFederatedConfig(**kw),
                                strategy="full", eval_every=3, ckpt_dir=jck, resume=True)
    for k in ("M", "W", "bias"):
        assert np.array_equal(np.asarray(jstraight[k]), np.asarray(jresumed[k]))
        assert _rel(straight[k], jstraight[k]) <= 1e-4
    # the reference's stage-2 state resumes in the port too
    cross, _ = run_fed3r_ft(pfed, tf, tl, f3, FederatedConfig(**kw), strategy="full",
                            eval_every=3, ckpt_dir=jck, resume=True, device="cpu")
    for k in ("M", "W", "bias"):
        assert _rel(cross[k], jstraight[k]) <= 1e-4


def test_tree_from_jax_carries_a_server_state():
    W = np.arange(6, dtype=np.float32).reshape(3, 2)
    jstate = jserver_init(jmake_algorithm("scaffold"),
                          {"head": {"W": jnp.asarray(W)},
                           "backbone": {"layers": {"w": jnp.ones((2, 4))}}},
                          n_clients=5)
    state = tree_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert type(state).__name__ == "ServerState" and state.momentum is None
    assert state.round.dtype == torch.int32
    assert torch.equal(state.params["head"]["W"], torch.from_numpy(W))
    layers = state.params["backbone"]["layers"]
    assert isinstance(layers, list) and len(layers) == 2 and layers[0]["w"].shape == (4,)
    cv = state.cvars["backbone"]["layers"]  # the layer axis follows the client axis
    assert len(cv) == 2 and cv[0]["w"].shape == (5, 4)


# ---------------------------------------------------------------------------
# optimizers / schedules
# ---------------------------------------------------------------------------


def test_sgd_momentum_accumulates():
    params, grads = {"w": torch.ones(3)}, {"w": torch.ones(3)}
    state = sgd_init(params, momentum=0.9)
    u1, state = sgd_update(grads, state, params, 0.1, momentum=0.9)
    u2, state = sgd_update(grads, state, params, 0.1, momentum=0.9)
    assert float(u2["w"][0].abs()) > float(u1["w"][0].abs())
    jstate = jsgd_init({"w": jnp.ones(3)}, momentum=0.9)
    for _ in range(2):
        ju, jstate = jsgd_update({"w": jnp.ones(3)}, jstate, {"w": jnp.ones(3)}, 0.1,
                                 momentum=0.9, weight_decay=0.01)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=0.01)
    st = opt.init(params)
    for _ in range(2):
        u, st = opt.update(grads, st, params, 0.1)
    np.testing.assert_allclose(u["w"].numpy(), np.asarray(ju["w"]), rtol=1e-6)
    with pytest.raises(ValueError):
        make_optimizer("lion")


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    jparams = {"w": jnp.asarray([5.0, -3.0])}
    state, jstate = adamw_init(params), jadamw_init(jparams)
    for _ in range(200):
        updates, state = adamw_update({"w": 2 * params["w"]}, state, params, 0.1)
        params = apply_updates(params, updates)
        jupdates, jstate = jadamw_update({"w": 2 * jparams["w"]}, jstate, jparams, 0.1)
        jparams = japply_updates(jparams, jupdates)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state["t"]) == 200 and state["t"].dtype == torch.int32
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), atol=1e-5)


def test_schedules_shapes():
    s = warmup_cosine(1.0, 10, 100)
    assert float(s(0)) < 0.2
    assert abs(float(s(10)) - 1.0) < 1e-5
    assert float(s(99)) < 0.5
    cd = cosine_decay(2.0, 50)
    assert abs(float(cd(0)) - 2.0) < 1e-5
    assert float(constant(0.3)(7)) == pytest.approx(0.3)
    js, jcd = jwarmup_cosine(1.0, 10, 100), jcosine_decay(2.0, 50)
    for step in (0, 3, 10, 37, 99, 150):
        assert float(s(step)) == pytest.approx(float(js(step)), abs=1e-6)
        assert float(cd(step)) == pytest.approx(float(jcd(step)), abs=1e-6)
