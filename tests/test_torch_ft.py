"""FED3R+FT and gradient FL in the port, against the reference.

Twins the gradient tests of ``tests/test_federated.py`` (the six
algorithms learn; FT-FEAT keeps the FED3R classifier; the temperature lies
on the grid) and ``tests/test_models_smoke.py`` (``make_train_step`` lowers
the loss; microbatches equal one batch; ``freeze``), then holds the port's
pieces against the reference's on the same inputs:

* ``run_federated`` and ``run_fed3r_ft`` against the reference's drivers
  (numpy heads in, the reference's federated features);
* ``make_train_step`` on ``params_from_jax`` params: the bf16 gradients of
  the two frameworks may round a tie apart, so Δθ agrees within a few bf16
  ulps of max|Δθ|;
* ``train.ft_phase`` at ``fed3r-mnv2-proxy-smoke`` against the reference's
  phase-2 pieces driven the same way (its round engine over the same
  cohorts, on the same ``tree_from_jax`` params and head): in fp32
  activations within 1e-4 of max|Δθ|, in the config's bf16 within a few
  bf16 ulps of it;
* ``make_fed3r_stats_step`` (one ``fed3r_stats`` launch, its plain version
  here) against the reference's step, within 1e-5 of max|A|.

The full-width round's peak memory needs the card: it is in
``test_torch_kernels.py``, which runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import Fed3RConfig as JFed3RConfig  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data import make_federated_features  # noqa: E402
from repro.data.partition import dirichlet_partition as jpartition  # noqa: E402
from repro.data.pipeline import pack_cohort_batches as jpack_cohort_batches  # noqa: E402
from repro.data.synthetic import make_token_dataset as jmake_token_dataset  # noqa: E402
from repro.federated import run_fed3r_ft as jrun_fed3r_ft  # noqa: E402
from repro.federated.algorithms import make_algorithm as jmake_algorithm  # noqa: E402
from repro.federated.round_engine import RoundConfig as JRoundConfig  # noqa: E402
from repro.federated.round_engine import RoundEngine as JRoundEngine  # noqa: E402
from repro.federated.sampling import sample_round as jsample_round  # noqa: E402
from repro.federated.simulator import linear_head_task as jlinear_head_task  # noqa: E402
from repro.federated.simulator import run_federated as jrun_federated  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import Fed3RConfig, FederatedConfig  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset  # noqa: E402
from repro_torch.data.synthetic import TokenDataset  # noqa: E402
from repro_torch.federated.fed3r_driver import run_fed3r_ft  # noqa: E402
from repro_torch.federated.simulator import linear_head_task, run_federated  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.world import single_rank_world  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

N_CLIENTS, C, D = 20, 6, 32
TEMPERATURES = (3.0, 1.0, 0.3, 0.1, 0.03, 0.01)
BF16_ULP = 2.0 ** -8
# port vs reference after the same SGD steps: fp32 reassociation only
FT_F32_REL = 1e-4
# bf16 activations: a gradient's rounding can land either side of a tie in
# the two frameworks; a few bf16 ulps of max|Δθ|
FT_BF16_REL = 4 * BF16_ULP


@pytest.fixture(scope="module")
def fed_data():
    fed, test = make_federated_features(
        seed=0, n=1500, d=D, n_classes=C, n_clients=N_CLIENTS, alpha=0.0, noise=1.5
    )
    pfed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, pfed, test, np.asarray(test.features), np.asarray(test.labels)


def _kw(**kw):
    base = dict(
        n_clients=N_CLIENTS, clients_per_round=5, n_rounds=20, local_epochs=1,
        local_batch_size=16, client_lr=0.1, algorithm="fedavg", seed=0,
    )
    base.update(kw)
    return base


def _W0():
    return (0.01 * np.random.default_rng(0).normal(size=(D, C))).astype(np.float32)


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).to(torch.float32))
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# the six algorithms learn, and match the reference's drivers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["fedavg", "fedavgm", "fedprox", "scaffold",
                                       "fedadam", "fedyogi"])
def test_gradient_fl_learns(fed_data, algorithm):
    fed, pfed, test, tf, tl = fed_data
    kw = _kw(algorithm=algorithm, n_rounds=15,
             server_momentum=0.9 if algorithm == "fedavgm" else 0.0,
             server_lr=0.01 if algorithm in ("fedadam", "fedyogi") else 1.0)
    task = linear_head_task(D, C, tf, tl, W_init=_W0(), device="cpu")
    params, hist = run_federated(task, pfed, FederatedConfig(**kw), eval_every=5)
    assert hist.rounds == [5, 10, 15]
    assert hist.accuracy[-1] > 1.5 / C  # clearly better than chance
    jtask = jlinear_head_task(D, C, test.features, test.labels, W_init=_W0())
    jparams, jhist = jrun_federated(jtask, fed, JFederatedConfig(**kw), eval_every=5)
    for k in ("W", "bias"):
        assert _rel(params[k], jparams[k]) <= FT_F32_REL
    np.testing.assert_allclose(hist.accuracy, jhist.accuracy, rtol=0, atol=1.0 / len(tl))
    assert hist.coverage == jhist.coverage


def test_ft_feat_keeps_classifier_fixed(fed_data):
    fed, pfed, test, tf, tl = fed_data
    f3 = Fed3RConfig(n_classes=C, ft_strategy="feat")
    params, info = run_fed3r_ft(pfed, tf, tl, f3, FederatedConfig(**_kw(n_rounds=5)),
                                strategy="feat", device="cpu")
    assert info["fed3r_history"].accuracy[-1] > 0
    # the classifier is the calibrated FED3R init exactly (frozen), M moved
    assert torch.equal(params["W"], info["W_init"])
    assert torch.equal(params["bias"], torch.zeros(C))
    assert not torch.equal(params["M"], torch.eye(D))
    assert min(abs(info["temperature"] - t) for t in TEMPERATURES) < 1e-5
    jparams, jinfo = jrun_fed3r_ft(fed, test.features, test.labels,
                                   JFed3RConfig(n_classes=C, ft_strategy="feat"),
                                   JFederatedConfig(**_kw(n_rounds=5)), strategy="feat")
    assert info["temperature"] == jinfo["temperature"]
    assert info["fed3r_rounds"] == jinfo["fed3r_rounds"]
    for k in ("M", "W"):
        assert _rel(params[k], jparams[k]) <= FT_F32_REL
    assert info["ft_history"].rounds == jinfo["ft_history"].rounds


# ---------------------------------------------------------------------------
# make_train_step (tests/test_models_smoke.py) and against the reference
# ---------------------------------------------------------------------------


def _batch(cfg, B, S, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}, \
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


@pytest.mark.parametrize("name", ["fed3r-mnv2-proxy-smoke", "qwen2-7b-smoke"])
def test_forward_and_train_step(name):
    cfg = get_config(name)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch, _ = _batch(cfg, 2, 32)
    loss = model.loss(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    feats = model.extract_features(params, batch)
    assert feats.shape == (2, cfg.d_feat) and bool(torch.isfinite(feats).all())
    step = steps.make_train_step(cfg, lr=0.05)
    params2, loss1 = step(params, batch)
    _, loss2 = step(params2, batch)
    assert bool(torch.isfinite(loss2))
    assert float(loss2) < float(loss1) + 0.5  # no blow-up
    # the step leaves its input params as they were (a new tree)
    assert torch.equal(params["embed"]["embedding"], model.init(seed=0, device="cpu")["embed"]["embedding"])


@pytest.mark.parametrize("name", ["qwen2-7b-smoke", "fed3r-mnv2-proxy-smoke"])
def test_microbatched_train_step_matches_plain(name):
    """Gradient accumulation is the same step (bf16 gradient tolerance)."""
    cfg = get_config(name).replace(dtype="float32")
    params = build_model(cfg).init(seed=0, device="cpu")
    batch, _ = _batch(cfg, 4, 16)
    p1, l1 = steps.make_train_step(cfg, lr=0.1, num_microbatches=1)(params, batch)
    p4, l4 = steps.make_train_step(cfg, lr=0.1, num_microbatches=4)(params, batch)
    d = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p4)))
    assert d < 5e-2
    assert abs(float(l1) - float(l4)) < 1e-4
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(cfg, num_microbatches=3)(params, batch)


def test_freeze_mask():
    cfg = get_config("qwen2-7b-smoke")
    params = build_model(cfg).init(seed=0, device="cpu")
    batch, _ = _batch(cfg, 2, 16)
    freeze = tree_map(lambda _: 0.0, params)  # everything frozen
    p2, _ = steps.make_train_step(cfg, lr=0.5, freeze=freeze)(params, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(p2)))


@pytest.mark.parametrize("name", ["fed3r-mnv2-proxy-smoke", "qwen2-7b-smoke"])
def test_train_step_matches_reference(name):
    """fp32 activations: the same step as the reference's ``make_train_step``
    (its bf16 compute copy and bf16 gradients), Δθ within a few bf16 ulps."""
    jcfg = jget_config(name).replace(dtype="float32")
    cfg = get_config(name).replace(dtype="float32")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    batch, jbatch = _batch(cfg, 4, 16)
    for M in (1, 2):
        p2, loss = steps.make_train_step(cfg, lr=0.1, num_microbatches=M)(params, batch)
        jp2, jloss = jsteps.make_train_step(jcfg, lr=0.1, num_microbatches=M)(jparams, jbatch)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        want = params_from_jax(cfg, jax.tree.map(np.asarray, jp2), device="cpu")
        dq = [(a - p).numpy() for a, p in zip(tree_leaves(p2), tree_leaves(params))]
        dw = [(a - p).numpy() for a, p in zip(tree_leaves(want), tree_leaves(params))]
        scale = max(float(np.abs(x).max()) for x in dw)
        err = max(float(np.abs(a - b).max()) for a, b in zip(dq, dw))
        assert err <= FT_BF16_REL * scale, (M, err, scale)


# ---------------------------------------------------------------------------
# train.ft_phase against the reference's phase-2 pieces
# ---------------------------------------------------------------------------

ARCH = "fed3r-mnv2-proxy-smoke"
FT = dict(n_samples=160, seq_len=16, n_classes=8, n_clients=8, clients_per_round=4,
          rounds=3, lr=0.05, local_batch_size=8)
_FT_SEED = 3


def _reference_phase2(jcfg, jparams, jds, W_head, algorithm, strategy):
    """The reference's train.py phase 2 (launch/train.py:126-181), inline,
    with the head given."""
    tokens_np, labels_np = np.asarray(jds.tokens), np.asarray(jds.labels)
    parts = jpartition(np.random.default_rng(2), labels_np, FT["n_clients"], alpha=0.0)
    head = {"W": jnp.asarray(W_head), "b": jnp.zeros((FT["n_classes"],), jnp.float32)}
    freeze = {"backbone": jax.tree.map(lambda _: 0.0 if strategy == "lp" else 1.0, jparams),
              "head": jax.tree.map(lambda _: 0.0 if strategy == "feat" else 1.0, head)}
    eng = JRoundEngine(JRoundConfig(algo=jmake_algorithm(algorithm), client_lr=FT["lr"],
                                    n_total_clients=FT["n_clients"]),
                       jsteps.make_cls_per_example_loss(jcfg), freeze)
    state = eng.init({"backbone": jparams, "head": head})
    max_nk = max(len(parts[k]) for k in range(FT["n_clients"]))
    n_batches = -(-max_nk // FT["local_batch_size"])
    for rnd in range(FT["rounds"]):
        chosen = jsample_round(FT["n_clients"], FT["clients_per_round"], rnd, seed=_FT_SEED)
        cohort = jpack_cohort_batches(
            [(tokens_np[parts[int(k)]], labels_np[parts[int(k)]]) for k in chosen],
            FT["local_batch_size"], n_batches, client_ids=chosen, seed=(_FT_SEED, rnd))
        state = eng.step(state, cohort)
    return state


def _ft_inputs(dtype):
    jcfg = jget_config(ARCH).replace(dtype=dtype)
    cfg = get_config(ARCH).replace(dtype=dtype)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jds = jmake_token_dataset(jax.random.PRNGKey(1), FT["n_samples"], FT["seq_len"],
                              jcfg.vocab_size, FT["n_classes"])
    ds = TokenDataset(tokens=torch.from_numpy(np.array(jds.tokens)),
                      labels=torch.from_numpy(np.array(jds.labels)),
                      lm_labels=torch.from_numpy(np.array(jds.lm_labels)),
                      n_classes=FT["n_classes"])
    W_head = (0.01 * np.random.default_rng(5).normal(size=(cfg.d_feat, FT["n_classes"]))
              ).astype(np.float32)
    return jcfg, cfg, jparams, jds, ds, W_head


def _ft_kw():
    return {k: FT[k] for k in ("n_clients", "clients_per_round", "rounds", "lr",
                               "local_batch_size")}


@pytest.mark.parametrize("dtype,rel", [("float32", FT_F32_REL), ("bfloat16", FT_BF16_REL)])
@pytest.mark.parametrize("algorithm,strategy", [("fedavg", "feat"), ("fedavg", "full"),
                                                ("scaffold", "lp"), ("fedavgm", "full")])
def test_ft_phase_matches_reference(dtype, rel, algorithm, strategy):
    jcfg, cfg, jparams, jds, ds, W_head = _ft_inputs(dtype)
    jparams_np = jax.tree.map(np.asarray, jparams)
    params = tree_from_jax({"backbone": jparams_np}, "cpu")["backbone"]
    out = train.ft_phase(cfg, params, ds, torch.from_numpy(W_head), algorithm=algorithm,
                         ft_strategy=strategy, device="cpu", verbose=False, **_ft_kw())
    jstate = _reference_phase2(jcfg, jparams, jds, W_head, algorithm, strategy)
    want = tree_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    state = out["state"]
    assert int(state.round) == int(want.round) == FT["rounds"]
    params0 = {"backbone": params, "head": {"W": torch.from_numpy(W_head),
                                            "b": torch.zeros(FT["n_classes"])}}
    got_d = [a - p for a, p in zip(tree_leaves(state.params), tree_leaves(params0))]
    want_d = [a - p for a, p in zip(tree_leaves(want.params), tree_leaves(params0))]
    scale = max(float(x.abs().max()) for x in want_d)
    err = max(float((a - b).abs().max()) for a, b in zip(got_d, want_d))
    assert scale > 0 and err <= rel * scale, (err, scale)
    if strategy == "feat":  # the head is bitwise the init
        assert torch.equal(state.params["head"]["W"], torch.from_numpy(W_head))
    if strategy == "lp":  # the backbone is bitwise the init
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(state.params["backbone"]), tree_leaves(params)))
    if algorithm == "scaffold":
        for a, b in zip(tree_leaves(state.cvars), tree_leaves(want.cvars)):
            assert a.shape == b.shape


def test_ft_phase_resumes_bitwise(tmp_path):
    _, cfg, jparams, _, ds, W_head = _ft_inputs("float32")
    params = tree_from_jax({"b": jax.tree.map(np.asarray, jparams)}, "cpu")["b"]
    kw = dict(_ft_kw(), algorithm="fedavgm", ft_strategy="full", device="cpu", verbose=False)
    straight = train.ft_phase(cfg, params, ds, torch.from_numpy(W_head), **kw)
    ck = str(tmp_path / "ck")
    train.ft_phase(cfg, params, ds, torch.from_numpy(W_head), **{**kw, "rounds": 2}, ckpt_dir=ck)
    resumed = train.ft_phase(cfg, params, ds, torch.from_numpy(W_head), **kw,
                             ckpt_dir=ck, resume=True)
    assert len(resumed["round_ms"]) == 1 and resumed["rounds"] == [3]
    for a, b in zip(tree_leaves(straight["state"]), tree_leaves(resumed["state"])):
        assert torch.equal(a, b)


def test_train_run_fine_tunes_after_phase1():
    ops.fed3r_stats.launches = 0
    out = train.run(ARCH, rounds=2, n_clients=8, clients_per_round=4, n_samples=160,
                    seq_len=16, n_classes=8, local_batch_size=8, device="cpu", verbose=False)
    assert ops.fed3r_stats.launches == 0  # the CPU runs the plain version: no launch
    ft = out["ft"]
    assert int(ft["state"].round) == 2 and ft["rounds"] == [2]
    assert torch.equal(ft["state"].params["head"]["W"], out["W_head"])  # FT-FEAT
    assert not torch.equal(ft["state"].params["backbone"]["embed"]["embedding"],
                           out["params0"]["embed"]["embedding"])
    assert len(ft["round_ms"]) == 2 and ft["round_tokens"][0] > 0


# ---------------------------------------------------------------------------
# the statistics step
# ---------------------------------------------------------------------------


def test_fed3r_stats_step_matches_reference():
    jcfg, cfg, jparams, jds, ds, _ = _ft_inputs("float32")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    mask = (np.arange(FT["n_samples"]) % 5 != 0).astype(np.float32)
    batch = {"tokens": ds.tokens, "class_labels": ds.labels, "mask": torch.from_numpy(mask)}
    jbatch = {"tokens": jds.tokens, "class_labels": jds.labels, "mask": jnp.asarray(mask)}
    stats = steps.make_fed3r_stats_step(cfg, FT["n_classes"])(
        params, fed3r.init_stats(cfg.d_feat, FT["n_classes"], "cpu"), batch)
    jstats = jsteps.make_fed3r_stats_step(jcfg, FT["n_classes"])(
        jparams, jfed3r.init_stats(jcfg.d_feat, FT["n_classes"]), jbatch)
    assert _rel(stats.A, jstats.A) <= 1e-5 and _rel(stats.b, jstats.b) <= 1e-5
    assert float(stats.n) == float(jstats.n) == mask.sum()
    with pytest.raises(ValueError, match="mesh axis"):  # psum needs its axes
        steps.make_fed3r_stats_step(cfg, FT["n_classes"], aggregation="psum")(
            params, fed3r.init_stats(cfg.d_feat, FT["n_classes"], "cpu"), batch)
    with single_rank_world("gloo", "cpu"):  # one rank's all-reduce: the merge step's bits
        summed = steps.make_fed3r_stats_step(
            cfg, FT["n_classes"], aggregation="psum", mesh=make_host_mesh(device_type="cpu"))(
            params, fed3r.init_stats(cfg.d_feat, FT["n_classes"], "cpu"), batch)
    assert torch.equal(summed.A, stats.A) and torch.equal(summed.b, stats.b)
    assert float(summed.n) == float(stats.n)
