"""The six ``examples_torch/`` scripts against the reference's ``examples/``, on the CPU.

Each counterpart's ``main(["--device", "cpu", ...])`` runs on the draws
the reference script makes: its factories (the federation, the streaming
pool, the RFF map, the LP head, the served weights and prompts, the
backbone and its token data) are fed the reference's JAX draws, as
``tests/test_torch_async.py`` does for ``serve_stream``.  The figures the
scripts print are held against the reference's own functions on the same
data:

* round counts, clients seen, the α choices and dispatch counts equal;
* accuracies within one test sample;
* the exact-aggregation gaps within 1e-5;
* served tokens equal (in fp32, where a near-tie cannot flip).

``fed3r_vs_fedavg`` and ``train_fed3r_ft`` run at fewer rounds.  The
reference's slowest figures (its FT round's compile, its served models)
compute in threads from the start of the module, beside the other tests.  The
reference's ``fed3r_vs_fedavg`` crashes on its FED3R-RF row, in
``src/repro/federated/costs.py`` (``assert self.D > 0``: its ``CostModel``
has no D); the counterpart builds that row's ``CostModel`` with D = 1024,
and the row is held against the reference's ``CostModel(..., D=1024)``
called directly.  Times are not compared.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from examples_torch import (  # noqa: E402
    fed3r_vs_fedavg,
    personalized_fed3r,
    quickstart,
    serve_demo,
    streaming_fed3r,
    train_fed3r_ft,
)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import Fed3RConfig as JFed3RConfig  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core import fed3r as jfed3r  # noqa: E402
from repro.core.random_features import rff_init as jrff_init  # noqa: E402
from repro.data import make_federated_features as jmake_federated_features  # noqa: E402
from repro.data.pipeline import pack_arrival_waves as jpack_arrival_waves  # noqa: E402
from repro.data.pipeline import pack_personal_cohort as jpack_personal_cohort  # noqa: E402
from repro.data.synthetic import make_feature_dataset as jmake_feature_dataset  # noqa: E402
from repro.data.synthetic import make_token_dataset as jmake_token_dataset  # noqa: E402
from repro.federated import personalization as jpers  # noqa: E402
from repro.federated import run_fed3r as jrun_fed3r  # noqa: E402
from repro.federated import streaming_engine as jstream  # noqa: E402
from repro.federated.costs import CostModel as JCostModel  # noqa: E402
from repro.federated.simulator import linear_head_task as jlinear_head_task  # noqa: E402
from repro.federated.simulator import run_federated as jrun_federated  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.core.random_features import rff_params_from_jax  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset  # noqa: E402
from repro_torch.data.synthetic import FeatureDataset, TokenDataset  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

CPU = ["--device", "cpu"]
TRAIN_ARCH = "fed3r-mnv2-proxy-smoke"
SERVE = dict(B=2, S=16, gen=6)


def _served(arch):
    """The reference serve's draws for ``arch`` (its ``PRNGKey(0)`` weights,
    prompts and frames) and the greedy tokens of its prefill + decode loop
    on them, in fp32."""
    B, S, gen = SERVE["B"], SERVE["S"], SERVE["gen"]
    jcfg = jget_config(arch).replace(dtype="float32")
    rng = jax.random.PRNGKey(0)
    jparams = jbuild_model(jcfg).init(rng)
    fed = {"tokens": jax.random.randint(rng, (B, S), 0, jcfg.vocab_size)}
    if jcfg.arch_type == "audio":
        fed["audio_frames"] = 0.1 * jax.random.normal(rng, (B, jcfg.n_audio_frames, jcfg.d_model))
    prefill = jax.jit(lambda p, f: jmodel.prefill(jcfg, p, f, S + gen))
    decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(jcfg, p, c, t, pos))
    logits, cache = prefill(jparams, fed)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, cache = decode(jparams, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    return (jax.tree.map(np.asarray, jparams), {k: np.asarray(v) for k, v in fed.items()},
            np.concatenate(want, axis=1))


@pytest.fixture(scope="module", autouse=True)
def slow_references():
    """The reference's ``train.run`` (one FT round) and its served smokes,
    computing in threads while the module's tests run."""
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {"train": pool.submit(jtrain.run, TRAIN_ARCH, rounds=1, verbose=False),
               "serve": pool.submit(lambda: {arch: _served(arch) for arch in serve_demo.ARCHS})}
    yield futures
    pool.shutdown(wait=True)


def _one_sample(got, want, n) -> None:
    """Accuracies within one of ``n`` test samples."""
    assert np.abs(np.subtract(got, want)).max() <= 1.0 / n + 1e-9, (got, want)


def _reference_federation(monkeypatch, module):
    """``module.make_federated_features`` drawing the reference's federation
    (its JAX draws), the test set as the port's CPU tensors; returns the
    reference's own draws, by seed, as they are made."""
    drawn = {}

    def make(seed, n, d, n_classes, n_clients, alpha, *, noise, device, **kw):
        fed, test = jmake_federated_features(seed=seed, n=n, d=d, n_classes=n_classes,
                                             n_clients=n_clients, alpha=alpha, noise=noise, **kw)
        drawn[seed] = (fed, test)
        ptest = FeatureDataset(torch.as_tensor(np.array(test.features)),
                               torch.as_tensor(np.array(test.labels)).long(), n_classes)
        return FederatedDataset(np.asarray(fed.features), np.asarray(fed.labels),
                                fed.client_indices, fed.n_classes), ptest

    monkeypatch.setattr(module, "make_federated_features", make)
    return drawn


def test_quickstart(monkeypatch):
    """The round table (rounds, clients seen, accuracies) of the reference's
    ``run_fed3r``, convergence in ⌈100/10⌉ rounds, and the federated head
    within 1e-5 of the centralized solve, as the reference's."""
    drawn = _reference_federation(monkeypatch, quickstart)
    got = quickstart.main(CPU)
    fed, test = drawn[0]
    f3 = JFed3RConfig(ridge_lambda=0.01, n_classes=10)
    fc = JFederatedConfig(n_clients=100, clients_per_round=10, n_rounds=100)
    W, _, hist = jrun_fed3r(fed, test.features, test.labels, f3, fc, eval_every=1)
    cen = jfed3r.solve(jfed3r.client_stats(jnp.asarray(fed.features), jnp.asarray(fed.labels),
                                           10), 0.01)
    assert got["rounds"] == hist.rounds and got["rounds"][-1] == 10
    assert got["clients_seen"] == hist.clients_seen
    _one_sample(got["accuracy"], hist.accuracy, got["n_test"])
    assert got["gap"] <= 1e-5 and float(jnp.max(jnp.abs(W - cen))) <= 1e-5


def test_streaming_fed3r():
    """On the reference's pool (``PRNGKey(99)``): one engine dispatch
    against T legacy ones, the served accuracy within one test sample of
    the reference engine's, the factored engine within 1e-5 of the batch
    re-solve, and the legacy Woodbury path off by far more, as in the
    reference."""
    pool = jmake_feature_dataset(jax.random.PRNGKey(99), 6000, streaming_fed3r.D,
                                 streaming_fed3r.C, noise=2.0)
    x, y = np.asarray(pool.features), np.asarray(pool.labels)
    got = streaming_fed3r.main(CPU, pool=(x, y))
    waves = [[(x[2000 + 400 * t:2200 + 400 * t], y[2000 + 400 * t:2200 + 400 * t]),
              (x[2200 + 400 * t:2400 + 400 * t], y[2200 + 400 * t:2400 + 400 * t])]
             for t in range(streaming_fed3r.T)]
    packed = jpack_arrival_waves(waves)
    cfg = jstream.StreamConfig(n_classes=streaming_fed3r.C, ridge_lambda=streaming_fed3r.LAM,
                               refresh_every=1)
    engine = jstream.StreamingEngine(cfg)
    state, _ = engine.absorb(engine.init(streaming_fed3r.D), packed)
    acc = float(jfed3r.accuracy(state.W, pool.features[:2000], pool.labels[:2000]))
    W_batch, _ = jstream.batch_equivalent(packed, cfg)
    assert (got["n_waves"], got["n_samples"]) == (packed.n_waves, packed.n_samples)
    assert (got["dispatches"], got["legacy_dispatches"]) == (engine.dispatches,
                                                             streaming_fed3r.T) == (1, 10)
    _one_sample(got["accuracy"], acc, got["n_test"])
    assert got["err_factored"] <= 1e-5
    assert float(jnp.max(jnp.abs(state.W - W_batch))) <= 1e-5
    assert got["err_legacy"] > 100 * got["err_factored"]


def test_personalized_fed3r(monkeypatch):
    """On the reference's federation (seed 3): the α each tenant's sweep
    picks equal to the reference engine's, the per-tenant accuracies of the
    global and the personalized heads within one of the tenant's evaluation
    samples, the engine within 1e-5 of the per-client loop, one dispatch
    against K + 1, and every α = 0 head bitwise the global one."""
    drawn = _reference_federation(monkeypatch, personalized_fed3r)
    got = personalized_fed3r.main(CPU)
    fed, _ = drawn[3]
    D, C, LAM, K = (personalized_fed3r.D, personalized_fed3r.C, personalized_fed3r.LAM,
                    personalized_fed3r.K)
    clients, evals = [], []
    for k in range(K):
        cd = fed.client(k)
        labels = np.asarray(cd.labels)
        if k % 2 == 1:
            i, j = np.random.default_rng((3, k)).choice(C, size=2, replace=False)
            perm = np.arange(C)
            perm[[i, j]] = perm[[j, i]]
            labels = perm[labels]
        half = max(cd.n // 2, 1)
        clients.append((cd.features[:half], labels[:half]))
        evals.append((cd.features[half:], labels[half:]))
    packed = jpack_personal_cohort(clients, client_ids=list(range(K)))
    stats = jpers.cohort_stats(packed, C)
    state = jfed3r.Fed3RFactored(L=jnp.linalg.cholesky(stats.A + LAM * jnp.eye(D)), b=stats.b)
    W_global = jfed3r.factored_solution(state)
    heads = jpers.PersonalizationEngine(jpers.PersonalizeConfig(
        n_classes=C, alpha_grid=(0.0, 1.0, 4.0, 16.0, 64.0))).solve_heads(state, packed)
    assert got["alpha"] == np.asarray(heads.alpha).tolist()
    assert got["n_eval"] == [len(y) for _, y in evals]
    for k, (x, y) in enumerate(evals):
        x, y = jnp.asarray(x), jnp.asarray(np.asarray(y))
        _one_sample(got["acc_global"][k], float(jfed3r.accuracy(W_global, x, y)), len(y))
        _one_sample(got["acc_personalized"][k], float(jfed3r.accuracy(heads.W[k], x, y)),
                    len(y))
    assert got["engine_vs_loop"] <= 1e-5
    assert (got["dispatches"], got["loop_dispatches"]) == (1, K + 1)
    assert got["alpha0_bitwise"] and 0.0 in got["alpha"]


def test_fed3r_vs_fedavg(monkeypatch):
    """At 10 rounds of the LP baselines, on the reference's federation, RFF
    map and LP head: each row's rounds equal and final accuracy within one
    test sample of the reference's ``run_fed3r`` / ``run_federated``, its
    upload and FLOPs equal to the reference's cost meters.  The reference
    script stops at the FED3R-RF row (its ``CostModel`` has D = 0 there);
    the row is held against ``CostModel(..., D=1024)`` called directly."""
    R = 10
    D, C, K = fed3r_vs_fedavg.D, fed3r_vs_fedavg.C, fed3r_vs_fedavg.K
    drawn = _reference_federation(monkeypatch, fed3r_vs_fedavg)
    monkeypatch.setattr(fed3r_vs_fedavg, "draw_rff", lambda d, n, sigma, seed: rff_params_from_jax(
        *jrff_init(jax.random.PRNGKey(seed + 101), d, n, sigma), device="cpu"))
    monkeypatch.setattr(fed3r_vs_fedavg, "draw_head", lambda d, n: torch.from_numpy(np.array(
        0.01 * jax.random.normal(jax.random.PRNGKey(0), (d, n), jnp.float32))))
    got = fed3r_vs_fedavg.main(CPU + ["--rounds", str(R)])["rows"]
    fed, test = drawn[0]
    n_test = len(test.labels)
    avg_nk = fed.client_sizes().mean()
    with pytest.raises(AssertionError):  # the reference script's crash, on the rf row
        JCostModel(b=2.22e6, d=D, C=C, E=1).comm_per_client("fed3r-rf")
    for name, rf in (("fed3r", 0), ("fed3r-rf", 1024)):
        _, _, h = jrun_fed3r(fed, test.features, test.labels,
                             JFed3RConfig(n_classes=C, n_random_features=rf, rff_sigma=12.0),
                             JFederatedConfig(n_clients=K, clients_per_round=10, n_rounds=100),
                             eval_every=1)
        cm = JCostModel(b=2.22e6, d=D, C=C, E=1, D=rf)
        assert got[name]["rounds"] == h.rounds[-1] == 10
        _one_sample(got[name]["acc"], h.accuracy[-1], n_test)
        assert got[name]["up_bytes"] == cm.comm_per_client(name)["up"] * 4
        assert got[name]["flops"] == pytest.approx(cm.comp_per_client(name, avg_nk), rel=1e-12)
    cm = JCostModel(b=2.22e6, d=D, C=C, E=1)
    for alg, smom in (("fedavg", 0.0), ("fedavgm", 0.9), ("scaffold", 0.0)):
        task = jlinear_head_task(D, C, test.features, test.labels)
        fc = JFederatedConfig(n_clients=K, clients_per_round=10, n_rounds=R, local_epochs=1,
                              local_batch_size=32, client_lr=0.1, algorithm=alg,
                              server_momentum=smom)
        _, h = jrun_federated(task, fed, fc, eval_every=10)
        lp = ("fedavg" if alg != "scaffold" else "scaffold") + "-lp"
        row = got[alg + "-lp"]
        assert row["rounds"] == R
        _one_sample(row["acc"], h.accuracy[-1], n_test)
        assert row["up_bytes"] == cm.comm_per_client(lp)["up"] * 4 * R
        assert row["flops"] == pytest.approx(
            cm.cumulative_comp_flops_per_client(lp, R, 10, K, avg_nk)[-1], rel=1e-12)


def test_serve_demo(monkeypatch, slow_references):
    """The four smoke families on the reference serve's own draws (its
    ``PRNGKey(0)`` weights, prompts and frames), in fp32: the greedy tokens
    equal to the reference's prefill + decode loop's; the CPU launches no
    kernel."""
    refs = slow_references["serve"].result()

    def draw(cfg, batch, prompt_len, seed):
        jparams, fed, _ = refs[cfg.name]
        return (params_from_jax(cfg, jparams, device="cpu"),
                torch.from_numpy(fed["tokens"]).long(),
                {k: torch.from_numpy(v) for k, v in fed.items() if k != "tokens"})

    monkeypatch.setattr(serve_demo, "draw", draw)
    got = serve_demo.main(CPU + ["--dtype", "float32", "--batch", str(SERVE["B"]),
                                 "--prompt-len", str(SERVE["S"]), "--gen", str(SERVE["gen"])])
    assert list(got) == list(serve_demo.ARCHS)
    for arch, (_, _, want) in refs.items():
        np.testing.assert_array_equal(got[arch]["tokens"], want)
        assert got[arch]["prefill_launches"] == got[arch]["decode_launches"] == 0


def test_train_fed3r_ft(monkeypatch, slow_references):
    """One FT round after the statistics pass, from the reference's
    ``PRNGKey(0)`` backbone and ``PRNGKey(1)`` token data: the closed-form
    accuracy and the accuracy after the round within one test sample of
    the reference's ``run``."""
    jcfg = jget_config(TRAIN_ARCH)
    jparams = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))

    def init(self, seed=0, device="cuda"):
        return params_from_jax(self.cfg, jparams, device=device)

    def tokens(gen, n, seq_len, vocab_size, n_classes):
        ds = jmake_token_dataset(jax.random.PRNGKey(1), n, seq_len, vocab_size, n_classes)
        return TokenDataset(*(torch.from_numpy(np.array(t)).long().to(gen.device)
                              for t in ds[:3]), n_classes=n_classes)

    monkeypatch.setattr(model_mod.Model, "init", init)
    monkeypatch.setattr(train_mod, "make_token_dataset", tokens)
    got = train_fed3r_ft.main(CPU + ["--rounds", "1"])
    want = slow_references["train"].result()
    assert got["rounds"] == want["rounds"] == [1]
    _one_sample(got["fed3r_acc"], want["fed3r_acc"], got["n_test"])
    _one_sample(got["ft_acc"], want["ft_acc"], got["n_test"])
