"""The port's FED3R statistics pass, end to end, against the reference.

* Train phase 1 at the smoke config, fed the reference's params and tokens,
  against the reference's phase 1 (its engine, solve and calibration) —
  both in fp32 activations, so the comparison is of the algorithm, not of
  bf16 rounding (``test_torch_models.py`` covers bf16).
* ``run_fed3r`` / ``run_fedncm`` against the reference's drivers, with
  exact convergence in ⌈K/κ⌉ rounds.
* The copied ``ClientSampler`` draws exactly the reference's clients.
* The device rule, and that the port imports without jax.
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import Fed3RConfig as JFed3RConfig  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core import calibration as jcal  # noqa: E402
from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data import make_federated_features as jmake_federated_features  # noqa: E402
from repro.data.partition import dirichlet_partition as jpartition  # noqa: E402
from repro.data.pipeline import pack_client_shards as jpack  # noqa: E402
from repro.data.synthetic import make_token_dataset as jmake_token_dataset  # noqa: E402
from repro.federated import run_fed3r as jrun_fed3r  # noqa: E402
from repro.federated import run_fedncm as jrun_fedncm  # noqa: E402
from repro.federated.engine import AccumulationEngine as JEngine  # noqa: E402
from repro.federated.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.federated.sampling import ClientSampler as JClientSampler  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import Fed3RConfig, FederatedConfig  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.data.pipeline import FederatedDataset, make_federated_features  # noqa: E402
from repro_torch.data.synthetic import TokenDataset  # noqa: E402
from repro_torch.federated import fed3r_driver  # noqa: E402
from repro_torch.federated.engine import AccumulationEngine, EngineConfig  # noqa: E402
from repro_torch.federated.sampling import ClientSampler  # noqa: E402
from repro_torch.launch import profile_slice, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCH = "fed3r-mnv2-proxy-smoke"
N_SAMPLES, SEQ, N_CLIENTS, PER_ROUND, N_CLASSES = 160, 16, 8, 4, 8
# fp32 features agree to ~1e-7 relative, the statistics to ~1e-7 of max|A|;
# the λ = 0.01 solve amplifies that by cond(A + λI) ≈ 2.4e5 for these mean-
# pooled features (measured gap 1.3e-4 on W's unit-norm columns)
W_ATOL = 1e-3


def _reference_phase1(jcfg, jparams, jds):
    """The reference's train.py phase 1 (launch/train.py:95-124), inline."""
    model = jbuild_model(jcfg)
    labels_np = np.asarray(jds.labels)
    tokens_np = np.asarray(jds.tokens)
    parts = jpartition(np.random.default_rng(2), labels_np, N_CLIENTS, alpha=0.0)
    n_test = N_SAMPLES // 5
    engine = JEngine(
        JEngineConfig(n_classes=N_CLASSES),
        feature_fn=lambda p, toks: model.extract_features(p, {"tokens": toks}),
    )
    packed = jpack([(tokens_np[parts[k]], labels_np[parts[k]]) for k in range(N_CLIENTS)],
                   clients_per_shard=PER_ROUND)
    acc = engine.accumulate(engine.init(jcfg.d_feat), packed, jparams)
    W = jfed3r.solve(acc.stats, 0.01)
    test_acc = float(jfed3r.accuracy(
        W, model.extract_features(jparams, {"tokens": jds.tokens[:n_test]}), jds.labels[:n_test]))
    scores = jfed3r.predict(W, model.extract_features(
        jparams, {"tokens": jds.tokens[n_test:n_test + 512]}))
    temp, _ = jcal.calibrate_temperature(scores, jds.labels[n_test:n_test + 512])
    return W, acc.stats, test_acc, float(temp)


def test_train_phase1_matches_reference():
    jcfg = jget_config(ARCH).replace(dtype="float32")
    cfg = get_config(ARCH).replace(dtype="float32")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jds = jmake_token_dataset(jax.random.PRNGKey(1), N_SAMPLES, SEQ, jcfg.vocab_size, N_CLASSES)
    W_ref, stats_ref, acc_ref, T_ref = _reference_phase1(jcfg, jparams, jds)

    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ds = TokenDataset(
        tokens=torch.from_numpy(np.array(jds.tokens)), labels=torch.from_numpy(np.array(jds.labels)),
        lm_labels=torch.from_numpy(np.array(jds.lm_labels)), n_classes=N_CLASSES,
    )
    out = train.fed3r_phase(cfg, params, ds, n_clients=N_CLIENTS,
                            clients_per_round=PER_ROUND, device="cpu", verbose=False)
    A_ref = np.asarray(stats_ref.A)
    assert float(np.abs(out["stats"].A.numpy() - A_ref).max()) <= 1e-5 * np.abs(A_ref).max()
    assert float(out["stats"].n) == float(stats_ref.n) == N_SAMPLES
    np.testing.assert_allclose(out["W"].numpy(), np.asarray(W_ref), rtol=0, atol=W_ATOL)
    assert out["fed3r_acc"] == pytest.approx(acc_ref, abs=1.0 / (N_SAMPLES // 5))
    assert out["temperature"] == T_ref
    assert out["n_slots"] == N_CLIENTS  # 8 clients, 4 per shard: no empty slot


@pytest.fixture(scope="module")
def fed_data():
    fed, test = jmake_federated_features(seed=0, n=1500, d=32, n_classes=6, n_clients=20,
                                         alpha=0.0, noise=1.5)
    port_fed = FederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    return fed, test, port_fed


def _fc(mod, **kw):
    base = dict(n_clients=20, clients_per_round=5, n_rounds=20, seed=0)
    base.update(kw)
    return mod(**base)


def test_run_fed3r_matches_reference_and_converges_in_k_over_kappa(fed_data):
    fed, test, pfed = fed_data
    tf, tl = np.asarray(test.features), np.asarray(test.labels)
    W, stats, hist = fed3r_driver.run_fed3r(
        pfed, tf, tl, Fed3RConfig(n_classes=6), _fc(FederatedConfig), eval_every=1, device="cpu")
    Wr, stats_r, hist_r = jrun_fed3r(fed, test.features, test.labels, JFed3RConfig(n_classes=6),
                                     _fc(JFederatedConfig), eval_every=1)
    assert hist.rounds[-1] == hist_r.rounds[-1] == -(-20 // 5)  # ⌈K/κ⌉ = 4
    assert hist.clients_seen == hist_r.clients_seen
    # 32-dim solve of 1200 well-spread samples: fp32 reassociation only
    np.testing.assert_allclose(W.numpy(), np.asarray(Wr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(hist.accuracy, hist_r.accuracy, rtol=0, atol=1.0 / len(tl))
    cen = fed3r.solve(fed3r.client_stats(torch.from_numpy(np.array(fed.features)),
                                         torch.from_numpy(np.array(fed.labels)), 6), 0.01)
    np.testing.assert_allclose(W.numpy(), cen.numpy(), rtol=0, atol=1e-5)


def test_run_fedncm_matches_reference(fed_data):
    fed, test, pfed = fed_data
    W, hist = fed3r_driver.run_fedncm(pfed, np.asarray(test.features), np.asarray(test.labels),
                                      _fc(FederatedConfig), device="cpu")
    Wr, hist_r = jrun_fedncm(fed, test.features, test.labels, _fc(JFederatedConfig))
    np.testing.assert_allclose(W.numpy(), np.asarray(Wr), rtol=0, atol=1e-5)
    assert hist.rounds == hist_r.rounds == [4]
    assert hist.accuracy[0] == pytest.approx(hist_r.accuracy[0], abs=1.0 / len(test.labels))


@pytest.mark.parametrize("replacement", [False, True])
@pytest.mark.parametrize("n_clients,per_round,seed", [(20, 5, 0), (7, 3, 4), (100, 10, 1)])
def test_client_sampler_draws_the_reference_clients(replacement, n_clients, per_round, seed):
    got = ClientSampler(n_clients, per_round, replacement=replacement, seed=seed)
    want = JClientSampler(n_clients, per_round, replacement=replacement, seed=seed)
    for _ in range(12):
        assert np.array_equal(got.sample(), want.sample())
    assert got.seen == want.seen and got.coverage == want.coverage
    assert got.rounds_to_full_coverage() == want.rounds_to_full_coverage()


def test_fed3r_rf_and_finetuning_are_not_ported_yet(fed_data):
    # both are ported now: FED3R-RF (tests/test_torch_rff.py holds it against
    # the reference) and fine-tuning (tests/test_torch_ft.py); train.run
    # takes rounds > 0 and runs phase 2 after phase 1
    _, test, pfed = fed_data
    W, stats, _ = fed3r_driver.run_fed3r(pfed, np.asarray(test.features), np.asarray(test.labels),
                                         Fed3RConfig(n_classes=6, n_random_features=64),
                                         _fc(FederatedConfig), device="cpu")
    assert W.shape == (64, 6) and stats.A.shape == (64, 64)
    out = train.run(ARCH, rounds=1, n_clients=8, clients_per_round=4, n_samples=160,
                    seq_len=16, n_classes=8, local_batch_size=8, device="cpu", verbose=False)
    assert int(out["ft"]["state"].round) == 1 and out["ft"]["rounds"] == [1]


def test_profile_slice_measures_the_card_only():
    with pytest.raises(RuntimeError, match="card only"):
        profile_slice.profile_phase1(ARCH, device="cpu")
    with pytest.raises(RuntimeError, match="card only"):
        profile_slice.profile_serve("qwen2-7b-smoke", batch=1, prompt_len=4, gen=2, device="cpu")
    with pytest.raises(RuntimeError, match="card only"):
        profile_slice.profile_ft(device="cpu")
    assert profile_slice.kernel_group(
        "void (anonymous namespace)::flash_bf16_kernel<128>(Args)").startswith("flash_attention")
    assert profile_slice.kernel_group("fed3r_stats_kernel") == "fed3r_stats (the port's CUDA kernel)"
    assert profile_slice.kernel_group("nvjet_tst_128x64").startswith("GEMM")
    assert profile_slice.kernel_group("void at::native::elementwise_kernel<...>").startswith("other elementwise")
    assert profile_slice.kernel_group("ampere_something_unknown") == "other"


def test_profile_rf_cell_is_the_simulator_setup_and_runs_on_the_card_only():
    """profile_slice --cell rf profiles the cell chip_smoke.py's [rf] checks:
    both build it from repro_torch.configs.simulator, and it refuses the CPU
    before it makes any data; its kernel groups name rff and the solves."""
    from repro_torch.configs import simulator

    with pytest.raises(RuntimeError, match="card only"):
        profile_slice.profile_rf(device="cpu")
    assert simulator.RF_D == 5000 and simulator.FEATURES["d"] == 1280
    assert profile_slice.kernel_group("void rff_kernel<64>(...)").startswith("rff")
    assert profile_slice.kernel_group("potrf_alg2_kernel").startswith("Cholesky")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    fed = FederatedDataset(np.zeros((4, 3), np.float32), np.zeros(4, np.int32),
                           [np.arange(4)], 1)
    calls = [
        lambda: train.run(ARCH),
        lambda: profile_slice.profile_phase1(ARCH),
        lambda: fed3r_driver.run_fed3r(fed, np.zeros((1, 3)), np.zeros(1), Fed3RConfig(n_classes=1),
                                       FederatedConfig(n_clients=1, clients_per_round=1)),
        lambda: fed3r_driver.run_fedncm(fed, np.zeros((1, 3)), np.zeros(1),
                                        FederatedConfig(n_clients=1, clients_per_round=1)),
        lambda: AccumulationEngine(EngineConfig(n_classes=2)),
        lambda: make_federated_features(0, 10, 3, 2, 2, 0.0),
        lambda: build_model(get_config(ARCH)).init(),
        lambda: fed3r.init_stats(3, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_imports_without_jax_or_the_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 30  # every module of the port was imported
    for name in ("federated.personalization", "federated.slots", "launch.serve_heads",
                 "launch.serving_engine", "launch.serve_stream", "kernels.chol_update",
                 "federated.compress", "federated.secure_agg", "federated.costs",
                 "kernels.quant", "kernels.flash_attention", "launch.serve", "launch.steps",
                 "configs.qwen2_7b", "checkpoint", "checkpoint.checkpoint", "optim",
                 "optim.optim", "optim.schedules", "federated.algorithms",
                 "federated.round_engine", "federated.simulator", "federated.fed3r_driver",
                 "core.probe", "federated.engine", "models.model", "launch.train",
                 "models.convert", "tree", "federated.async_engine", "federated.tiers",
                 "launch.mesh", "launch.obs_report", "launch.world", "launch.dist_check",
                 "sharding", "sharding.specs", "models.moe", "models.transformer",
                 "configs.deepseek_moe_16b", "configs.llama4_scout_17b_a16e",
                 "configs.command_r_plus_104b", "configs.deepseek_coder_33b",
                 "configs.minitron_8b", "models.ssm", "models.rglru", "configs.mamba2_1_3b",
                 "configs.recurrentgemma_9b", "configs.qwen2_vl_2b"):
        assert "repro_torch." + name in names
