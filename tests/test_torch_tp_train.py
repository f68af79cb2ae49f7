"""The backward under a "model" axis against the reference's unsharded
gradients, on gloo ranks on the CPU.

One module-scoped 4-rank world (:func:`repro_torch.launch.world.run_world`)
runs :func:`repro_torch.launch.dist_check.tp_train_program` while the
references are computed in the test's thread:

* ``lm_loss``'s gradient of the six smokes ``chip_smoke.py``'s ``[tp]``
  runs, of ``fed3r-mnv2-proxy-smoke`` and of a dense smoke of 6 heads (its
  q, k and v row-parallel at model 4: 6 and its 2 kv heads do not divide 4),
  in fp32 on host meshes (data 1, model 4) and (data 2, model 2), each rank
  holding its blocks of the reference's weights (``params_from_jax`` then
  ``shard_params``) and its rows of a seeded batch.  A rank's gradient
  follows GSPMD's convention (the loss seeded once over "model", the
  replicated leaves' gradients summed over it, the mean over "data": the
  global batch's gradient); gathered over "model" it is held leaf by leaf
  against ``jax.grad`` of the reference's ``lm_loss`` on the whole batch;
* one ``RoundEngine.step`` of FT at (2, 2) for FedAvg, FedAvgM and FedProx
  against the reference's ``RoundEngine.step`` on the same numpy weights,
  head and clients;
* ``launch/train.py``'s ``run`` (2 FT rounds) at (2, 2) and (1, 4)
  against the one-process driver, a resume from its round-1 checkpoint
  bitwise, the checkpoint's leaves at global shapes; and what stays
  refused.

A 2-rank world runs ``make_train_step`` with 2 microbatches at (1, 2)
against the reference's step, and ``train.run`` at (1, 2).
"""
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import pack_cohort_batches as jpack_cohort_batches  # noqa: E402
from repro.federated.algorithms import make_algorithm as jmake_algorithm  # noqa: E402
from repro.federated.round_engine import RoundConfig as JRoundConfig  # noqa: E402
from repro.federated.round_engine import RoundEngine as JRoundEngine  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dist_check, train  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sharding.specs import map_with_path  # noqa: E402
from torch_families import check_cross_split, cross_split_reference  # noqa: E402

REL = 1e-5  # of a leaf's max|g|: summation order only (most leaves read ~1e-6)
# leaves that need more, each with its limit and reason:
# * an attention key bias: its gradient is zero in exact arithmetic (a
#   softmax is blind to one shift of every key), so what is there is
#   rounding; held at REL of the largest |g| of the whole tree;
# * Whisper's decoder cross-attention q and k leaves and the norm before
#   it: their gradients, 1e-4 of the tree's largest, are what is left
#   after the softmax's centring cancels the rest; the two packages
#   unsharded differ by up to 1.6e-4 of such a leaf's max|g|;
# * Mamba2's A_log: its gradient sums the decays of every position of a
#   chunk; the two packages unsharded differ by 1.36e-5 of its max|g|.
LEAF_RELS = ((r"/bk$", "tree", REL),
             (r"dec_layers/\d+/(cross_attn/(wq|wk|bq)|norm2/(scale|bias))$", "leaf", 1e-3),
             (r"ssm/A_log$", "leaf", 1e-4))
# a round and the train step against the reference: fp32 reassociation
# (tests/test_torch_ft.py's limits)
FT_F32_REL = 1e-4
# train.run's proxy smoke computes in bf16: the sharded partial sums round
# apart; a few bf16 ulps of max|dtheta| (read 2.4e-3 at (1, 2), 3.2e-3 at
# (2, 2) and (1, 4))
FT_BF16_REL = 4 * 2.0 ** -8

WORLD = 4
MESHES = [(1, 4), (2, 2)]
HEADS6 = "dense, 6 heads"
# label -> (arch, config replacements, B, S): the hybrid's S past its
# window of 32; Mamba2's one SSD chunk
GRADS = {
    "deepseek-moe-16b-smoke": ("deepseek-moe-16b-smoke", {}, 4, 8),
    "qwen2-7b-smoke": ("qwen2-7b-smoke", {}, 4, 8),
    "recurrentgemma-9b-smoke": ("recurrentgemma-9b-smoke", {}, 2, 40),
    "qwen2-vl-2b-smoke": ("qwen2-vl-2b-smoke", {}, 2, 8),
    "whisper-large-v3-smoke": ("whisper-large-v3-smoke", {}, 2, 8),
    "mamba2-1.3b-smoke": ("mamba2-1.3b-smoke", {}, 2, 16),
    "fed3r-mnv2-proxy-smoke": ("fed3r-mnv2-proxy-smoke", {}, 2, 8),
    HEADS6: ("qwen2-7b-smoke", {"n_heads": 6}, 2, 8),
}
PLANTED = "qwen2-vl-2b-smoke"  # tp_grad_job's reference and planted faults
ALGOS = ("fedavg", "fedavgm", "fedprox")
ROUND = dict(arch="fed3r-mnv2-proxy-smoke", lr=0.1, local_batch_size=4, n_batches=2,
             n_clients=10, n_classes=8, sizes=(5, 8, 3, 7), S=12)
RUN = dict(dist_check.TRAIN, rounds=2, use_fed3r_init=False)
STEP = dict(arch="qwen2-7b-smoke", lr=0.1, num_microbatches=2, B=4, S=16)


def _name(label, mesh):
    return f"{label}@{mesh[0]}x{mesh[1]}"


def _reference_grad(jcfg, jparams, batch, G):
    """jax.grad of the reference's lm_loss on the whole batch, at G MoE
    capacity groups (its "data" axis)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "mesh_axis_size", lambda name: G if name == "data" else 1)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return jax.tree.map(np.asarray, jax.jit(jax.grad(
            lambda p: jmodel.lm_loss(jcfg, p, jb)))(jparams))


def _clients(seed=3):
    rng = np.random.default_rng(seed)
    vocab = jget_config(ROUND["arch"]).vocab_size
    return [(rng.integers(0, vocab, (n, ROUND["S"])).astype(np.int32),
             rng.integers(0, ROUND["n_classes"], n).astype(np.int32)) for n in ROUND["sizes"]]


def _reference_round(jcfg, jparams, head, clients, algorithm):
    """The reference's RoundEngine.step of FT (everything trains)."""
    freeze = jax.tree.map(lambda _: 1.0, {"backbone": jparams, "head": head})
    eng = JRoundEngine(JRoundConfig(algo=jmake_algorithm(algorithm), client_lr=ROUND["lr"],
                                    n_total_clients=ROUND["n_clients"]),
                       jsteps.make_cls_per_example_loss(jcfg), freeze)
    state = eng.init({"backbone": jparams, "head": jax.tree.map(jnp.asarray, head)})
    cohort = jpack_cohort_batches(clients, ROUND["local_batch_size"], ROUND["n_batches"],
                                  client_ids=np.arange(len(clients)), seed=(3, 0))
    return jax.tree.map(np.asarray, eng.step(state, cohort).params)


def _run_world(n, args, box, key):
    try:
        box[key] = run_world(dist_check.tp_train_program, n, backend="gloo", device="cpu",
                             timeout_s=300, args=args)
    except Exception as e:  # re-raised below, in the test's thread
        box["error"] = e


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_train")
    inits, grads, todo = {}, [], []
    for label, (arch, over, B, S) in GRADS.items():
        jcfg = jget_config(arch).replace(dtype="float32", **over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        params_np = jax.tree.map(np.asarray, jparams)
        batch = dist_check.grad_batch(jcfg, 1, B, S)
        inits[label] = (jcfg, jparams, batch)
        for mesh in MESHES:
            grads.append(dict(name=_name(label, mesh), arch=arch, data=mesh[0], model=mesh[1],
                              overrides={"dtype": "float32", **over}, params=params_np,
                              batch=batch))
            if mesh == MESHES[0] or jcfg.arch_type == "moe":
                todo.append((_name(label, mesh), label, mesh[0]))
    # the unsharded gradient on rank 0, scattered, against the ranks' and
    # with each planted fault
    pcfg = get_config(PLANTED).replace(dtype="float32")
    grads.append(dict(name="planted", arch=PLANTED, data=1, model=WORLD,
                      overrides={"dtype": "float32"}, seed=0,
                      batch=dist_check.grad_batch(pcfg, 21, 2, 8), reference=True,
                      faults=dist_check.GRAD_FAULTS))
    # a round: the proxy smoke in fp32, the reference's weights and a head
    rcfg = jget_config(ROUND["arch"]).replace(dtype="float32")
    rparams = jbuild_model(rcfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(4)
    head = {"W": (0.1 * rng.standard_normal((rcfg.d_feat, ROUND["n_classes"]))
                  ).astype(np.float32), "b": np.zeros(ROUND["n_classes"], np.float32)}
    clients = _clients()
    start = {"backbone": jax.tree.map(np.asarray, rparams), "head": head}
    rounds = [dict(name=algo, arch=ROUND["arch"], model=2, overrides={"dtype": "float32"},
                   params=jax.tree.map(np.asarray, rparams), head=head, clients=clients,
                   client_ids=np.arange(len(clients)), algorithm=algo, lr=ROUND["lr"],
                   local_batch_size=ROUND["local_batch_size"], n_batches=ROUND["n_batches"],
                   seed=(3, 0), n_clients=ROUND["n_clients"]) for algo in ALGOS]
    ft4 = [dict(name=_name("ft", mesh), arch=dist_check.TRAIN_ARCH, model=mesh[1], run=RUN,
                root=str(root / _name("ckpt", mesh))) for mesh in ((2, 2), (1, 4))]
    # the 2-rank world: make_train_step at (1, 2) and train.run at (1, 2)
    scfg = jget_config(STEP["arch"]).replace(dtype="float32")
    sparams = jbuild_model(scfg).init(jax.random.PRNGKey(5))
    sbatch = dist_check.grad_batch(scfg, 6, STEP["B"], STEP["S"])
    steps2 = [dict(name="step", arch=STEP["arch"], model=2, overrides={"dtype": "float32"},
                   params=jax.tree.map(np.asarray, sparams), batch=sbatch, lr=STEP["lr"],
                   num_microbatches=STEP["num_microbatches"])]
    ft2 = [dict(name=_name("ft", (1, 2)), arch=dist_check.TRAIN_ARCH, model=2, run=RUN,
                root=str(root / _name("ckpt", (1, 2))))]

    box = {}
    runners = [threading.Thread(target=_run_world, args=(
                   WORLD, (grads, rounds, ft4, (), True), box, 4)),
               threading.Thread(target=_run_world, args=(2, ((), (), ft2, steps2), box, 2))]
    for r in runners:
        r.start()
    try:
        refs = {name: _reference_grad(*inits[label], G) for name, label, G in todo}
        refs.update({algo: _reference_round(rcfg, rparams, head, clients, algo)
                     for algo in ALGOS})
        refs["round start"] = start
        jp2, jloss = jsteps.make_train_step(scfg, lr=STEP["lr"],
                                            num_microbatches=STEP["num_microbatches"])(
            sparams, {k: jnp.asarray(v) for k, v in sbatch.items()})
        refs["step"] = (jax.tree.map(np.asarray, sparams), jax.tree.map(np.asarray, jp2),
                        float(jloss))
        refs["one"] = train.run(dist_check.TRAIN_ARCH, device="cpu", verbose=False, **RUN)
        refs["one phase 1"] = train.run(dist_check.TRAIN_ARCH, device="cpu", verbose=False,
                                        **dict(RUN, rounds=0, use_fed3r_init=True))["stats"]
    finally:
        for r in runners:
            r.join()
    if "error" in box:
        raise box["error"]
    for label, (arch, *_rest) in GRADS.items():
        if get_config(arch).arch_type != "moe":
            refs[_name(label, MESHES[1])] = refs[_name(label, MESHES[0])]
    return box[4], box[2], refs


def _flat(cfg, tree, from_jax):
    """{path: numpy leaf} of a gradient in the port's layout."""
    if from_jax:
        tree = params_from_jax(cfg, tree, device="cpu")
    out = {}
    map_with_path(tree, lambda path, x: out.__setitem__("/".join(path), np.asarray(x)))
    return out


def _leaf_limit(path, leaf_max, tree_max):
    for pattern, scale, rel in LEAF_RELS:
        if re.search(pattern, path):
            return rel * (tree_max if scale == "tree" else leaf_max)
    return REL * leaf_max


GRAD_CASES = [(label, mesh) for label in GRADS for mesh in MESHES]


@pytest.mark.parametrize("label,mesh", GRAD_CASES,
                         ids=[_name(label, mesh) for label, mesh in GRAD_CASES])
def test_sharded_gradient_matches_the_reference(worlds, label, mesh):
    ranks, _, refs = worlds
    name = _name(label, mesh)
    arch, over, _, _ = GRADS[label]
    cfg = get_config(arch).replace(dtype="float32", **over)
    got = _flat(cfg, ranks[0][name]["sound"]["grads"], False)
    want = _flat(cfg, refs[name], True)
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        err = float(np.abs(got[path] - w).max())
        assert err <= _leaf_limit(path, float(np.abs(w).max()), top), (path, err)
    for r in range(WORLD):  # the global batch's gradient, the same bits on every rank
        assert ranks[r][name]["sound"]["digest"] == ranks[0][name]["sound"]["digest"]
        assert ranks[r][name]["coords"] == {"data": r // mesh[1], "model": r % mesh[1]}


@pytest.mark.parametrize("case", ("sound",) + dist_check.GRAD_FAULTS)
def test_unsharded_reference_and_planted_faults(worlds, case):
    """``tp_grad_job`` with ``reference``, as ``chip_smoke.py`` runs it at
    full width: rank 0's unsharded gradient of ``seeded_factory(0)``
    weights, scattered to the ranks, against the sharded one at (1, 4);
    within REL of each leaf's max|g| (a key bias of the tree's largest),
    and each planted fault of the gradient convention far above it."""
    ranks, _, _ = worlds
    gaps = ranks[0]["planted"][case]["gaps"]
    top = max(scale for _, scale in gaps.values())
    worst = max(err / (top if path.endswith("/bk") else scale)
                for path, (err, scale) in gaps.items())
    if case == "sound":
        assert worst <= REL, worst
        assert ranks[0]["planted"]["unsharded"]["ms"] > 0
    else:
        assert worst > 0.5, worst
    for r in range(WORLD):
        assert ranks[r]["planted"][case]["gaps"] == gaps


def _dtheta_gap(got, want, start):
    """max|(got - start) - (want - start)| / max|want - start| over the
    leaves of three {path: leaf} dicts."""
    assert set(got) == set(want) == set(start)
    err = scale = 0.0
    for path in want:
        g, w, s = (np.asarray(x[path], np.float64) for x in (got, want, start))
        assert g.shape == w.shape, path
        err = max(err, float(np.abs((g - s) - (w - s)).max()))
        scale = max(scale, float(np.abs(w - s).max()))
    assert scale > 0
    return err / scale


def _params(cfg, tree, from_jax=False):
    """{path: numpy leaf} of ``{"backbone": ..., "head": ...}``."""
    return {**{f"backbone/{k}": v for k, v in _flat(cfg, tree["backbone"], from_jax).items()},
            "head/W": np.asarray(tree["head"]["W"]), "head/b": np.asarray(tree["head"]["b"])}


@pytest.mark.parametrize("algorithm", ALGOS)
def test_sharded_round_matches_the_reference(worlds, algorithm):
    """One FT round at (2, 2): the clients' local steps tensor-parallel on
    the "model" axis, their deltas summed over "data"; the replicated
    leaves the same bits on a data group's model ranks; the collectives'
    vmap rule reached under the cohort's vmap, in the recompute too."""
    ranks, _, refs = worlds
    cfg = get_config(ROUND["arch"]).replace(dtype="float32")
    got = _params(cfg, ranks[0][algorithm]["params"])
    want = _params(cfg, refs[algorithm], True)
    assert _dtheta_gap(got, want, _params(cfg, refs["round start"], True)) <= FT_F32_REL
    for r in range(WORLD):
        assert ranks[r][algorithm]["replicated"] == ranks[r - r % 2][algorithm]["replicated"]
        # the collectives' vmap rule ran under the cohort's vmap of grad,
        # from the block recompute's backward too
        calls = ranks[r][algorithm]["vmap_rule"]
        assert calls["in a recompute"] > 0 and calls["all"] > calls["in a recompute"], calls


def test_sharded_train_step_matches_the_reference(worlds):
    """make_train_step with 2 microbatches at (1, 2) against the
    reference's (its bf16 compute copy and gradients): dtheta within a few
    bf16 ulps of max|dtheta|, the loss within 1e-5."""
    _, ranks2, refs = worlds
    cfg = get_config(STEP["arch"]).replace(dtype="float32")
    start, want, jloss = refs["step"]
    got = _flat(cfg, ranks2[0]["step"]["params"], False)
    assert _dtheta_gap(got, _flat(cfg, want, True), _flat(cfg, start, True)) <= FT_BF16_REL
    for r in range(2):
        assert ranks2[r]["step"]["loss"] == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_train_run_phase2_matches_one_process_and_resumes_bitwise(worlds, mesh):
    """train.run's phase 1, then 2 FT rounds from the seeded head, at
    (1, 2) (a 2-rank world), (2, 2) and (1, 4) (a 4-rank world) against
    the one-process driver; a resume from the round-1 checkpoint bitwise
    the uninterrupted run on every rank; the checkpoint's leaves whole;
    the replicated leaves the same bits on a data group's model ranks."""
    ranks4, ranks2, refs = worlds
    ranks = ranks4 if mesh[0] * mesh[1] == WORLD else ranks2
    name, m = _name("ft", mesh), mesh[1]
    ranks = [{"ft": r[name]} for r in ranks]
    cfg = get_config(dist_check.TRAIN_ARCH)
    one = refs["one"]
    start = {"backbone": one["params0"], "head": {
        "W": ranks[0]["ft"]["params"]["head"]["W"],  # FT-FEAT: the head does not move
        "b": ranks[0]["ft"]["params"]["head"]["b"]}}
    got = _params(cfg, ranks[0]["ft"]["params"])
    want = _params(cfg, {"backbone": one["ft"]["state"].params["backbone"],
                         "head": one["ft"]["state"].params["head"]})
    assert _dtheta_gap(got, want, _params(cfg, start)) <= FT_BF16_REL
    np.testing.assert_array_equal(got["head/W"], want["head/W"])
    for r, res in enumerate(ranks):
        assert res["ft"]["resume_bitwise"] and res["ft"]["resumed_rounds"] == 1
        assert res["ft"]["replicated"] == ranks[r - r % m]["ft"]["replicated"]
    whole = _flat(cfg, one["params0"], False)
    shapes = ranks[0]["ft"]["checkpoint_shapes"]
    assert shapes == {path: leaf.shape for path, leaf in whole.items()}
    # phase 1 before it: the proxy's bf16 features round apart where the
    # sharded layers sum partial products; A and b within one bf16 ulp of
    # their largest entry
    for k in ("A", "b"):
        want_k = getattr(refs["one phase 1"], k).numpy()
        gap = float(np.abs(ranks[0]["ft"]["stats"][k] - want_k).max())
        assert gap <= 2.0 ** -8 * float(np.abs(want_k).max()), (k, gap)


def test_what_stays_refused_raises(worlds):
    """Scaffold's rounds under psum (its cvar scatter needs the whole
    cohort, as in the reference) stay refused; a cross-attention (k, v)
    that the rules split over the frames, refused until the sharded
    cross-attention learned it, runs and matches the reference."""
    ranks, _, _ = worlds
    kind, msg = ranks[0]["refusals"]["scaffold under psum"]
    assert kind == "ValueError" and "scaffold" in msg
    check_cross_split(ranks[0]["refusals"]["cross-attention split"], 2,
                      cross_split_reference())
