"""The layouts the sharded layers once refused, under a "model" axis, against
the reference's unsharded model, on 4 gloo ranks on the CPU.

The reference runs every layout its sharding rules pick, since GSPMD
reshards what the rules leave.  The port's layers now do too:

* **a Mamba2 mixer whose heads do not divide** the axis: the rules leave
  ``A_log``, ``dt_bias``, ``D`` and the state unsplit, and every rank runs
  the SSD on every head.  ``mamba2-1.3b-smoke`` with d_model 96 and head
  width 64 has 3 heads.  Its ``norm_scale`` and ``out_proj`` still split
  over d_inner 192, so a rank scales its block of the whole width's norm,
  and the SSD's backward takes the whole cotangent of its output.
  A variant of d_model 99 (d_inner 198) at "model" 4 splits neither and
  computes them whole;
* **q heads a rank that the kv group does not divide**:
  ``qwen2-7b-smoke`` with 12 q and 3 kv heads gives 6 q heads a rank in
  groups of 4 at "model" 2, and 3 at "model" 4.  A rank's q heads read
  their kv heads in runs of uniform group size
  (``attention.kv_runs``), in the prefill, in the train forward and in
  decode over a replicated ring (19 slots), its int8 twin and a
  sequence-sharded ring (20 slots);
* **a cross-attention (k, v) split over the encoder's frames**:
  ``whisper-large-v3-smoke`` with 3 kv heads (its 32 frames split, its
  heads do not).  Each rank holds its block of the frames and attends it
  with every q head, then the ranks' softmax pieces combine.  A variant
  with 6 q heads splits q over the ranks too.

One module-scoped 4-rank world (``dist_check.fsdp_program``) runs every
job at (data 1, model 4) and (data 2, model 2), in fp32, from the
reference's weights, while the references compute in the test's thread:

* the train forward's logits and features, a prefill and teacher-forced
  decode steps, within 1e-5 of max|x| (``REL``);
* every cache leaf shaped as ``cache_specs``' block of the reference's
  ``make_cache``;
* ``lm_loss``'s gradient through the block recompute, the loss seeded
  once, gathered over "model", leaf by leaf against ``jax.grad``
  (``LEAF_RELS``), and where no fp32 gradient can meet that, Mamba2's
  cancelling ``A_log`` and ``dt_bias`` at whole width, against a float64
  oracle (``ORACLE_HELD``);
* at (2, 2) with FSDP, each layout widened to d_model 1024 (FSDP splits
  no dim under 1024): ``make_train_step`` against the reference's step,
  and the FSDP gradient against the port's unsharded one.

The combine stays exact for a rank whose keys all score 1e4 under the
others'.  The MoE capacity groups are always whole data ranks; a
hypothesis test sweeps the mesh to show it.
"""
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dist_check  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models import attention, build_model, moe, ssm  # noqa: E402
from repro_torch.models.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.sharding import hints  # noqa: E402
from repro_torch.sharding.shard import full_params, seeded_factory  # noqa: E402
from repro_torch.sharding.specs import cache_specs, map_with_path  # noqa: E402
from torch_families import (  # noqa: E402
    by_microbatch, float64_oracles, jax_params, start_float64_oracles)

WORLD = 4
MESHES = [(1, 4), (2, 2)]
REL = 1e-5  # of max|x|: summation order only
# the int8 ring's decode, as tests/test_torch_tp_families.py holds it: a
# key within an fp32 ulp of an int8 rounding edge lands one level over
INT8_DECODE_REL = 1e-3
# (pattern, the max|g| a limit scales, the limit) of the gradient leaves
# held apart, each as tests/test_torch_tp_train.py and
# tests/test_torch_fsdp_families.py hold it:
# * an attention key bias: zero in exact arithmetic, so what is there is
#   rounding; REL of the whole tree's largest |g|;
# * Whisper's decoder cross-attention q and k and the norm before them:
#   each package's fp32 gradient lies up to 6.9e-5 of its own max|g| from
#   a float64 oracle (the softmax's centring cancels the rest; see
#   tests/test_torch_audio_oracle.py), so the two
#   differ by more than REL; 1e-4 of their own max|g|.
LEAF_RELS = ((r"/bk$", "tree", REL),
             (r"dec_layers/\d+/(cross_attn/(wq|wk|bq)|norm2/(scale|bias))$", "leaf", 1e-4))
# Mamba2's A_log and dt_bias in "mamba2 whole width": each head's gradient
# sums the Δ-gradient of every position, which cancels, so fp32 rounding
# sets a share of what is left that no fp32 gradient meets REL of: against
# a float64 oracle the reference's own jitted gradient reads 1.56e-5 and
# 2.16e-4 of layers 0 and 1's A_log max|g| (the port unsharded 2.40e-5 and
# 1.33e-4, sharded at (1, 4) 3.71e-5 and 2.99e-4).  These leaves are held
# against the oracle instead: within ORACLE_FACTOR times the reference's
# own distance from it, or REL of their max|g| (read: at most 2.4 times)
ORACLE_HELD = {"mamba2 whole width": r"ssm/(A_log|dt_bias)$"}
ORACLE_FACTOR = 4
# the same leaves of FSDP's "mamba2 3 heads" (width 1024; its data halves
# summed) against the port's unsharded gradient: within ORACLE_FACTOR times
# that gradient's own distance from a float64 oracle, or REL of max|g|
FSDP_ORACLE_HELD = {"mamba2 3 heads": r"ssm/(A_log|dt_bias)$"}
FT_BF16_REL = 4 * 2.0 ** -8  # the bf16 step's dtheta (tests/test_torch_tp_train.py)

SSM3 = {"d_model": 96, "ssm_headdim": 64}  # 3 heads, d_inner 192
SSM_WHOLE = {"d_model": 99, "ssm_headdim": 66}  # 3 heads, d_inner 198
DENSE = {"n_heads": 12, "n_kv_heads": 3}
WHISPER = {"n_heads": 3, "n_kv_heads": 3}
# label -> (arch, replacements, B, forward S, prefill S0, decode T, meshes)
LAYOUTS = {
    "mamba2 3 heads": ("mamba2-1.3b-smoke", SSM3, 4, 32, 32, 3, MESHES),
    "mamba2 whole width": ("mamba2-1.3b-smoke", SSM_WHOLE, 4, 32, 32, 3, [(1, 4)]),
    "dense 12/3": ("qwen2-7b-smoke", DENSE, 4, 20, 15, 4, MESHES),
    "dense 12/3 int8": ("qwen2-7b-smoke", dict(DENSE, kv_cache_quant=True), 4, 20, 15, 4,
                        [(2, 2)]),
    "dense 12/3 ring over the sequence": ("qwen2-7b-smoke", DENSE, 4, 20, 16, 4, [(2, 2)]),
    "whisper 3 heads": ("whisper-large-v3-smoke", WHISPER, 4, 12, 8, 4, MESHES),
    "whisper 6/3": ("whisper-large-v3-smoke", {"n_heads": 6, "n_kv_heads": 3}, 4, 12, 8, 4,
                    [(2, 2)]),
}
# label -> (arch, replacements, B, S, meshes): lm_loss's gradient
GRADS = {
    "mamba2 3 heads": ("mamba2-1.3b-smoke", SSM3, 2, 32, MESHES),
    "mamba2 whole width": ("mamba2-1.3b-smoke", SSM_WHOLE, 2, 32, [(1, 4)]),
    "dense 12/3": ("qwen2-7b-smoke", DENSE, 2, 8, MESHES),
    "whisper 3 heads": ("whisper-large-v3-smoke", WHISPER, 2, 8, MESHES),
    "whisper 6/3": ("whisper-large-v3-smoke", {"n_heads": 6, "n_kv_heads": 3}, 2, 8,
                    [(2, 2)]),
}
# label -> (arch, replacements): each layout widened to d_model 1024, FSDP
# at (2, 2); Mamba2's 3 heads of width 1024 (d_inner 3072)
WIDE = {"d_model": 1024, "dtype": "float32"}
FSDP = {
    "mamba2 3 heads": ("mamba2-1.3b-smoke", dict(WIDE, ssm_expand=3, ssm_headdim=1024)),
    "dense 12/3": ("qwen2-7b-smoke", dict(WIDE, **DENSE, d_ff=2048)),
    "whisper 3 heads": ("whisper-large-v3-smoke", dict(WIDE, **WHISPER, d_ff=2048,
                                                       n_positions=64)),
}
STEP = dict(lr=0.1, num_microbatches=2, B=4, S=16)


def _name(label, mesh):
    return f"{label}@{mesh[0]}x{mesh[1]}"


def _inputs(cfg, B, rng):
    if cfg.arch_type == "audio":
        return {"audio_frames": (0.1 * rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
                                 ).astype(np.float32)}
    return {}


def _reference(jcfg, jparams, toks, extra, S, S0, T):
    """The reference's forward logits and features, its prefill of S0
    tokens and T decode steps teacher-forced, and its ``make_cache``."""
    cap = S0 + T
    ex = {k: jnp.asarray(v) for k, v in extra.items()}

    def run(p, fw_toks, pre_toks):
        fb, pb = dict(ex, tokens=fw_toks), dict(ex, tokens=pre_toks)
        lg, cache = jmodel.prefill(jcfg, p, pb, cap)
        return jmodel.forward(jcfg, p, fb).logits, jmodel.extract_features(jcfg, p, fb), lg, cache

    logits, feats, lg, cache = jax.jit(run)(jparams, jnp.asarray(toks[:, :S]),
                                            jnp.asarray(toks[:, :S0]))
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(jcfg, p, c, t, pos))
    dec = []
    for t in range(T):
        out, cache = step(jparams, cache, jnp.asarray(toks[:, S0 + t:S0 + t + 1]),
                          jnp.int32(S0 + t))
        dec.append(np.asarray(out))
    return {"logits": np.asarray(logits), "features": np.asarray(feats),
            "prefill": np.asarray(lg), "decode": np.stack(dec),
            "cache": jax.tree.map(np.asarray, jmodel.make_cache(jcfg, toks.shape[0], cap))}


def _jobs_and_references():
    """(the world's jobs, the reference computations to run meanwhile, the
    float64 oracles' inputs by label: (arch, replacements, params, batch))."""
    rng = np.random.default_rng(0)
    jobs, todo, oracles = [], [], {}
    for label, (arch, over, B, S, S0, T, meshes) in LAYOUTS.items():
        jcfg = jget_config(arch).replace(dtype="float32", **over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        toks = rng.integers(0, jcfg.vocab_size, (B, max(S, S0 + T))).astype(np.int32)
        extra = _inputs(jcfg, B, rng)
        params_np = jax.tree.map(np.asarray, jparams)
        for mesh in meshes:
            jobs.append(dict(name=_name(label, mesh), job="tp", arch=arch, data=mesh[0],
                             model=mesh[1], overrides={"dtype": "float32", **over},
                             params=params_np, tokens=toks[:, :S], prompts=toks[:, :S0],
                             decode=toks[:, S0:S0 + T], inputs=extra))
        todo.append((label, lambda a=(jcfg, jparams, toks, extra, S, S0, T): _reference(*a)))
    for label, (arch, over, B, S, meshes) in GRADS.items():
        jcfg = jget_config(arch).replace(dtype="float32", **over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
        batch = dist_check.grad_batch(jcfg, 2, B, S)
        for mesh in meshes:
            jobs.append(dict(name="grad " + _name(label, mesh), job="grad", arch=arch,
                             data=mesh[0], model=mesh[1], overrides={"dtype": "float32", **over},
                             params=jax.tree.map(np.asarray, jparams), batch=batch))
        if label in ORACLE_HELD:
            oracles[label] = (arch, over, jax.tree.map(np.asarray, jparams), batch)

        def grad(a=(jcfg, jparams, batch)):
            jb = {k: jnp.asarray(v) for k, v in a[2].items()}
            return jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p: jmodel.lm_loss(a[0], p, jb)))(a[1]))
        todo.append(("grad " + label, grad))
    for label, (arch, over) in FSDP.items():
        cfg = get_config(arch).replace(**over)
        fbatch = dist_check.grad_batch(cfg, 21, 4, 8)
        jobs.append(dict(name="fsdp grad " + label, job="grad", arch=arch, data=2, model=2,
                         overrides=over, seed=0, batch=fbatch, reference=True, fsdp=True))
        if label in FSDP_ORACLE_HELD:  # the unsharded gradient rank 0 takes, and its oracle
            params = full_params(cfg, seeded_factory(0), "cpu")
            oracles["fsdp " + label] = (arch, over, jax.tree.map(np.asarray, jax_params(params)),
                                        fbatch)

            def unsharded(a=(cfg, params, fbatch)):
                tb = {k: torch.as_tensor(v) for k, v in a[2].items()}
                return torch.func.grad(lambda p: build_model(a[0]).loss(p, tb))(a[1])
            todo.append(("fsdp unsharded " + label, unsharded))
        jcfg = jget_config(arch).replace(**over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(5))
        batch = dist_check.grad_batch(jcfg, 6, STEP["B"], STEP["S"])
        jobs.append(dict(name="fsdp step " + label, job="step", arch=arch, model=2,
                         overrides=over, params=jax.tree.map(np.asarray, jparams),
                         batch=by_microbatch(batch, 2, STEP["num_microbatches"]),
                         lr=STEP["lr"], num_microbatches=STEP["num_microbatches"], fsdp=True))

        def step(a=(jcfg, jparams, batch)):
            new, loss = jsteps.make_train_step(a[0], lr=STEP["lr"],
                                               num_microbatches=STEP["num_microbatches"])(
                a[1], {k: jnp.asarray(v) for k, v in a[2].items()})
            return jax.tree.map(np.asarray, a[1]), jax.tree.map(np.asarray, new), float(loss)
        todo.append(("fsdp step " + label, step))
    for model in (2, 4):
        jobs.append(dict(name=f"combine at model {model}", job="combine", model=model, seed=model))
    return jobs, todo, oracles


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's results, the references by label: "oracle <label>" the
    float64 oracles' {"port", "reference"})."""
    jobs, todo, oracle_in = _jobs_and_references()
    root = str(tmp_path_factory.mktemp("oracle"))
    sub = start_float64_oracles(root, oracle_in)
    box = {}

    def run():
        try:
            box["ranks"] = run_world(dist_check.fsdp_program, WORLD, backend="gloo",
                                     device="cpu", timeout_s=600, args=(jobs,))
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    runner = threading.Thread(target=run)
    runner.start()
    try:
        refs = {label: fn() for label, fn in todo}
    finally:
        runner.join()
        oracles = float64_oracles(sub, root)
    refs.update({"oracle " + label: o for label, o in oracles.items()})
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs


def _cfg(arch, over):
    return get_config(arch).replace(dtype="float32", **over)


def _rows(ranks, name, key, model):
    """The data groups' rows of ``key`` in data order (model rank 0 of each)."""
    return np.concatenate([ranks[r][name][key] for r in range(0, WORLD, model)],
                          axis=1 if key == "decode" else 0)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _flat(cfg, tree, from_jax):
    if from_jax:
        tree = params_from_jax(cfg, tree, device="cpu")
    out = {}
    map_with_path(tree, lambda path, x: out.__setitem__("/".join(path), np.asarray(x)))
    return out


def _limit(path, leaf_max, tree_max):
    for pattern, scale, rel in LEAF_RELS:
        if re.search(pattern, path):
            return rel * (tree_max if scale == "tree" else leaf_max)
    return REL * leaf_max


ALL = [(label, mesh) for label, (*_, meshes) in LAYOUTS.items() for mesh in meshes]
IDS = [_name(label, mesh) for label, mesh in ALL]
GRAD_CASES = [(label, mesh) for label, (*_, meshes) in GRADS.items() for mesh in meshes]


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_the_rules_pick_the_layout(label, mesh):
    """Each case runs the layout it is named for: the rules (no process
    group: the ambient mesh's sizes and the rank's coordinates) leave the
    SSD heads unsplit, give a rank q heads in several runs, or split the
    cross-attention's frames."""
    arch, over, B = LAYOUTS[label][:3]
    cfg = _cfg(arch, over)
    sizes = {"data": mesh[0], "model": mesh[1]}
    seen = []
    for r in range(mesh[1]):
        hints._AMBIENT[:] = [(None, sizes, {"data": 0, "model": r}, ())]
        try:
            if cfg.arch_type == "ssm":
                mx = ssm._Mixer(cfg)
                seen.append((mx.heads, mx.inner))
            else:
                tp = attention.tp_layout(cfg)
                seen.append((tp.q, len(tp.kv_runs) if tp.kv_runs else 0))
                if cfg.arch_type == "audio":
                    frames, kv = attention.cache_block(cfg, B // mesh[0], cfg.n_audio_frames)
                    assert (frames, kv) == (cfg.n_audio_frames // mesh[1], cfg.n_kv_heads)
        finally:
            hints._AMBIENT[:] = []
    if cfg.arch_type == "ssm":
        assert all(h is None and inner == (label == "mamba2 3 heads") for h, inner in seen)
    elif cfg.n_heads % mesh[1]:  # q row-parallel: every rank computes every head
        assert all(q == "rows" for q, _ in seen), seen
    else:  # a kv head shared by two ranks starts a second run on each
        assert all(q == "heads" for q, _ in seen) and max(n for _, n in seen) == 2, seen


@pytest.mark.parametrize("H,KV,m", [(12, 3, 2), (12, 3, 4), (6, 3, 2), (28, 4, 4), (20, 5, 4),
                                    (8, 2, 4), (16, 2, 4), (10, 2, 4), (15, 5, 3), (18, 3, 9)])
def test_kv_runs_read_each_q_heads_own_kv_head(H, KV, m):
    """``attention.kv_runs``: every rank's q heads, in order, each reading
    kv head h // G, in runs whose kv heads each serve one number of q
    heads; one run where the rank's q heads and the group divide one
    another."""
    G, Hl = H // KV, H // m
    for r in range(m):
        runs = attention.kv_runs(H, KV, m, r)
        q_next, reads = 0, []
        for qs, ks in runs:
            n, kv = qs.stop - qs.start, ks.stop - ks.start
            assert qs.start == q_next and n % kv == 0
            reads += [ks.start + i // (n // kv) for i in range(n)]
            q_next = qs.stop
        assert q_next == Hl
        assert reads == [(r * Hl + i) // G for i in range(Hl)]
        if Hl % G == 0 or G % Hl == 0:
            assert len(runs) == 1


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_forward_and_features_match_the_reference(world, label, mesh):
    ranks, refs = world
    name = _name(label, mesh)
    _close(_rows(ranks, name, "logits", mesh[1]), refs[label]["logits"])
    _close(_rows(ranks, name, "features", mesh[1]), refs[label]["features"])


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_prefill_and_decode_match_the_reference(world, label, mesh):
    ranks, refs = world
    name = _name(label, mesh)
    _close(_rows(ranks, name, "prefill", mesh[1]), refs[label]["prefill"])
    rel = INT8_DECODE_REL if "int8" in label else REL
    _close(_rows(ranks, name, "decode", mesh[1]), refs[label]["decode"], rel)


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_cache_leaves_are_the_specs_blocks(world, label, mesh):
    """Each cache leaf a rank holds has the shape of its block, by
    ``cache_specs``, of the reference's ``make_cache`` leaf; Whisper's
    cross (k, v) hold the rank's frames."""
    ranks, refs = world
    arch, over = LAYOUTS[label][:2]
    cfg = _cfg(arch, over)
    sizes = {"data": mesh[0], "model": mesh[1]}
    ref = cache_from_jax(cfg, refs[label]["cache"], device="cpu")
    specs = cache_specs(cfg, ref, ("data",), sizes)
    want, spec_of = {}, {}
    map_with_path(ref, lambda path, leaf: want.__setitem__("/".join(path), leaf.shape))
    map_with_path(specs, lambda path, spec: spec_of.__setitem__("/".join(path), spec))
    for r in range(WORLD):
        got = ranks[r][_name(label, mesh)]["cache_shapes"]
        coords = {"data": r // mesh[1], "model": r % mesh[1]}
        assert set(got) == set(want)
        for path, shape in want.items():
            block = spec_of[path].index(shape, coords, sizes)
            assert got[path] == tuple(len(range(*s.indices(n))) for s, n in zip(block, shape)), \
                (path, got[path], shape)
        if cfg.arch_type == "audio":
            assert got["0/cross/0"][1] == cfg.n_audio_frames // mesh[1]


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_model_ranks_of_a_data_group_agree_bitwise(world, label, mesh):
    ranks, _ = world
    name = _name(label, mesh)
    for r in range(WORLD):
        assert ranks[r][name]["coords"] == {"data": r // mesh[1], "model": r % mesh[1]}
        assert ranks[r][name]["digest"] == ranks[r - r % mesh[1]][name]["digest"]


@pytest.mark.parametrize("label,mesh", GRAD_CASES, ids=[_name(*c) for c in GRAD_CASES])
def test_sharded_gradient_matches_the_reference(world, label, mesh):
    """lm_loss's gradient through the block recompute, gathered over
    "model", leaf by leaf against jax.grad of the reference on the whole
    batch (LEAF_RELS); the same bits on every rank."""
    ranks, refs = world
    arch, over = GRADS[label][:2]
    cfg = _cfg(arch, over)
    name = "grad " + _name(label, mesh)
    got = _flat(cfg, ranks[0][name]["sound"]["grads"], False)
    want = _flat(cfg, refs["grad " + label], True)
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        if label in ORACLE_HELD and re.search(ORACLE_HELD[label], path):
            continue  # test_cancelling_leaves_against_a_float64_oracle
        err = float(np.abs(got[path] - w).max())
        assert err <= _limit(path, float(np.abs(w).max()), top), (path, err)
    for r in range(WORLD):
        assert ranks[r][name]["sound"]["digest"] == ranks[0][name]["sound"]["digest"]


ORACLE_CASES = [(label, mesh) for label, mesh in GRAD_CASES if label in ORACLE_HELD]


@pytest.mark.parametrize("label,mesh", ORACLE_CASES, ids=[_name(*c) for c in ORACLE_CASES])
def test_cancelling_leaves_against_a_float64_oracle(world, label, mesh):
    """ORACLE_HELD's leaves of the sharded gradient against the float64
    oracle of the reference (which the port's own float64 gradient meets
    within 1e-9 of each leaf's max|g|): within ORACLE_FACTOR times the
    reference's fp32 distance from it, or REL of the leaf's max|g|."""
    ranks, refs = world
    arch, over = GRADS[label][:2]
    cfg = _cfg(arch, over)
    oracle = refs["oracle " + label]
    got = _flat(cfg, ranks[0]["grad " + _name(label, mesh)]["sound"]["grads"], False)
    ref32 = _flat(cfg, refs["grad " + label], True)
    held = [p for p in oracle["reference"] if re.search(ORACLE_HELD[label], p)]
    assert len(held) == 2 * cfg.n_layers
    for path in held:
        exact = oracle["reference"][path]
        scale = float(np.abs(exact).max())
        assert float(np.abs(oracle["port"][path] - exact).max()) <= 1e-9 * scale, path
        ref_err = float(np.abs(ref32[path] - exact).max())
        err = float(np.abs(got[path] - exact).max())
        print(f"{path}: sharded {err / scale:.3e}, the reference's fp32 {ref_err / scale:.3e} "
              f"of max|g| from float64")
        assert err <= max(ORACLE_FACTOR * ref_err, REL * scale), (path, err, ref_err, scale)


@pytest.mark.parametrize("label", list(FSDP))
def test_fsdp_gradient_matches_the_unsharded_one(world, label):
    """The FSDP gradient at (2, 2), each leaf within its limit of the port's
    unsharded gradient on rank 0 (FSDP_ORACLE_HELD's leaves by a float64
    oracle)."""
    ranks, refs = world
    gaps = ranks[0]["fsdp grad " + label]["sound"]["gaps"]
    top = max(scale for _, scale in gaps.values())
    held = FSDP_ORACLE_HELD.get(label)
    if held is not None:
        cfg = get_config(FSDP[label][0]).replace(**FSDP[label][1])
        unsharded = _flat(cfg, refs["fsdp unsharded " + label], False)
        oracle = refs["oracle fsdp " + label]
    for path, (err, scale) in gaps.items():
        if held is not None and re.search(held, path):
            exact = oracle["reference"][path]
            assert float(np.abs(oracle["port"][path] - exact).max()) <= 1e-9 * scale, path
            own = float(np.abs(unsharded[path] - exact).max())
            print(f"fsdp {path}: from the unsharded {err / scale:.3e}, the unsharded from "
                  f"float64 {own / scale:.3e} of max|g|")
            assert err <= max(ORACLE_FACTOR * own, REL * scale), (path, err, own, scale)
            continue
        assert err <= _limit(path, scale, top), (path, err, scale)


@pytest.mark.parametrize("label", list(FSDP))
def test_fsdp_train_step_matches_the_reference(world, label):
    """make_train_step, 2 microbatches, FSDP at (2, 2): the new parameters
    gathered whole within a few bf16 ulps of max|dtheta| of the reference's
    step, the loss within 1e-5, on every rank."""
    ranks, refs = world
    cfg = get_config(FSDP[label][0]).replace(**FSDP[label][1])
    start, want, jloss = refs["fsdp step " + label]
    got = _flat(cfg, ranks[0]["fsdp step " + label]["params"], False)
    want, start = _flat(cfg, want, True), _flat(cfg, start, True)
    assert sorted(got) == sorted(want)
    err = max(float(np.abs((got[k] - start[k]) - (want[k] - start[k])).max()) for k in want)
    scale = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    assert 0 < err <= FT_BF16_REL * scale, (err, scale)
    for r in range(WORLD):
        assert ranks[r]["fsdp step " + label]["loss"] == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("model", [2, 4])
def test_combine_is_exact_when_a_rank_scores_far_below(world, model):
    """``_cp_combine`` with model rank 1's keys scored 1e4 under the
    others': its pieces weigh nothing (their scale underflows to 0), and
    the combine equals the whole softmax · v within fp32 rounding."""
    ranks, _ = world
    for r in range(WORLD):
        got = ranks[r][f"combine at model {model}"]
        assert got["finite"]
        np.testing.assert_allclose(got["got"], got["want"], rtol=1e-5, atol=1e-6)


@settings(max_examples=200, deadline=None)
@given(pod=st.sampled_from([1, 2, 3]), data=st.sampled_from([1, 2, 3, 4, 8, 16]),
       model=st.sampled_from([1, 2, 4, 16]), n_tokens=st.integers(0, 4096))
def test_moe_capacity_groups_are_whole_data_ranks(pod, data, model, n_tokens):
    """``moe.moe_groups`` on any mesh of "pod", "data" and "model" axes and
    a rank's token count: G is the "data" axis size, divides the data
    shards (pod · data) and the global count, and is the reference's G on
    that count (``src/repro/models/moe.py``: halved while it does not
    divide), so a capacity group is whole data ranks and the assertion
    that replaced the refusal cannot fire."""
    sizes = {"pod": pod, "data": data, "model": model}
    hints._AMBIENT[:] = [(None, sizes, {a: 0 for a in sizes}, ())]
    try:
        G, total = moe.moe_groups(n_tokens)
    finally:
        hints._AMBIENT[:] = []
    assert total == n_tokens * pod * data
    ref = max(data, 1)
    while total % ref:
        ref //= 2
    assert G == max(ref, 1) == data
    assert (pod * data) % G == 0 and total % G == 0
