"""The SSM, hybrid, VLM and audio families under a "model" axis against the
reference's unsharded models, on 4 gloo ranks on the CPU.

One module-scoped 4-rank world (:func:`repro_torch.launch.world.run_world`)
runs :func:`repro_torch.launch.dist_check.tp_program` on host meshes (data
1, model 4) and (data 2, model 2): ``qwen2-vl-2b-smoke``,
``recurrentgemma-9b-smoke``, ``whisper-large-v3-smoke`` and
``mamba2-1.3b-smoke`` in fp32, each rank holding its blocks of the
reference's weights (``params_from_jax`` then ``shard_params``) and its
rows of numpy inputs from a seed.  The train forward's logits and features,
a prefill and teacher-forced decode steps are held within 1e-5 of max|x|
(over the real vocab) against the reference's unsharded model on the whole
batch, while the references are computed in the test's thread.

The shapes put each new path under test at (1, 4):

* the VLM's ring of 16 patches + 6 + 2 = 24 slots (its 2 kv heads do not
  divide 4, the slots do): the sequence-sharded cache, 6 slots a rank;
* the hybrid's smoke window of 32 slots, 8 a rank: the prefill of 38
  wraps the ring, and the decode positions 38–41 (slots 6–9) cross from
  rank 0's block into rank 1's; its RG-LRU width-sharded;
* Whisper with its vocab replaced in both packages by 509 padded to 510,
  which 4 does not divide (the padded 512 would split the vocab): its
  embedding and tied head d_model-sharded, the padded column masked;
* Mamba2's in_proj, 552 columns that 4 does not divide, row-parallel at
  (1, 4) and column-parallel at (2, 2), its 8 SSD heads 2 a rank.

An untied dense smoke with the same vocab runs its ``lm_head`` d_model-
sharded (``("model", None)``); a VLM prefill of 1 token and 7 decode steps
leaves model rank 3's slots empty at the first step, which the
context-parallel combine must weigh as nothing; and the VLM's int8 ring
runs sequence-sharded.  Every cache leaf on every
rank has the shape of ``cache_specs``' block of the reference's
``make_cache``, and every model rank of a data group returns the same bits.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dist_check  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import cache_from_jax  # noqa: E402
from repro_torch.sharding.specs import cache_specs, map_with_path  # noqa: E402

WORLD = 4
MESHES = [(1, 4), (2, 2)]
REL = 1e-5  # of max|x|: summation order only
# the int8 ring's decode: a decode token's key is quantized from inputs the
# sharded layers summed in another order, so an entry within an fp32 ulp of
# an int8 rounding edge lands one level over (1/127 of its absmax).  Read
# 2.41e-4 of max|logit|: 3 entries of layer 1's key at the first decode
# step one level apart, where the prefill's ring was equal level by level
# (its scales within 5.2e-7).  The fp32 ring is held at REL.
INT8_DECODE_REL = 1e-3
D_MODEL_VOCAB = {"vocab_size": 509, "vocab_pad_to": 2}  # 510 rows: 4 does not divide
# arch: (config replacements, B, forward S, prefill S0, decode T)
FAMILIES = {
    "qwen2-vl-2b-smoke": ({}, 4, 8, 6, 2),
    "recurrentgemma-9b-smoke": ({}, 2, 42, 38, 4),
    "whisper-large-v3-smoke": (D_MODEL_VOCAB, 4, 12, 8, 4),
    "mamba2-1.3b-smoke": ({}, 4, 64, 64, 4),
}
# the further layouts at (1, 4): label -> (arch, replacements, B, S, S0, T)
VARIANTS = {
    "untied head over d_model": ("qwen2-7b-smoke", D_MODEL_VOCAB, 4, 20, 15, 4),
    "a rank with no slot filled": ("qwen2-vl-2b-smoke", {}, 4, 8, 1, 7),
    "int8 ring over the sequence": ("qwen2-vl-2b-smoke", {"kv_cache_quant": True}, 4, 8, 6, 2),
}


def _name(arch, mesh):
    return f"{arch}@{mesh[0]}x{mesh[1]}"


def _offset(cfg):
    return cfg.n_patches if cfg.arch_type == "vlm" else 0


def _inputs(cfg, B, rng):
    """A VLM's patch embeddings or an audio model's frames, 0.1·N(0, 1)."""
    if cfg.arch_type == "vlm":
        return {"patch_embeds": (0.1 * rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                                 ).astype(np.float32)}
    if cfg.arch_type == "audio":
        return {"audio_frames": (0.1 * rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
                                 ).astype(np.float32)}
    return {}


def _reference(cfg, jcfg, jparams, toks, extra, S, S0, T):
    """The reference's forward logits and features on ``toks[:, :S]``, its
    prefill of ``toks[:, :S0]`` and T decode steps teacher-forced on the
    next tokens, and its ``make_cache`` in the port's layout (``cfg``)."""
    off = _offset(jcfg)
    cap = off + S0 + T
    ex = {k: jnp.asarray(v) for k, v in extra.items()}

    def run(p, fw_toks, pre_toks):
        fb, pb = dict(ex, tokens=fw_toks), dict(ex, tokens=pre_toks)
        fw = jmodel.forward(jcfg, p, fb)
        lg, cache = jmodel.prefill(jcfg, p, pb, cap)
        return fw.logits, jmodel.extract_features(jcfg, p, fb), lg, cache

    logits, feats, lg, cache = jax.jit(run)(jparams, jnp.asarray(toks[:, :S]),
                                            jnp.asarray(toks[:, :S0]))
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(jcfg, p, c, t, pos))
    dec = []
    for t in range(T):
        out, cache = step(jparams, cache, jnp.asarray(toks[:, S0 + t:S0 + t + 1]),
                          jnp.int32(off + S0 + t))
        dec.append(np.asarray(out))
    empty = jax.tree.map(np.asarray, jmodel.make_cache(jcfg, toks.shape[0], cap))
    return {"logits": np.asarray(logits), "features": np.asarray(feats),
            "prefill": np.asarray(lg), "decode": np.stack(dec), "cfg": cfg,
            "cache": cache_from_jax(cfg, empty, device="cpu")}


def _cases():
    """(label, arch, replacements, B, S, S0, T, meshes)."""
    out = [(arch, arch, over, B, S, S0, T, MESHES) for arch, (over, B, S, S0, T)
           in FAMILIES.items()]
    return out + [(label, arch, over, B, S, S0, T, [(1, 4)]) for label, (arch, over, B, S, S0, T)
                  in VARIANTS.items()]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    jobs, todo = [], []
    for label, arch, over, B, S, S0, T, meshes in _cases():
        jcfg = jget_config(arch).replace(dtype="float32", **over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        toks = rng.integers(0, jcfg.vocab_size, (B, max(S, S0 + T))).astype(np.int32)
        extra = _inputs(jcfg, B, rng)
        params_np = jax.tree.map(np.asarray, jparams)
        for mesh in meshes:
            jobs.append(dict(name=_name(label, mesh), arch=arch, data=mesh[0], model=mesh[1],
                             overrides={"dtype": "float32", **over}, params=params_np,
                             tokens=toks[:, :S], prompts=toks[:, :S0],
                             decode=toks[:, S0:S0 + T], inputs=extra))
        cfg = get_config(arch).replace(dtype="float32", **over)
        todo.append((label, cfg, jcfg, jparams, toks, extra, S, S0, T))
    box = {}

    def run():
        try:
            box["ranks"] = run_world(dist_check.tp_program, WORLD, backend="gloo",
                                     device="cpu", timeout_s=240, args=(jobs,))
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    runner = threading.Thread(target=run)
    runner.start()
    try:
        refs = {label: _reference(*rest) for label, *rest in todo}
    finally:
        runner.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs


def _rows(ranks, name, key, model):
    """The data groups' rows of ``key`` in data order (model rank 0 of each)."""
    return np.concatenate([ranks[r][name][key] for r in range(0, WORLD, model)],
                          axis=1 if key == "decode" else 0)


def _close(got, want, vocab=None, rel=REL):
    """Within ``rel`` of max|want| over the real vocab (``vocab`` columns);
    the padded columns −1e30 in both."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    if vocab is not None and got.shape[-1] > vocab:
        assert (got[..., vocab:] == -1e30).all() and (want[..., vocab:] == -1e30).all()
        got, want = got[..., :vocab], want[..., :vocab]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _params(label, mesh):
    case = next(c for c in _cases() if c[0] == label)
    return _name(label, mesh), get_config(case[1]).replace(**case[2]).vocab_size


ALL = [(label, mesh) for label, *_, meshes in _cases() for mesh in meshes]
IDS = [_name(label, mesh) for label, mesh in ALL]


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_sharded_forward_and_features_match_the_reference(world, label, mesh):
    ranks, refs = world
    name, vocab = _params(label, mesh)
    _close(_rows(ranks, name, "logits", mesh[1]), refs[label]["logits"], vocab)
    _close(_rows(ranks, name, "features", mesh[1]), refs[label]["features"])


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_sharded_prefill_and_decode_match_the_reference(world, label, mesh):
    ranks, refs = world
    name, vocab = _params(label, mesh)
    _close(_rows(ranks, name, "prefill", mesh[1]), refs[label]["prefill"], vocab)
    rel = INT8_DECODE_REL if label == "int8 ring over the sequence" else REL
    _close(_rows(ranks, name, "decode", mesh[1]), refs[label]["decode"], vocab, rel)


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_model_ranks_of_a_data_group_agree_bitwise(world, label, mesh):
    ranks, _ = world
    name, _ = _params(label, mesh)
    for r in range(WORLD):
        assert ranks[r][name]["coords"] == {"data": r // mesh[1], "model": r % mesh[1]}
        assert ranks[r][name]["digest"] == ranks[r - r % mesh[1]][name]["digest"]


@pytest.mark.parametrize("label,mesh", ALL, ids=IDS)
def test_cache_leaves_are_the_specs_blocks(world, label, mesh):
    """Each cache leaf a rank holds has the shape of its block, by
    ``cache_specs``, of the reference's ``make_cache`` leaf."""
    ranks, refs = world
    name, _ = _params(label, mesh)
    sizes = {"data": mesh[0], "model": mesh[1]}
    ref = refs[label]["cache"]
    specs = cache_specs(refs[label]["cfg"], ref, ("data",), sizes)
    want = {}
    map_with_path(ref, lambda path, leaf: want.__setitem__("/".join(path), leaf.shape))
    spec_of = {}
    map_with_path(specs, lambda path, spec: spec_of.__setitem__("/".join(path), spec))
    for r in range(WORLD):
        got = ranks[r][name]["cache_shapes"]
        coords = {"data": r // mesh[1], "model": r % mesh[1]}
        assert set(got) == set(want)
        for path, shape in want.items():
            block = spec_of[path].index(shape, coords, sizes)
            assert got[path] == tuple(len(range(*s.indices(n))) for s, n in zip(block, shape)), \
                (path, got[path], shape)


# the layouts each case must have run in at (1, 4): (embedding, head, ring)
LAYOUTS_1X4 = {
    "qwen2-vl-2b-smoke": ("vocab", "vocab", "sequence"),
    "recurrentgemma-9b-smoke": ("vocab", "vocab", "sequence"),
    "whisper-large-v3-smoke": ("d_model", "d_model", "heads"),
    "mamba2-1.3b-smoke": ("vocab", "vocab", None),
    "untied head over d_model": ("d_model", "d_model", "replicated"),
    "a rank with no slot filled": ("vocab", "vocab", "sequence"),
    "int8 ring over the sequence": ("vocab", "vocab", "sequence"),
}


@pytest.mark.parametrize("label", list(LAYOUTS_1X4))
def test_the_new_layouts_ran_at_model_4(world, label):
    ranks, _ = world
    got = ranks[0][_name(label, (1, 4))]["layouts"]
    assert (got["embed"], got["head"], got["kv cache"]) == LAYOUTS_1X4[label]


def test_a_rank_with_no_slot_filled_holds_none_at_the_first_decode_step(world):
    """The empty-rank case as it ran: after the prefill, the last rank's
    block of the ring (its k's slots of ``pos``) holds no position, and the
    first decode step's token goes to an earlier rank's block."""
    ranks, _ = world
    got = ranks[3][_name("a rank with no slot filled", (1, 4))]
    n, pos = got["cache_shapes"]["0/k"][1], got["ring_pos"]
    assert 4 * n == pos.shape[0]
    assert (pos[3 * n:] == -1).all() and (pos[:3 * n] >= 0).any()
    assert (pos.max() + 1) % pos.shape[0] < 3 * n


@pytest.mark.parametrize("first,n,cap,lo,hi", [
    (0, 5, 8, 0, 8), (0, 5, 8, 4, 8), (6, 8, 8, 0, 4), (6, 8, 8, 4, 8), (38, 4, 32, 0, 8),
    (38, 4, 32, 8, 16), (6, 32, 32, 24, 32), (13, 3, 8, 2, 4)])
def test_ring_runs_cover_the_rank_slots_once(first, n, cap, lo, hi):
    """``attention._ring_runs``: the runs inside [lo, hi) are exactly the
    slots p % cap of positions first .. first + n − 1 there, each with its
    position."""
    want = {p % cap: p for p in range(first, first + n) if lo <= p % cap < hi}
    got = {}
    for j0, j1, p0 in attention._ring_runs(first, n, cap, lo, hi):
        for j in range(j0, j1):
            assert j not in got
            got[j] = p0 + j - j0
    assert got == want
