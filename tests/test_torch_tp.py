"""Tensor and expert parallelism against the reference's unsharded models, on
4 gloo ranks on the CPU; and the windowed attention's chunk starts.

One module-scoped 4-rank world (:func:`repro_torch.launch.world.run_world`)
runs :func:`repro_torch.launch.dist_check.tp_program`: ``qwen2-7b-smoke``,
``command-r-plus-104b-smoke`` (the parallel block),
``llama4-scout-17b-a16e-smoke`` and ``deepseek-moe-16b-smoke`` in fp32 on
host meshes (data 1, model 4) and (data 2, model 2), each rank holding its
blocks of the reference's weights (``params_from_jax`` then
``shard_params``) and its rows of numpy inputs from a seed.  The train
forward's logits, the FED3R features, a prefill and teacher-forced decode
steps are held within 1e-5 of max|x| against the reference's unsharded
model on the whole batch; at (2, 2) the MoE's capacity is group-local
with G = 2, and the reference runs with ``repro.models.moe.mesh_axis_size``
patched here to return 2 for ``"data"`` (nothing in the reference
changes).  At (1, 4) the 2-kv-head models' caches of 19 slots are
replicated (kv heads and slots both indivisible); the layouts where a
projection or an expert stack falls back from its head or expert axis run
at head and expert counts that do not divide 4.  Every model rank of a data
group returns the same bits.  ``launch/serve.py``'s ``serve`` runs two
layouts that earlier slices refused, each held against the reference on
the tokens it served: qwen2-7b-smoke at (1, 4) with a ring of 8 slots (2
kv heads: the sequence-sharded cache, 2 slots a rank, two ranks holding
no position yet at the first decode step) and mamba2-1.3b-smoke at
(2, 2).  The world also runs what stays refused and ``train.run``'s
phase 1.  A second world runs
:func:`repro_torch.launch.dist_check.tp_train_program` on what earlier
slices refused under "model" 2 and now runs: the hybrid's and Whisper's
backward, against ``jax.grad`` of the reference, and ``train.run``'s
phase 2, against the one-process driver.
The SSM, hybrid, VLM and audio families are held in
``tests/test_torch_tp_families.py``, the backward in
``tests/test_torch_tp_train.py``.
"""
import contextlib
import functools
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dist_check, train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sharding import hints  # noqa: E402
from repro_torch.sharding.specs import map_with_path  # noqa: E402
from repro_torch.sharding.shard import (  # noqa: E402
    full_params,
    seeded_factory,
    shard_params,
    shard_params_from,
)
from torch_families import check_cross_split, cross_split_reference  # noqa: E402

WORLD = 4
ARCHS = ["qwen2-7b-smoke", "command-r-plus-104b-smoke", "llama4-scout-17b-a16e-smoke",
         "deepseek-moe-16b-smoke"]
MOE = ("llama4-scout-17b-a16e-smoke", "deepseek-moe-16b-smoke")
MESHES = [(1, 4), (2, 2)]
REL = 1e-5  # of max|x|: summation order only (measured ≤ 1e-6)
B, S = 4, 20  # the train forward's tokens
# a prefill of 15 and 4 decode steps: 19 slots, so at (1, 4) the 2-kv-head
# models' caches are replicated (kv heads and slots both indivisible)
S0, T = 15, 4
# layouts where a projection or the expert stack falls back at model 4
VARIANTS = {"q rows, wo cols": ("qwen2-7b-smoke", {"n_heads": 6}),
            "experts split on their hidden axis": ("llama4-scout-17b-a16e-smoke",
                                                   {"n_experts": 6})}
# serve at (label: arch, mesh, prompt length, gen): a prompt of 3 and 5
# tokens make qwen2's ring 8 slots, which 4 divides and its 2 kv heads do
# not; mamba2's SSD takes its prompt of 8 as one chunk
SERVED = {"sequence cache": ("qwen2-7b-smoke", (1, 4), 3, 5),
          "ssm": ("mamba2-1.3b-smoke", (2, 2), 8, 3)}
# the backward that earlier slices refused under "model" 2
BACKWARD = {"hybrid backward": "recurrentgemma-9b-smoke",
            "audio backward": "whisper-large-v3-smoke"}


def _name(arch, mesh):
    return f"{arch}@{mesh[0]}x{mesh[1]}"


@contextlib.contextmanager
def _groups(g):
    """The reference's MoE capacity groups at G = g (its "data" axis)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "mesh_axis_size", lambda name: g if name == "data" else 1)
        yield


def _drops_of(jcfg, router, x, G):
    """(dropped, routed) of one reference MoE layer's input at G groups, by
    its own formulas (moe.py:73-95)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xf @ router.astype(x.dtype)).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    Cg = max(8, -(-jmoe._capacity(jcfg, xf.shape[0]) // G))
    onehot = jax.nn.one_hot(idx.reshape(G, -1), jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return jnp.sum(pos >= Cg), pos.size


def _reference(jcfg, jparams, toks, G, serving=True):
    """The reference's forward logits, features and load-balance loss on
    ``toks``; with ``serving``, its prefill of ``toks[:, :S0]`` and
    teacher-forced decode of the next T, with the prefill's drops counted
    on each MoE layer's input; at G MoE capacity groups.  One jitted
    function for all but the decode steps (one compile)."""
    real = jtfm.moe_mod.moe_apply

    def run(p, tb, pb):
        fw = jmodel.forward(jcfg, p, tb)
        out = [fw.logits, fw.aux_loss, jmodel.extract_features(jcfg, p, tb)]
        if pb is None:
            return out
        seen = []

        def recording(c, pm, x):
            seen.append(_drops_of(c, pm["router"], x, G))
            return real(c, pm, x)

        jtfm.moe_mod.moe_apply = recording
        try:
            lg, cache = jmodel.prefill(jcfg, p, pb, S0 + T)
        finally:
            jtfm.moe_mod.moe_apply = real
        return out + [lg, cache, [d for d, _ in seen], sum(n for _, n in seen)]

    with _groups(G):
        pb = {"tokens": jnp.asarray(toks[:, :S0])} if serving else None
        res = jax.jit(run)(jparams, {"tokens": jnp.asarray(toks)}, pb)
        out = {"logits": np.asarray(res[0]), "aux": float(res[1]),
               "features": np.asarray(res[2])}
        if not serving:
            return out
        cache = res[4]
        out.update(prefill=np.asarray(res[3]), decode=[],
                   drops=(sum(int(d) for d in res[5]), int(res[6])))
        step = jax.jit(functools.partial(jmodel.decode_step, jcfg))
        for i in range(S0, S0 + T):
            lg, cache = step(jparams, cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            out["decode"].append(np.asarray(lg))
    return out


def _ref_inits(archs):
    """The reference's init of each arch's fp32 config, from PRNGKey(0), in
    one jitted call (one compile for all)."""
    cfgs = [jget_config(a).replace(dtype="float32", scan_layers=False) for a in archs]
    params = jax.jit(lambda key: [jbuild_model(c).init(key) for c in cfgs])(
        jax.random.PRNGKey(0))
    return dict(zip(archs, zip(cfgs, params)))


def _ref_params(arch, overrides):
    """The reference's fp32 config with ``overrides`` (the fallback
    layouts' head and expert counts), and the port's init of seed 0 stacked
    into the reference's layout, which costs no compile."""
    jcfg = jget_config(arch).replace(dtype="float32", scan_layers=False, **overrides)
    port = build_model(get_config(arch).replace(dtype="float32", **overrides)).init(0, "cpu")
    layers = port.pop("layers")
    tree = {k: jax.tree.map(lambda t: jnp.asarray(t.numpy()), v) for k, v in port.items()}
    tree["layers"] = jax.tree.map(lambda *ts: jnp.asarray(np.stack([t.numpy() for t in ts])),
                                  *layers)
    return jcfg, tree


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    toks = {arch: rng.integers(0, 512, (B, S)).astype(np.int32) for arch in ARCHS}
    jobs, refs_todo = [], []
    inits = _ref_inits(ARCHS + [a for a, _, _, _ in SERVED.values() if a not in ARCHS])
    for arch in ARCHS:
        jcfg, jparams = inits[arch]
        params_np = jax.tree.map(np.asarray, jparams)
        x = toks[arch][:, :S0 + T]
        for mesh in MESHES:
            jobs.append(dict(name=_name(arch, mesh), arch=arch, data=mesh[0], model=mesh[1],
                             overrides={"dtype": "float32"}, params=params_np,
                             tokens=toks[arch], prompts=x[:, :S0], decode=x[:, S0:]))
            # G = the data axis; a dense model's reference does not depend on it
            if arch in MOE or mesh == MESHES[0]:
                refs_todo.append((_name(arch, mesh), arch, jcfg, jparams, mesh[0]))
    for label, (arch, over) in VARIANTS.items():
        jcfg, jparams = _ref_params(arch, over)
        jobs.append(dict(name=label, arch=arch, data=1, model=4,
                         overrides={"dtype": "float32", **over},
                         params=jax.tree.map(np.asarray, jparams), tokens=toks[arch]))
        refs_todo.append((label, arch, jcfg, jparams, 1))
    for label, (arch, mesh, s0, gen) in SERVED.items():
        jcfg, jparams = inits[arch]
        jobs.append(dict(name=label, arch=arch, data=mesh[0], model=mesh[1],
                         overrides={"dtype": "float32"}, params=jax.tree.map(np.asarray, jparams),
                         prompts=toks[ARCHS[0]][:, :s0], serve={"gen": gen}))
    # the ranks run while the references are computed here
    box = {}

    def run():
        try:
            box["ranks"] = run_world(dist_check.tp_program, WORLD, backend="gloo",
                                     device="cpu", timeout_s=240, args=(jobs, True, 2))
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    runner = threading.Thread(target=run)
    runner.start()
    try:
        refs = {name: _reference(jcfg, jparams, toks[arch], G, serving=name not in VARIANTS)
                for name, arch, jcfg, jparams, G in refs_todo}
    finally:
        runner.join()
    if "error" in box:
        raise box["error"]
    for arch in ARCHS:
        refs.setdefault(_name(arch, MESHES[1]), refs[_name(arch, MESHES[0])])
    ranks = box["ranks"]
    for label, (arch, mesh, s0, gen) in SERVED.items():
        tokens = _rows(ranks, label, "tokens", mesh[1])
        refs[label] = _served_reference(*inits[arch], toks[ARCHS[0]][:, :s0], tokens)
    return ranks, refs


@pytest.fixture(scope="module")
def backward_world():
    """What earlier slices refused under "model" 2, now run by
    ``tp_train_program`` at (data 2, model 2): the hybrid's and Whisper's
    gathered ``lm_loss`` gradient on the reference's weights and
    :func:`dist_check.grad_batch`'s batch of seed 1 (B 2; S past the
    hybrid's window of 32), and one FT round of ``train.run``; the ranks'
    results and, computed here meanwhile, the references."""
    grads, inits = [], {}
    for label, arch in BACKWARD.items():
        jcfg = jget_config(arch).replace(dtype="float32")
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        batch = dist_check.grad_batch(jcfg, 1, 2, 40 if jcfg.arch_type == "hybrid" else 8)
        inits[label] = (jcfg, jparams, batch)
        grads.append(dict(name=label, arch=arch, data=2, model=2,
                          overrides={"dtype": "float32"},
                          params=jax.tree.map(np.asarray, jparams), batch=batch))
    ft = [dict(name="train phase 2", arch=dist_check.TRAIN_ARCH, model=2,
               run=dict(dist_check.TRAIN, rounds=1, use_fed3r_init=False))]
    box = {}

    def run():
        try:
            box["ranks"] = run_world(dist_check.tp_train_program, WORLD, backend="gloo",
                                     device="cpu", timeout_s=240, args=(grads, (), ft))
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    runner = threading.Thread(target=run)
    runner.start()
    try:
        refs = {}
        for label, (jcfg, jparams, batch) in inits.items():
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            refs[label] = jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p: jmodel.lm_loss(jcfg, p, jb)))(jparams))
        refs["train phase 2"] = train.run(dist_check.TRAIN_ARCH, rounds=1,
                                          use_fed3r_init=False, device="cpu", verbose=False,
                                          **dist_check.TRAIN)
    finally:
        runner.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs


def _served_reference(jcfg, jparams, prompts, tokens):
    """The reference's logits of the prefill of ``prompts`` and of decode
    steps teacher-forced on the tokens a sharded ``serve`` picked (all but
    its last), stacked as ``serve`` returns them."""
    s0, gen = prompts.shape[1], tokens.shape[1]
    lg, cache = jax.jit(lambda p, t: jmodel.prefill(jcfg, p, {"tokens": t}, s0 + gen))(
        jparams, jnp.asarray(prompts))
    out = [np.asarray(lg)]
    step = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for i in range(gen - 1):
        lg, cache = step(jparams, cache, jnp.asarray(tokens[:, i:i + 1].astype(np.int32)),
                         jnp.int32(s0 + i))
        out.append(np.asarray(lg))
    return np.stack(out)


def _rows(ranks, name, key, model):
    """The data groups' rows of ``key`` in data order (model rank 0 of each)."""
    return np.concatenate([ranks[r][name][key] for r in range(0, WORLD, model)],
                          axis=1 if key in ("decode", "served") else 0)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_and_features_match_the_reference(world, arch, mesh):
    ranks, refs = world
    name, ref = _name(arch, mesh), refs[_name(arch, mesh)]
    _close(_rows(ranks, name, "logits", mesh[1]), ref["logits"])
    _close(_rows(ranks, name, "features", mesh[1]), ref["features"])
    for r in range(WORLD):
        assert abs(float(ranks[r][name]["aux"]) - ref["aux"]) <= 1e-6


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_the_reference(world, arch, mesh):
    ranks, refs = world
    name, ref = _name(arch, mesh), refs[_name(arch, mesh)]
    _close(_rows(ranks, name, "prefill", mesh[1]), ref["prefill"])
    dec = _rows(ranks, name, "decode", mesh[1])
    assert dec.shape[0] == T
    for t in range(T):
        _close(dec[t], ref["decode"][t])
    if arch in MOE:  # group-local capacity: the reference's count at G = data
        dropped, routed = ref["drops"]
        assert dropped > 0 and ranks[0][name]["drop_share"] == dropped / routed


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_ranks_of_a_data_group_agree_bitwise(world, arch, mesh):
    ranks, _ = world
    name = _name(arch, mesh)
    for r in range(WORLD):
        lead = (r // mesh[1]) * mesh[1]
        assert ranks[r][name]["coords"] == {"data": r // mesh[1], "model": r % mesh[1]}
        assert ranks[r][name]["digest"] == ranks[lead][name]["digest"]


def test_moe_groups_change_what_the_capacity_drops(world):
    """The drop-share check above sees the grouping: on the same prompts
    the reference's prefills drop another count at G = 2 than at G = 1."""
    _, refs = world
    for arch in MOE:
        assert refs[_name(arch, (1, 4))]["drops"] != refs[_name(arch, (2, 2))]["drops"]


@pytest.mark.parametrize("label", list(VARIANTS))
def test_fallback_layouts_match_the_reference(world, label):
    ranks, refs = world
    _close(_rows(ranks, label, "logits", 4), refs[label]["logits"])
    assert len({ranks[r][label]["digest"].__repr__() for r in range(WORLD)}) == 1


@pytest.mark.parametrize("case", ["scaffold under psum", "cross-attention split"])
def test_unported_layouts_and_paths_raise(world, case):
    """What stays refused under "model" 2: Scaffold's rounds under psum (as
    in the reference).  A cross-attention (k, v) split over the frames,
    refused until the sharded cross-attention learned it, now runs and
    matches the reference's unsharded model."""
    ranks, _ = world
    if case == "scaffold under psum":
        kind, msg = ranks[0]["refusals"][case]
        assert kind == "ValueError" and "scaffold" in msg, (kind, msg)
    else:
        check_cross_split(ranks[0]["refusals"][case], 2, cross_split_reference())


@pytest.mark.parametrize("case", ["train phase 2", "hybrid backward", "audio backward"])
def test_formerly_refused_backward_matches_the_reference(backward_world, case):
    """Under "model" 2 (data 2): ``train.run``'s phase 2 against the
    one-process driver (the proxy smoke computes in bf16: within 4 bf16
    ulps of max|dtheta|, the head bitwise); the hybrid's and Whisper's
    gathered ``lm_loss`` gradient against ``jax.grad`` of the reference,
    each leaf within REL of its max|g| (an attention key bias, whose
    gradient is zero in exact arithmetic, of the tree's largest |g|;
    Whisper's decoder cross-attention q and k leaves and the norm before
    it, whose gradients the softmax's centring cancels, within 1e-3)."""
    ranks, refs = backward_world
    if case == "train phase 2":
        got = ranks[0][case]["params"]
        one = refs[case]
        want, start = one["ft"]["state"].params["backbone"], one["params0"]
        err = scale = 0.0
        for g, w, s in zip(jax.tree.leaves(got["backbone"]),
                           jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), want)),
                           jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), start))):
            err = max(err, float(np.abs((g - s) - (w - s)).max()))
            scale = max(scale, float(np.abs(w - s).max()))
        assert scale > 0 and err <= 4 * 2.0 ** -8 * scale, (err, scale)
        assert np.array_equal(got["head"]["W"], one["ft"]["state"].params["head"]["W"].numpy())
        return
    cfg = get_config(BACKWARD[case]).replace(dtype="float32")
    flat = {}
    map_with_path(ranks[0][case]["sound"]["grads"],
                  lambda path, x: flat.__setitem__("/".join(path), x))
    want = {}
    map_with_path(params_from_jax(cfg, refs[case], device="cpu"),
                  lambda path, x: want.__setitem__("/".join(path), x.numpy()))
    assert set(flat) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        scale = top if path.endswith("/bk") else float(np.abs(w).max())
        rel = 1e-3 if re.search(r"dec_layers/\d+/(cross_attn/(wq|wk|bq)|norm2/(scale|bias))$",
                                path) else REL
        assert float(np.abs(flat[path] - w).max()) <= rel * scale, path


@pytest.mark.parametrize("label", list(SERVED))
def test_formerly_refused_layouts_serve_as_the_reference(world, label):
    """``serve`` over the mesh: its logits against the reference's on the
    tokens it picked, equal bits on a data group's model ranks; the
    2-kv-head ring in the sequence layout, 2 slots a rank."""
    ranks, refs = world
    arch, (data, model), s0, gen = SERVED[label]
    got = _rows(ranks, label, "served", model)
    assert got.shape[:2] == (gen, B)
    _close(got, refs[label])
    for r in range(WORLD):
        assert ranks[r][label]["digest"] == ranks[r - r % model][label]["digest"]
    if label == "sequence cache":
        assert ranks[0][label]["layouts"]["kv cache"] == "sequence"


def test_train_phase1_with_a_model_axis_matches_one_process(world):
    """Phase 1 over (data 2, model 2): the features tensor-parallel, the
    statistics all-reduced over "data"; against the one-process driver.
    The proxy computes in bf16, and its features round apart where the
    sharded layers sum partial products: A and b within one bf16 ulp of
    their largest entry; every rank the same bits."""
    ranks, _ = world
    one = train.run(dist_check.TRAIN_ARCH, device="cpu", verbose=False, **dist_check.TRAIN)
    for r in range(WORLD):
        got = ranks[r]["train"]
        _close(got["A"], one["stats"].A.numpy(), 2.0 ** -8)
        _close(got["b"], one["stats"].b.numpy(), 2.0 ** -8)
        assert np.array_equal(got["A"], ranks[0]["train"]["A"])
    assert abs(ranks[0]["train"]["acc"] - one["fed3r_acc"]) <= 0.05


def test_hints_without_a_mesh_are_the_unsharded_model():
    assert hints.get_mesh() is None and hints.model_size() == 1
    assert hints.mesh_axis_size("data") == 1 and hints.data_shards() == 1
    x = torch.ones(3)
    assert hints.reduce_model(x) is x and hints.gather_model(x, 0) is x
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}


class _FakeMesh:
    """The few DeviceMesh members the sharding code reads, for one rank."""

    def __init__(self, shape, names, where):
        self.mesh = torch.zeros(shape)
        self.mesh_dim_names = names
        self._where = where

    def get_local_rank(self, axis):
        return self._where[axis]


def test_blocks_from_a_factory_are_the_whole_leaves_cut():
    """``shard_params_from`` with ``seeded_factory`` equals ``shard_params``
    of the whole tree, for every rank of (data 2, model 4)."""
    cfg = get_config("llama4-scout-17b-a16e-smoke")
    factory = seeded_factory(3, chunk=1 << 14)
    whole = full_params(cfg, factory, "cpu")
    for m in range(4):
        mesh = _FakeMesh((2, 4), ("data", "model"), {"data": 1, "model": m})
        a = shard_params_from(cfg, factory, mesh, "cpu")
        b = shard_params(cfg, whole, mesh)
        assert a["layers"][1]["moe"]["w_up"].shape == (1, 128, 128)
        flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(flat_a) == len(flat_b)
        assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))


# ---------------------------------------------------------------------------
# the windowed train attention's chunks (no host read of a position)
# ---------------------------------------------------------------------------


def test_chunked_windowed_attention_matches_the_reference_at_4096():
    """S 4096, window 2048: four query chunks whose key ranges start at the
    chunks' first positions, as the reference's clip computes them."""
    rng = np.random.default_rng(7)
    Bq, Sq, H, KV, hd, window = 1, 4096, 2, 1, 16, 2048
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    got = attention.multihead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        torch.from_numpy(pos), window=window)
    want = jattn.multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), jnp.asarray(pos), window=window)
    _close(got.numpy(), np.asarray(want), 1e-6)
