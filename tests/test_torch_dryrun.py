"""``launch/dryrun.py`` against the reference's dry run, and against real ranks.

* The decisions of every (arch × shape × mesh) combination of the ten
  assigned archs and four shapes on both production meshes and on the
  4-rank meshes (2, 2), (4, 1) and (1, 4) (where the reference picks FSDP
  for the hybrid, VLM and audio families too), and of the
  ``--kind fed3r`` statistics step at ``prefill_32k``: FSDP, microbatches,
  variant and the skip record equal the reference's, and the port's
  ``argument_size_in_bytes`` (on the meta device) equals the sum of the
  reference's shard shapes of the same arguments (params under its FSDP
  choice, batch, cache, stats).  The reference's ``repro.launch.dryrun``
  writes ``XLA_FLAGS`` when imported, so it runs only in a subprocess with
  ``REPRO_DRYRUN_DEVICES`` set.
* The census: the dry run over a fake world at (data 1, model 4) and
  (data 2, model 2), every rank of it in a subprocess, issues exactly the
  collectives (kinds, buffer bytes, group sizes, in order) that the real
  gloo ranks do running the same rank program, for train (FSDP and
  TP-only), prefill, decode and the statistics step of a dense and an MoE
  smoke widened to d_model 1024 (FSDP splits no dim under 1024), and the
  hybrid's FSDP train and statistics steps; one dense block issues its
  known collectives; and FSDP over a data axis of 1 (the reference's
  decision for the hybrid's ``train_4k`` at (1, 4)) serves TP-only's
  logits bitwise.
* The command line at smoke width on the CPU writes a JSONL record with
  the reference's keys, and an error exits 1; a fake world is refused by
  every other mesh; the int8 KV cache of full-width ``qwen2-7b`` takes
  under 0.6× the bf16 one's bytes (``tests/test_extensions.py:36``).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dist_check, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_dryrun_mesh, make_host_mesh  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.sharding import hints  # noqa: E402
from repro_torch.sharding.shard import fsdp_dims  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PRODUCTION = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the 4-rank meshes the port runs on real ranks: there the reference picks
# FSDP for the hybrid, VLM and audio families too
SMALL = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
         "1x4": {"data": 1, "model": 4}}
MESHES = {**PRODUCTION, **SMALL}
FAMILY_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b", "qwen2-vl-2b", "whisper-large-v3")

# the reference's decisions and argument bytes of each combination, keyed
# "arch|shape|mesh|kind"; run in a subprocess of 512 host devices
_REFERENCE = textwrap.dedent('''
    import json, math
    from repro.launch import dryrun as jd  # first: it sets XLA_FLAGS before jax starts
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
    from repro.launch.shapes import variant_for
    from repro.sharding.specs import batch_specs, cache_specs, param_specs, stats_specs

    def shard_bytes(mesh, specs, tree):
        leaves = jax.tree.leaves(tree)
        sps = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(sps)
        return int(sum(math.prod(NamedSharding(mesh, s).shard_shape(l.shape))
                       * jnp.dtype(l.dtype).itemsize for l, s in zip(leaves, sps)))

    devs, out = np.array(jax.devices()), {}
    for dims in ((16, 16), (2, 16, 16), (2, 2), (4, 1), (1, 4)):
        multi = len(dims) == 3
        axes = ("pod", "data", "model") if multi else ("data", "model")
        mesh = Mesh(devs[:math.prod(dims)].reshape(dims), axes)
        ax, da = dict(zip(axes, dims)), tuple(a for a in axes if a != "model")
        for arch in ASSIGNED_ARCHS:
            for name, shape in INPUT_SHAPES.items():
                kinds = (shape.kind, "fed3r") if name == "prefill_32k" else (shape.kind,)
                for kind in kinds:
                    key = "|".join((arch, name, "x".join(map(str, dims)), kind))
                    cfg = variant_for(get_config(arch), shape)
                    if cfg is None:  # lower_one returns before it compiles
                        rec = jd.lower_one(arch, name, multi_pod=multi, mesh=mesh,
                                           kind_override=None if kind == shape.kind else kind)
                        out[key] = {k: rec[k] for k in ("status", "skip_reason")}
                        continue
                    M = jd._pick_microbatches(cfg, shape, jd._da_size(ax, da))
                    _, args, fsdp = jd._build_jit(cfg, kind, shape, mesh, ax, da,
                                                  num_microbatches=M)
                    fa = ("pod", "data") if "pod" in ax else "data"
                    nb = shard_bytes(mesh, param_specs(cfg, args[0], ax, fsdp=fsdp, fsdp_axis=fa),
                                     args[0])
                    if kind in ("train", "prefill"):
                        nb += shard_bytes(mesh, batch_specs(cfg, args[1], da, ax), args[1])
                    elif kind == "decode":
                        nb += shard_bytes(mesh, cache_specs(cfg, args[1], da, ax), args[1])
                        bdiv = shape.global_batch % jd._da_size(ax, da) == 0
                        nb += shard_bytes(mesh, P(da if bdiv else None, None), args[2])
                        nb += shard_bytes(mesh, P(), args[3])
                    else:
                        nb += shard_bytes(mesh, stats_specs(cfg.d_feat, ax), args[1])
                        nb += shard_bytes(mesh, batch_specs(cfg, args[2], da, ax), args[2])
                    rec = {"status": "pending", "fsdp": bool(fsdp), "num_microbatches": M,
                           "remat_block_size": cfg.remat_block_size,
                           "argument_size_in_bytes": nb}
                    if cfg.sliding_window and name == "long_500k":
                        rec["variant"] = f"sliding_window={cfg.sliding_window}"
                    out[key] = rec
    print(json.dumps(out))
''')

KEYS = [f"{arch}|{name}|{mesh}|{kind}" for mesh in MESHES for arch in ASSIGNED_ARCHS
        for name, shape in INPUT_SHAPES.items()
        for kind in ((shape.kind, "fed3r") if name == "prefill_32k" else (shape.kind,))]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="512", JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    got = subprocess.run([sys.executable, "-c", _REFERENCE], env=env, capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def _port(key):
    arch, name, mesh, kind = key.split("|")
    shape = INPUT_SHAPES[name]
    rec = dryrun.plan(arch, name, MESHES[mesh], None if kind == shape.kind else kind)
    return rec.pop("cfg"), rec


def test_every_combination_is_covered(reference):
    assert sorted(reference) == sorted(KEYS)
    assert len(KEYS) == (len(ASSIGNED_ARCHS) * 4 + len(ASSIGNED_ARCHS)) * len(MESHES)
    skipped = [k for k, v in reference.items() if v["status"] == "skipped"]
    assert sorted(skipped) == sorted(f"whisper-large-v3|long_500k|{m}|decode" for m in MESHES)


@pytest.mark.parametrize("key", KEYS)
def test_decisions_equal_the_references(reference, key):
    """FSDP, microbatches, the remat block, the variant and the skip record."""
    _, rec = _port(key)
    keys = ("status", "fsdp", "num_microbatches", "remat_block_size", "variant", "skip_reason")
    want = {k: v for k, v in reference[key].items() if k in keys}
    assert {k: rec[k] for k in keys if k in rec} == want


@pytest.mark.parametrize("key", [k for k in KEYS if "whisper-large-v3|long_500k" not in k])
def test_argument_bytes_equal_the_references_shard_shapes(reference, key):
    cfg, rec = _port(key)
    name, mesh = key.split("|")[1:3]
    got = dryrun.argument_bytes(cfg, rec["kind"], INPUT_SHAPES[name], MESHES[mesh], rec["fsdp"])
    assert got == reference[key]["argument_size_in_bytes"]


def test_fsdp_picks_the_references_archs(reference):
    """On the production meshes: FSDP in train and serving for
    command-r-plus and llama4-scout, in train only for deepseek-coder-33b;
    no other assigned arch passes a threshold."""
    fsdp = {(k.split("|")[0], k.split("|")[3]) for k, v in reference.items()
            if v.get("fsdp") and k.split("|")[2] in PRODUCTION}
    assert {a for a, _ in fsdp} == {"command-r-plus-104b", "llama4-scout-17b-a16e",
                                    "deepseek-coder-33b"}
    assert {k for a, k in fsdp if a == "deepseek-coder-33b"} == {"train"}


@pytest.mark.parametrize("mesh", list(SMALL))
def test_fsdp_reaches_the_other_families_on_small_meshes(reference, mesh):
    """On the 4-rank meshes the reference picks FSDP for recurrentgemma-9b
    at (2, 2) and (4, 1) in every step, at (1, 4) for train_4k (over a data
    axis of 1), and for qwen2-vl-2b's and whisper-large-v3's train_4k at
    (4, 1); never for mamba2-1.3b."""
    fsdp = {(k.split("|")[0], k.split("|")[1], k.split("|")[3]) for k, v in reference.items()
            if v.get("fsdp") and k.split("|")[2] == mesh}
    want = {
        "2x2": {("recurrentgemma-9b", n, k) for n, k in
                [("train_4k", "train"), ("prefill_32k", "prefill"), ("prefill_32k", "fed3r"),
                 ("decode_32k", "decode"), ("long_500k", "decode")]},
        "1x4": {("recurrentgemma-9b", "train_4k", "train")},
    }
    want["4x1"] = want["2x2"] | {(a, "train_4k", "train")
                                 for a in ("qwen2-vl-2b", "whisper-large-v3")}
    assert {f for f in fsdp if f[0] in FAMILY_ARCHS} == want[mesh]


# ---------------------------------------------------------------------------
# the census: a fake world's rank against the real gloo ranks
# ---------------------------------------------------------------------------

WIDE = {"d_model": 1024, "d_ff": 2048}  # FSDP splits only dims of 1024 and more
MOE_WIDE = {"d_model": 1024}
HYBRID_WIDE = dict(WIDE, lru_width=1024)
TRAIN = dict(name="train_4k", seq_len=32, global_batch=8, kind="train")
PREFILL = dict(name="prefill_32k", seq_len=32, global_batch=4, kind="prefill")
DECODE = dict(name="decode_32k", seq_len=32, global_batch=4, kind="decode")
JOBS = [
    dict(name="dense train fsdp", arch="qwen2-7b-smoke", shape=TRAIN, overrides=WIDE, fsdp=True),
    dict(name="dense train fsdp 1 layer", arch="qwen2-7b-smoke", shape=TRAIN,
         overrides=dict(WIDE, n_layers=1), fsdp=True),
    dict(name="dense train", arch="qwen2-7b-smoke", shape=TRAIN, overrides=WIDE, fsdp=False),
    dict(name="dense train 1 layer", arch="qwen2-7b-smoke", shape=TRAIN,
         overrides=dict(WIDE, n_layers=1), fsdp=False),
    dict(name="dense prefill fsdp", arch="qwen2-7b-smoke", shape=PREFILL, overrides=WIDE,
         fsdp=True),
    dict(name="dense decode fsdp", arch="qwen2-7b-smoke", shape=DECODE, overrides=WIDE,
         fsdp=True),
    dict(name="dense fed3r", arch="qwen2-7b-smoke", shape=PREFILL, overrides=WIDE,
         kind="fed3r"),
    dict(name="moe train fsdp", arch="deepseek-moe-16b-smoke", shape=TRAIN, overrides=MOE_WIDE,
         fsdp=True),
    dict(name="moe prefill fsdp", arch="deepseek-moe-16b-smoke", shape=PREFILL,
         overrides=MOE_WIDE, fsdp=True),
    dict(name="hybrid train fsdp", arch="recurrentgemma-9b-smoke", shape=TRAIN,
         overrides=HYBRID_WIDE, fsdp=True),
    dict(name="hybrid fed3r fsdp", arch="recurrentgemma-9b-smoke", shape=PREFILL,
         overrides=HYBRID_WIDE, kind="fed3r", fsdp=True),
]
CENSUS_MESHES = [(1, 4), (2, 2)]

_FAKE = textwrap.dedent('''
    import pickle, sys, torch
    from repro_torch.launch import dist_check
    torch.set_num_threads(1)  # as the gloo ranks run
    meshes, jobs, path = pickle.load(open(sys.argv[1], "rb"))
    out = {mesh: dist_check.fake_world_jobs({"data": mesh[0], "model": mesh[1]}, range(4), jobs)
           for mesh in meshes}
    pickle.dump(out, open(path, "wb"))
''')


@pytest.fixture(scope="module")
def censuses(tmp_path_factory):
    """The real gloo ranks' rank programs at both meshes, then every rank of
    the fake worlds in one subprocess (so no fake world enters pytest)."""
    jobs = [dict(job, name=f"{job['name']}@{d}x{m}", job="dryrun", data=d, model=m)
            for d, m in CENSUS_MESHES for job in JOBS]
    # FSDP over a data axis of 1, as the reference decides for the hybrid's
    # train_4k at (1, 4), against TP-only
    cfg = get_config("recurrentgemma-9b-smoke").replace(**HYBRID_WIDE)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40))
    jobs.append(dict(name="data 1", job="serve", arch="recurrentgemma-9b-smoke", data=1,
                     model=4, overrides=dict(HYBRID_WIDE, dtype="float32"),
                     prompts=toks[:, :36], decode=toks[:, 36:]))
    real = run_world(dist_check.fsdp_program, 4, backend="gloo", device="cpu", timeout_s=600,
                     args=(jobs,))
    tmp = tmp_path_factory.mktemp("dryrun")
    args, path = tmp / "fake.in", tmp / "fake.out"
    args.write_bytes(pickle.dumps((CENSUS_MESHES, JOBS, str(path))))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    got = subprocess.run([sys.executable, "-c", _FAKE, str(args)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return real, pickle.loads(path.read_bytes())


@pytest.mark.parametrize("mesh", CENSUS_MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("job", [j["name"] for j in JOBS])
def test_the_fake_worlds_census_equals_the_real_ranks(censuses, mesh, job):
    """Every rank of the fake world issues the real rank's collectives, in
    order, with the same buffer bytes and group sizes; the plans agree."""
    real, fake = censuses
    for r in range(4):
        got, want = fake[mesh][r][job], real[r][f"{job}@{mesh[0]}x{mesh[1]}"]
        assert got["census"] == want["census"], (r, len(got["census"]), len(want["census"]))
        assert got["plan"] == want["plan"]
        assert got["built_bytes"] == want["built_bytes"]
        assert got["peak_bytes"] is None and want["peak_bytes"] is None  # the CPU
    assert len(want["census"]) > 0


def test_fsdp_over_a_data_axis_of_1_is_tp_only_bitwise(censuses):
    """(data 1, model 4) with FSDP: the gathers are the blocks themselves,
    so prefill and decode logits and the collectives are TP-only's."""
    real, _ = censuses
    for r in range(4):
        got = real[r]["data 1"]
        assert np.array_equal(got["fsdp"]["prefill"], got["tp"]["prefill"])
        assert np.array_equal(got["fsdp"]["decode"], got["tp"]["decode"])
        assert got["census fsdp"] == got["census tp"]


def _kinds(census):
    out = {}
    for kind, *_ in census:
        out[kind] = out.get(kind, 0) + 1
    return out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
def test_a_dense_block_issues_its_known_collectives(censuses, fsdp):
    """One dense block of a train step at (2, 2): an all-reduce after the
    attention and one after the MLP, in the forward, again in the
    recompute, and their backwards; under FSDP each FSDP leaf of the block
    gathered in the forward and the recompute and reduce-scattered once."""
    _, fake = censuses
    name = "dense train fsdp" if fsdp else "dense train"
    two, one = (_kinds(fake[(2, 2)][0][n]["census"]) for n in (name, name + " 1 layer"))
    block = {k: two.get(k, 0) - one.get(k, 0) for k in set(two) | set(one)}
    want = {"all-reduce": 6}
    if fsdp:
        cfg = get_config("qwen2-7b-smoke").replace(**WIDE)
        mesh = make_dryrun_mesh(sizes={"data": 2, "model": 2}, device_type="cpu")
        try:
            with hints.use_mesh(mesh, fsdp=True):
                n = len(fsdp_dims(cfg, ("layers", "0")))
        finally:
            dist.destroy_process_group()
        assert n == 9  # norm1, wq, wk, wv, wo, w_gate, w_up, w_down, norm2
        want.update({"all-gather": 2 * n, "reduce-scatter": n})
    assert {k: v for k, v in block.items() if v} == want


# ---------------------------------------------------------------------------
# the command line, the fake world's fences, the int8 cache
# ---------------------------------------------------------------------------

REFERENCE_KEYS = ("arch", "shape", "mesh", "kind", "status", "num_microbatches",
                  "remat_block_size", "fsdp", "argument_size_in_bytes", "per_device_bytes",
                  "per_device_gb", "fits_hbm", "collectives", "collective_wire_by_kind",
                  "collective_wire_bytes_per_chip", "hlo_flops_global", "hlo_bytes_global",
                  "roofline", "model_flops", "useful_flops_ratio", "params", "total_s")


def _cli(tmp_path, *args):
    out = tmp_path / "dry.jsonl"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    got = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
                          "--out", str(out), *args], env=env, capture_output=True, text=True,
                         timeout=300)
    recs = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
    return got, recs


def test_the_command_line_writes_the_references_keys(tmp_path):
    got, recs = _cli(tmp_path, "--arch", "qwen2-7b-smoke", "--shape", "decode_32k")
    assert got.returncode == 0, got.stderr[-2000:]
    (rec,) = recs
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert set(REFERENCE_KEYS) <= set(rec), set(REFERENCE_KEYS) - set(rec)
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant"}
    assert {"setup_s", "step_s"} <= set(rec) and rec["device"] == "cpu"
    assert rec["per_device_bytes"] is None and rec["fits_hbm"] is None  # not measured here
    assert rec["argument_size_in_bytes"] == rec["argument_size_in_bytes_built"]
    assert rec["collectives"]["all-reduce"] > 0 and rec["collective_values"].startswith("not")
    assert rec["roofline"]["link_bytes_per_s"] == 50e9  # a 16 x 16 group spans nodes
    assert "mesh:" in got.stdout and "done: ok=1 failed=0 skipped=0" in got.stdout


def test_the_command_line_records_an_error_and_exits_1(tmp_path):
    """A combination that raises is recorded with its traceback, and the
    run exits 1: an arch no config names."""
    got, recs = _cli(tmp_path, "--arch", "no-such-arch", "--shape", "decode_32k")
    assert got.returncode == 1
    (rec,) = recs
    assert rec["status"] == "error" and "KeyError" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert "done: ok=0 failed=1 skipped=0" in got.stdout


def test_the_mamba2_smoke_whose_heads_do_not_divide_records_ok(tmp_path):
    """The Mamba2 smoke's 8 heads do not divide the production mesh's 16
    model ranks: the rules leave its SSD heads unsplit, every rank runs
    them all, and the record is ``ok``, as the reference lowers it."""
    got, recs = _cli(tmp_path, "--arch", "mamba2-1.3b-smoke", "--shape", "decode_32k")
    assert got.returncode == 0, got.stderr[-2000:]
    (rec,) = recs
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert rec["argument_size_in_bytes"] == rec["argument_size_in_bytes_built"]
    assert "done: ok=1 failed=0 skipped=0" in got.stdout


def test_a_fake_world_runs_only_the_dry_run():
    make_dryrun_mesh(sizes={"data": 2, "model": 2}, rank=3, device_type="cpu")
    try:
        with pytest.raises(RuntimeError, match="only repro_torch.launch.dryrun"):
            make_host_mesh(2, device_type="cpu")
        with pytest.raises(RuntimeError, match="already initialized"):
            make_dryrun_mesh(sizes={"data": 2, "model": 2}, device_type="cpu")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_int8_cache_memory_halves():
    """Full-width qwen2-7b's int8 KV cache on the meta device takes under
    0.6× the bf16 one's bytes: the dry run's cache arguments at (1, 1),
    equal to the reference's ``make_cache`` leaf for leaf in bytes."""
    sizes = {"data": 1, "model": 1}
    shape = ShapeConfig("decode_32k", 1024, 4, "decode")

    def port(quant):
        cfg = get_config("qwen2-7b").replace(kv_cache_quant=quant)
        return dryrun._nbytes(dryrun.rank_specs(cfg, "decode", shape, sizes, False)["cache"])

    def ref(quant):
        cfg = jget_config("qwen2-7b").replace(kv_cache_quant=quant)
        tree = jax.eval_shape(lambda: jmake_cache(cfg, 4, 1024))
        return sum(leaf.size * leaf.dtype.itemsize for leaf in jax.tree.leaves(tree))

    bytes_fp, bytes_q = port(False), port(True)
    assert (bytes_fp, bytes_q) == (ref(False), ref(True))
    assert bytes_q < 0.6 * bytes_fp  # int8 + per-token scales ≈ 0.53×
