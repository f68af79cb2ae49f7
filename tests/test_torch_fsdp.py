"""FSDP in the dense and MoE layers against the reference, on gloo ranks on the CPU.

One module-scoped 4-rank world at (data 2, model 2) runs
:func:`repro_torch.launch.dist_check.fsdp_program` while the references
compute in the test's thread.  The smokes are widened to d_model 1024,
since FSDP (``param_specs(..., fsdp=True)``, the reference's rule) splits
no dim under 1024:

* prefill and teacher-forced decode logits in the FSDP layout are bitwise
  those of the TP-only layout on the same mesh (a gather is exact);
* ``make_train_step`` with 2 microbatches in the FSDP layout: the new
  parameters gathered whole and the loss against the reference's step on
  the same weights and batch (the bounds of ``tests/test_torch_tp_train.py``);
* ``lm_loss``'s FSDP gradient leaf by leaf against the unsharded one
  (rank 0 computes it whole and scatters each rank's FSDP block), and two
  planted faults above the limit: the gather's backward keeping the
  rank's block without summing it over the data ranks, and an FSDP leaf's
  gradient averaged over the data ranks a second time;
* MoE capacity groups that span two data ranks (the multi-pod layout:
  pod 2 × data 2, G = 2) against the reference's groups on the whole batch.

The SSM, hybrid, VLM and audio stacks under FSDP: ``tests/test_torch_fsdp_families.py``.
"""
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dist_check  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sharding.specs import map_with_path  # noqa: E402
from torch_families import by_microbatch  # noqa: E402

REL = 1e-5  # a leaf's gradient gap over its max|g|: summation order only
FT_BF16_REL = 4 * 2.0 ** -8  # the bf16 step's dtheta (tests/test_torch_tp_train.py)
WIDE = {"d_model": 1024, "d_ff": 2048, "dtype": "float32"}
MOE_WIDE = {"d_model": 1024, "dtype": "float32"}
SMOKES = {"dense": ("qwen2-7b-smoke", WIDE), "moe": ("deepseek-moe-16b-smoke", MOE_WIDE)}
STEP = dict(lr=0.1, num_microbatches=2, B=4, S=16)
GROUPS = dict(arch="deepseek-moe-16b-smoke", overrides={"dtype": "float32",
                                                        "capacity_factor": 0.5}, B=8, S=8)


def _init(arch, over, seed):
    jcfg = jget_config(arch).replace(**over)
    return jcfg, jbuild_model(jcfg).init(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def world():
    jobs, refs = [], {}
    rng = np.random.default_rng(3)
    for family, (arch, over) in SMOKES.items():
        cfg = get_config(arch).replace(**over)
        toks = rng.integers(0, cfg.vocab_size, (4, 12))
        jobs.append(dict(name=f"serve {family}", job="serve", arch=arch, data=2, model=2,
                         overrides=over, prompts=toks[:, :8], decode=toks[:, 8:]))
        jcfg, jparams = _init(arch, over, 5)
        batch = dist_check.grad_batch(jcfg, 6, STEP["B"], STEP["S"])
        jobs.append(dict(name=f"step {family}", job="step", arch=arch, model=2, overrides=over,
                         params=jax.tree.map(np.asarray, jparams),
                         batch=by_microbatch(batch, 2, STEP["num_microbatches"]),
                         lr=STEP["lr"], num_microbatches=STEP["num_microbatches"], fsdp=True))
        refs[family] = (jcfg, jparams, batch)
    pcfg = get_config("qwen2-7b-smoke").replace(**WIDE)
    jobs.append(dict(name="grad", job="grad", arch="qwen2-7b-smoke", data=2, model=2,
                     overrides=WIDE, seed=0, batch=dist_check.grad_batch(pcfg, 21, 4, 8),
                     reference=True, faults=dist_check.FSDP_FAULTS, fsdp=True))
    gcfg, gparams = _init(GROUPS["arch"], GROUPS["overrides"], 7)
    gtoks = rng.integers(0, gcfg.vocab_size, (GROUPS["B"], GROUPS["S"])).astype(np.int32)
    jobs.append(dict(name="groups", job="moe_groups", arch=GROUPS["arch"],
                     overrides=GROUPS["overrides"], params=jax.tree.map(np.asarray, gparams),
                     tokens=gtoks))

    jobs.append(dict(name="vmap", job="gather_vmap", model=2))
    box = {}

    def run():
        try:
            box["ranks"] = run_world(dist_check.fsdp_program, 4, backend="gloo", device="cpu",
                                     timeout_s=600, args=(jobs,))
        except Exception as e:  # re-raised in the test's thread
            box["error"] = e

    runner = threading.Thread(target=run)
    runner.start()
    try:
        out = {}
        for family, (jcfg, jparams, batch) in refs.items():
            with pytest.MonkeyPatch.context() as mp:  # the reference's G = 2 capacity groups
                mp.setattr(jmoe, "mesh_axis_size", lambda name: 2 if name == "data" else 1)
                new, loss = jsteps.make_train_step(
                    jcfg, lr=STEP["lr"], num_microbatches=STEP["num_microbatches"])(
                    jparams, {k: jnp.asarray(v) for k, v in batch.items()})
            out[family] = (jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, new),
                           float(loss))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmoe, "mesh_axis_size", lambda name: 2 if name == "data" else 1)
            fw = jmodel.forward(gcfg, gparams, {"tokens": jnp.asarray(gtoks)}, mode="train")
        out["groups"] = np.asarray(fw.logits)
    finally:
        runner.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], out


def _flat(cfg, tree, from_jax):
    if from_jax:
        tree = params_from_jax(cfg, tree, device="cpu")
    out = {}
    map_with_path(tree, lambda path, x: out.__setitem__("/".join(path), np.asarray(x)))
    return out


@pytest.mark.parametrize("family", list(SMOKES))
def test_fsdp_logits_are_the_tp_layouts_bitwise(world, family):
    """Prefill and decode logits, FSDP against TP-only on the same mesh,
    every rank; the FSDP prefill gathers over "data" (its census)."""
    ranks, _ = world
    for r in range(4):
        got = ranks[r][f"serve {family}"]
        assert np.array_equal(got["fsdp"]["prefill"], got["tp"]["prefill"])
        assert np.array_equal(got["fsdp"]["decode"], got["tp"]["decode"])
        kinds = [c[0] for c in got["census fsdp"]]
        assert "all-gather" in kinds and len(kinds) > len(got["census tp"])
        assert all(c[2] == 2 for c in got["census fsdp"])  # every group: 2 ranks


@pytest.mark.parametrize("family", list(SMOKES))
def test_fsdp_train_step_matches_the_reference(world, family):
    """make_train_step, 2 microbatches, FSDP at (2, 2): the new parameters
    gathered whole within a few bf16 ulps of max|dtheta| of the
    reference's step, the loss within 1e-5, on every rank."""
    ranks, refs = world
    arch, over = SMOKES[family]
    cfg = get_config(arch).replace(**over)
    start, want, jloss = refs[family]
    got = _flat(cfg, ranks[0][f"step {family}"]["params"], False)
    want, start = _flat(cfg, want, True), _flat(cfg, start, True)
    err = max(float(np.abs((got[k] - start[k]) - (want[k] - start[k])).max()) for k in want)
    scale = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    assert err <= FT_BF16_REL * scale, (err, scale)
    for r in range(4):
        assert ranks[r][f"step {family}"]["loss"] == pytest.approx(jloss, rel=1e-5)


def _worst(gaps):
    top = max(scale for _, scale in gaps.values())
    # an attention key bias's gradient is zero in exact arithmetic: its
    # rounding is held against the tree's largest |g|
    return max(err / (top if re.search(r"/bk$", path) else scale)
               for path, (err, scale) in gaps.items())


def test_fsdp_gradient_matches_the_unsharded_one_and_the_faults_do_not(world):
    ranks, _ = world
    got = ranks[0]["grad"]
    assert _worst(got["sound"]["gaps"]) <= REL
    for fault in dist_check.FSDP_FAULTS:
        assert _worst(got[fault]["gaps"]) > 100 * REL, fault


def test_moe_groups_spanning_two_data_ranks_match_the_reference(world):
    """pod 2 × data 2: G = 2 capacity groups of two ranks' tokens each,
    capacity factor 0.5 so the positions decide what drops."""
    ranks, refs = world
    got = np.concatenate([ranks[r]["groups"]["logits"] for r in range(4)])
    want = refs["groups"]
    V = get_config(GROUPS["arch"]).vocab_size
    assert np.abs(got[..., :V] - want[..., :V]).max() <= 1e-5 * np.abs(want[..., :V]).max()
    shares = {ranks[r]["groups"]["drop_share"] for r in range(4)}
    assert len(shares) == 1 and 0 < shares.pop() < 1


def test_the_fsdp_gather_and_its_gradient_under_vmap(world):
    """gather_data's vmap rule gathers the physical batch along the shifted
    dim, and its backward's (the reduce-scatter's) likewise: mapped equals
    looped, bitwise; the gathered blocks are the data ranks' in order."""
    ranks, _ = world
    for r in range(4):
        got = ranks[r]["vmap"]
        assert np.array_equal(got["mapped"], got["looped"])
        assert np.array_equal(got["grad mapped"], got["grad looped"])
        other = ranks[(r + 2) % 4]["vmap"]  # the same model rank of the other data rank
        blocks = [got["looped"][:, :, 4 * j:4 * j + 4] for j in range(2)]
        assert np.array_equal(blocks[r // 2], np.arange(24, dtype=np.float32).reshape(3, 2, 4)
                              + 100 * r)
        assert np.array_equal(got["looped"], other["looped"])
        # each data rank's 2·(the gathered x), reduce-scattered: 4x on the block
        assert np.array_equal(got["grad looped"],
                              4 * (np.arange(24, dtype=np.float32).reshape(3, 2, 4) + 100 * r))
