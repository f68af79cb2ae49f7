"""FSDP in the SSM, hybrid, VLM and audio stacks against the reference, on gloo ranks on the CPU.

One module-scoped 4-rank world at (data 2, model 2) runs
:func:`repro_torch.launch.dist_check.fsdp_program` while the references
compute in the test's thread, for ``mamba2-1.3b-smoke``,
``recurrentgemma-9b-smoke``, ``qwen2-vl-2b-smoke`` and
``whisper-large-v3-smoke`` widened to d_model 1024 (FSDP, the reference's
``param_specs(..., fsdp=True)``, splits no dim under 1024; the hybrid's
RG-LRU width too, and 4 layers: one stacked (rec, rec, attn) super-block
and one unrolled ``rec`` remainder, each block with its own layout):

* prefill and teacher-forced decode logits in the FSDP layout are bitwise
  those of the TP-only layout on the same mesh (a gather is exact); the
  hybrid's prompt is longer than its 32-slot window, the VLM's and
  Whisper's carry their patches and frames; the FSDP run gathers every
  FSDP leaf once a forward: in the prefill all of them, in each decode
  step all but the encoder's;
* ``make_train_step`` with 2 microbatches in the FSDP layout: the new
  parameters gathered whole and the loss against the reference's step on
  the same weights and batch (the bounds of ``tests/test_torch_fsdp.py``);
* ``lm_loss``'s FSDP gradient leaf by leaf against the unsharded one
  (rank 0 computes it whole and scatters each rank's FSDP block), and
  :data:`~repro_torch.launch.dist_check.FSDP_FAULTS` planted above the
  limit: the gather's backward keeping the rank's block without summing it
  over the data ranks, and an FSDP leaf's gradient averaged over the data
  ranks a second time.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dist_check  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sharding.shard import fsdp_leaves  # noqa: E402
from repro_torch.sharding.specs import map_with_path  # noqa: E402
from torch_families import batch_np, by_microbatch  # noqa: E402

REL = 1e-5  # a leaf's gradient gap over its max|g|: summation order only
# (pattern, the max|g| a limit scales, the limit) of the leaves held apart:
# * an attention key bias: its gradient is zero in exact arithmetic (a
#   softmax is blind to one shift of every key), so what is there is
#   rounding; held at REL of the largest |g| of the whole tree, as
#   tests/test_torch_tp_train.py holds it;
# * Whisper's decoder cross-attention q and k and the norm before them:
#   their gradients, about 1e-4 of the tree's largest, are what is left
#   after the softmax's centring cancels the rest, so the ranks' other
#   order of the model-axis sums shows in them magnified: FSDP at (2, 2)
#   reads up to 2.1e-5 of their own max|g| against the unsharded gradient,
#   as TP-only does; held at 1e-4 of it (tests/test_torch_tp_train.py
#   holds them at 1e-3 against the reference's gradient, which the port's
#   unsharded one differs from by up to 1.6e-4)
LEAF_RELS = ((r"/bk$", "tree", REL),
             (r"dec_layers/\d+/(cross_attn/(wq|wk|bq)|norm2/(scale|bias))$", "leaf", 1e-4))
FT_BF16_REL = 4 * 2.0 ** -8  # the bf16 step's dtheta (tests/test_torch_tp_train.py)
WIDE = {"d_model": 1024, "d_ff": 2048, "dtype": "float32"}
FAMILIES = {
    "ssm": ("mamba2-1.3b-smoke", {"d_model": 1024, "dtype": "float32"}),
    "hybrid": ("recurrentgemma-9b-smoke", dict(WIDE, lru_width=1024, n_layers=4)),
    "vlm": ("qwen2-vl-2b-smoke", WIDE),
    # the learned position table cut from 32768 rows (never FSDP-split)
    "audio": ("whisper-large-v3-smoke", dict(WIDE, n_positions=64)),
}
SERVE = {"ssm": (8, 4), "hybrid": (36, 4), "vlm": (8, 4), "audio": (8, 4)}  # (S, T), B 4
STEP = dict(lr=0.1, num_microbatches=2, B=4, S=16)


def _cfg(family):
    arch, over = FAMILIES[family]
    return get_config(arch).replace(**over)


@pytest.fixture(scope="module")
def world():
    jobs, refs = [], {}
    for family, (arch, over) in FAMILIES.items():
        cfg = _cfg(family)
        S, T = SERVE[family]
        batch = batch_np(cfg, 4, S + T, seed=3)
        inputs = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        jobs.append(dict(name=f"serve {family}", job="serve", arch=arch, data=2, model=2,
                         overrides=over, prompts=batch["tokens"][:, :S],
                         decode=batch["tokens"][:, S:], inputs=inputs))
        jcfg = jget_config(arch).replace(**over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(5))
        step_batch = dist_check.grad_batch(jcfg, 6, STEP["B"], STEP["S"])
        jobs.append(dict(name=f"step {family}", job="step", arch=arch, model=2, overrides=over,
                         params=jax.tree.map(np.asarray, jparams),
                         batch=by_microbatch(step_batch, 2, STEP["num_microbatches"]),
                         lr=STEP["lr"], num_microbatches=STEP["num_microbatches"], fsdp=True))
        jobs.append(dict(name=f"grad {family}", job="grad", arch=arch, data=2, model=2,
                         overrides=over, seed=0, batch=dist_check.grad_batch(cfg, 21, 4, 8),
                         reference=True, faults=dist_check.FSDP_FAULTS, fsdp=True))
        refs[family] = (jcfg, jparams, step_batch)
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
            new, loss = jsteps.make_train_step(
                jcfg, lr=STEP["lr"], num_microbatches=STEP["num_microbatches"])(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
            out[family] = (jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, new),
                           float(loss))
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


def _n_gathers(cfg, skip=()):
    """The FSDP leaves of ``cfg`` at (2, 2), those under the top-level keys
    ``skip`` left out."""
    flags = []
    map_with_path(fsdp_leaves(cfg, {"data": 2, "model": 2}),
                  lambda path, f: flags.append(f and path[0] not in skip))
    return sum(flags)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fsdp_logits_are_the_tp_layouts_bitwise(world, family):
    """Prefill and decode logits, FSDP against TP-only on the same mesh,
    every rank."""
    ranks, _ = world
    for r in range(4):
        got = ranks[r][f"serve {family}"]
        assert np.array_equal(got["fsdp"]["prefill"], got["tp"]["prefill"])
        assert np.array_equal(got["fsdp"]["decode"], got["tp"]["decode"])
        assert np.isfinite(got["fsdp"]["decode"]).all()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_fsdp_leaf_is_gathered_once_a_forward(world, family):
    """The FSDP run's all-gathers beyond TP-only's: every FSDP leaf of the
    model once in the prefill (each block's own layout, the final norm and
    an encoder's norm), every one but the encoder's in each decode step;
    every group 2 ranks."""
    ranks, _ = world
    cfg = _cfg(family)
    T = SERVE[family][1]
    want = _n_gathers(cfg) + T * _n_gathers(cfg, skip=("enc_layers", "enc_norm"))
    assert want > 0
    for r in range(4):
        got = ranks[r][f"serve {family}"]
        gathers = [sum(c[0] == "all-gather" for c in got[f"census {k}"]) for k in ("tp", "fsdp")]
        assert gathers[1] - gathers[0] == want, (gathers, want)
        assert all(c[2] == 2 for c in got["census fsdp"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fsdp_train_step_matches_the_reference(world, family):
    """make_train_step, 2 microbatches, FSDP at (2, 2): the new parameters
    gathered whole within a few bf16 ulps of max|dtheta| of the
    reference's step, the loss within 1e-5, on every rank."""
    ranks, refs = world
    cfg = _cfg(family)
    start, want, jloss = refs[family]
    got = _flat(cfg, ranks[0][f"step {family}"]["params"], False)
    want, start = _flat(cfg, want, True), _flat(cfg, start, True)
    assert sorted(got) == sorted(want)
    err = max(float(np.abs((got[k] - start[k]) - (want[k] - start[k])).max()) for k in want)
    scale = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    assert 0 < err <= FT_BF16_REL * scale, (err, scale)
    for r in range(4):
        assert ranks[r][f"step {family}"]["loss"] == pytest.approx(jloss, rel=1e-5)


def _worst(gaps):
    """The largest leaf gap over its limit (1 at the limit)."""
    top = max(scale for _, scale in gaps.values())

    def limit(path, scale):
        for pattern, over, rel in LEAF_RELS:
            if re.search(pattern, path):
                return rel * (top if over == "tree" else scale)
        return REL * scale

    return max(err / limit(path, scale) for path, (err, scale) in gaps.items())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fsdp_gradient_matches_the_unsharded_one(world, family):
    """Every leaf of the gradient, FSDP at (2, 2), within REL of its max|g|
    of the unsharded gradient (LEAF_RELS' leaves within their own limits)."""
    got = world[0][0][f"grad {family}"]
    paths = []
    map_with_path(fsdp_leaves(_cfg(family), {"data": 2, "model": 2}),
                  lambda path, _: paths.append("/".join(path)))
    assert sorted(got["sound"]["gaps"]) == sorted(paths)
    assert _worst(got["sound"]["gaps"]) <= 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_planted_fsdp_faults_read_above_the_limit(world, family):
    got = world[0][0][f"grad {family}"]
    for fault in dist_check.FSDP_FAULTS:
        assert _worst(got[fault]["gaps"]) > 100, fault
