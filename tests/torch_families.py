"""Model-level checks of the port's SSM, hybrid, VLM and audio families
against the reference package, on the CPU: shared by
``tests/test_torch_ssm.py``, ``test_torch_hybrid.py``, ``test_torch_vlm.py``
and ``test_torch_audio.py`` (one file a family, so that ``--dist loadfile``
spreads them).

Parameters come from the reference's ``init_params`` through
``params_from_jax``; tokens, labels, patch embeddings and audio frames are
drawn with numpy from a seed.  Tolerances, relative to the largest reference value:

* fp32: 1e-4 (GEMM and scan summation order only);
* bf16: 3e-2 (both sides round at the same points, but the frameworks'
  bf16 GEMMs differ inside), and at least 97% of the argmaxes equal;
  for the configs in ``ARGMAX_NEAR_TIES``, no argmax flipped where the
  reference's top-2 gap is at least twice the largest logit gap.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import build_model
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.sharding.specs import map_with_path
from repro_torch.tree import tree_leaves

REL = {"float32": 1e-4, "bfloat16": 3e-2}
ARGMAX = 0.97
# Whisper's smoke logits (max ≈ 0.8: a LayerNorm'd state against the
# 0.02-scale tied table) have a top-2 gap under twice the largest bf16
# logit gap at 6 of 32 forward and 30 of 80 prefill + decode positions;
# the reference's own bf16 and fp32 forwards agree on 96% of argmaxes
# (B 16, S 20), so a share of equal argmaxes measures the near ties, not
# the port.  Its bf16 check: every argmax equal outside the near ties
# (measured: 0 flipped there; 3 of 80 flipped inside them).
ARGMAX_NEAR_TIES = ("whisper-large-v3-smoke",)


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, rel) -> None:
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def close_logits(got, want, dtype, arch=None) -> None:
    close(got, want, REL[dtype])
    if dtype != "bfloat16":
        return
    got, want = np32(got), np32(want)
    flipped = got.argmax(-1) != want.argmax(-1)
    if arch in ARGMAX_NEAR_TIES:
        top2 = np.sort(want, -1)[..., -2:]
        near = top2[..., 1] - top2[..., 0] < 2 * np.abs(got - want).max()
        assert not (flipped & ~near).any(), (int(flipped.sum()), int(near.sum()))
    else:
        assert 1 - float(flipped.mean()) >= ARGMAX, 1 - float(flipped.mean())


def setup(arch, dtype="float32", seed=0, **kw):
    """(jcfg, cfg, jparams, params): the reference's random parameters and
    their port."""
    jcfg = jget_config(arch).replace(dtype=dtype, **kw)
    cfg = get_config(arch).replace(dtype=dtype, **kw)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def offset(cfg) -> int:
    """The positions a VLM's patches take before the text."""
    return cfg.n_patches if cfg.arch_type == "vlm" else 0


def batch_np(cfg, B, S, seed=0) -> dict:
    """Numpy tokens and labels (B, S), and a VLM's 0.1·N(0, 1) patches or an
    audio model's 0.1·N(0, 1) encoder frames."""
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        b["patch_embeds"] = (0.1 * r.standard_normal((B, cfg.n_patches, cfg.d_model))
                             ).astype(np.float32)
    if cfg.arch_type == "audio":
        b["audio_frames"] = (0.1 * r.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
                             ).astype(np.float32)
    return b


def by_microbatch(batch, dp, M) -> dict:
    """The global batch's rows laid out so each of ``dp`` data ranks' blocks
    holds its block of every global microbatch in order: make_train_step
    splits a rank's rows into M contiguous microbatches, and the
    reference's microbatch i is global rows [i·B/M, (i+1)·B/M) (MoE
    capacity and the load-balance loss are per microbatch)."""
    B = len(next(iter(batch.values())))
    k = B // (M * dp)
    order = [i * B // M + d * k + j for d in range(dp) for i in range(M) for j in range(k)]
    return {name: v[order] for name, v in batch.items()}


def named_leaves(tree, prefix="") -> dict:
    """{path: leaf} of a cache tree (dicts, and an audio layer's (k, v))."""
    if isinstance(tree, dict):
        return {n: t for k, v in tree.items() for n, t in named_leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {n: t for i, v in enumerate(tree)
                for n, t in named_leaves(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def jb(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_forward(arch, dtype, B, S, **kw):
    """The train-mode forward's logits and hidden states (``kw`` replaces
    config fields in both packages)."""
    jcfg, cfg, jparams, params = setup(arch, dtype, **kw)
    batch = batch_np(cfg, B, S)
    want = jmodel.forward(jcfg, jparams, jb(batch), mode="train")
    got = build_model(cfg).forward(params, tb(batch))
    assert got.logits.dtype == getattr(torch, dtype)
    assert got.logits.shape == (B, offset(cfg) + S, cfg.padded_vocab)
    close_logits(got.logits, want.logits, dtype, arch)
    close(got.hidden, want.hidden, REL[dtype])


def check_prefill_decode(arch, dtype, B, S, T, **kw):
    """Prefill's last logits and caches; then T decode steps, each package
    from the reference's cache (``cache_from_jax``), logits and caches.  The
    argmax share is over the B·(T + 1) positions together: random smoke
    weights give logits under 1 with top-2 gaps of a bf16 ulp, so a few
    positions flip (measured: at most 1 of 80 at B = 16)."""
    jcfg, cfg, jparams, params = setup(arch, dtype, **kw)
    batch = batch_np(cfg, B, S + T)
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[:, :S])
    off = offset(cfg)
    jprefill = jax.jit(lambda p, b: jmodel.prefill(jcfg, p, b, off + S + T))
    jdecode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(jcfg, p, c, t, pos))
    jlogits, jcache = jprefill(jparams, jb(pre))
    model = build_model(cfg)
    logits, cache = model.prefill(params, tb(pre), off + S + T)
    got, want = [logits], [jlogits]
    ref_cache = cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), device="cpu")
    assert len(cache) == len(ref_cache) == cfg.n_layers
    for c, w in zip(cache, ref_cache):
        c, w = named_leaves(c), named_leaves(w)
        assert set(c) == set(w)
        for name in c:
            assert c[name].dtype == w[name].dtype and c[name].shape == w[name].shape, name
            if name.endswith("pos"):
                assert torch.equal(c[name], w[name])
            else:
                close(c[name], w[name], REL[dtype])
    cache = ref_cache
    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok), jnp.int32(off + S + i))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok), off + S + i)
        got.append(logits)
        want.append(jlogits)
    close_logits(np.stack([np32(g) for g in got]), np.stack([np32(w) for w in want]), dtype, arch)
    for c, w in zip(cache, cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), device="cpu")):
        c, w = named_leaves(c), named_leaves(w)
        for name in c:  # the caches after T in-place updates
            close(c[name], w[name], REL[dtype])


def check_loss_and_features(arch, dtype, B, S):
    jcfg, cfg, jparams, params = setup(arch, dtype)
    batch = batch_np(cfg, B, S)
    model = build_model(cfg)
    loss = model.loss(params, tb(batch))
    jloss = jmodel.lm_loss(jcfg, jparams, jb(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(jloss)) <= REL[dtype] * abs(float(jloss))
    feats = model.extract_features(params, tb(batch))
    assert feats.shape == (B, cfg.d_feat) and feats.dtype == torch.float32
    close(feats, jmodel.extract_features(jcfg, jparams, jb(batch)), REL[dtype])


def check_grad(arch, B, S):
    """One ``torch.autograd`` gradient of ``lm_loss`` against ``jax.grad``
    in fp32, leaf by leaf within 1e-4 of the largest reference gradient;
    returns the port's gradients and the reference's, each a {path: leaf}
    dict over the port's parameter tree."""
    jcfg, cfg, jparams, params = setup(arch)
    batch = batch_np(cfg, B, S)
    jgrads = jax.grad(lambda p: jmodel.lm_loss(jcfg, p, jb(batch)))(jparams)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(build_model(cfg).loss(params, tb(batch)), leaves)
    want = list(tree_leaves(want))
    scale = max(float(np.abs(np32(w)).max()) for w in want)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float(np.abs(np32(g) - np32(w)).max()) <= REL["float32"] * scale
    names = list(named_leaves(params))
    return dict(zip(names, grads)), dict(zip(names, want))


def check_own_consistency(arch, B, S, T):
    """Twin of ``tests/test_decode_consistency.py``: prefill + T decode steps
    reproduce the port's own full forward (fp32, rtol = atol = 2e-4)."""
    cfg = get_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = tb(batch_np(cfg, B, S + T, seed=3))
    toks, off = batch["tokens"], offset(cfg)
    logits, cache = model.prefill(params, dict(batch, tokens=toks[:, :S]), off + S + T)
    got = [logits]
    for i in range(T):
        logits, cache = model.decode_step(params, cache, toks[:, S + i:S + i + 1], off + S + i)
        got.append(logits)
    ref = model.forward(params, batch).logits[:, off + S - 1:]
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)


def check_serve(arch, B, S, gen):
    """``serve``'s greedy tokens (fp32) are the reference's prefill + decode
    loop's from the same parameters, prompts, patches and frames."""
    jcfg, cfg, jparams, params = setup(arch)
    batch = batch_np(cfg, B, S, seed=5)
    off = offset(cfg)
    extra = {k: torch.from_numpy(batch[k]) for k in ("patch_embeds", "audio_frames")
             if k in batch}
    res = serve_mod.serve(arch, gen=gen, verbose=False, device="cpu", dtype="float32",
                          params=params, prompts=torch.from_numpy(batch["tokens"]), **extra)
    fed = jb({k: v for k, v in batch.items() if k != "labels"})
    jlogits, jcache = jmodel.prefill(jcfg, jparams, fed, off + S + gen)
    tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        jlogits, jcache = jmodel.decode_step(jcfg, jparams, jcache, tok, jnp.int32(off + S + i))
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    assert res.tokens.shape == (B, gen)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(want, 1)))



def jax_params(tree) -> dict:
    """A port parameter tree (non-hybrid) as the reference's: each layer
    list stacked on a leading axis, jnp leaves."""
    return {k: jax.tree.map(lambda *ts: jnp.asarray(np.stack([np32(t) for t in ts])), *v)
            if k in ("layers", "enc_layers", "dec_layers")
            else jax.tree.map(lambda t: jnp.asarray(np32(t)), v) for k, v in tree.items()}


def cross_split_reference() -> dict:
    """The reference's unsharded prefill and teacher-forced decode logits of
    ``launch/dist_check.py``'s ``CROSS_SPLIT`` (Whisper's smoke, 3 kv heads)
    on ``seeded_factory(0)`` weights and ``cross_split_batch()``."""
    from repro_torch.launch import dist_check
    from repro_torch.sharding.shard import full_params, seeded_factory

    cs = dist_check.CROSS_SPLIT
    cfg = get_config(cs["arch"]).replace(**cs["overrides"])
    jcfg = jget_config(cs["arch"]).replace(**cs["overrides"])
    jparams = jax_params(full_params(cfg, seeded_factory(0), "cpu"))
    batch = dist_check.cross_split_batch()
    S0, T = cs["S0"], cs["T"]
    frames = jnp.asarray(batch["audio_frames"])
    toks = jnp.asarray(batch["tokens"].astype(np.int32))
    lg, cache = jax.jit(lambda p, t: jmodel.prefill(
        jcfg, p, {"tokens": t, "audio_frames": frames}, S0 + T))(jparams, toks[:, :S0])
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(jcfg, p, c, t, pos))
    dec = []
    for t in range(T):
        out, cache = step(jparams, cache, toks[:, S0 + t:S0 + t + 1], jnp.int32(S0 + t))
        dec.append(np.asarray(out))
    return {"prefill": np.asarray(lg), "decode": np.stack(dec), "frames": cfg.n_audio_frames}


def check_cross_split(results, model, want, rel=1e-5) -> None:
    """The ranks' runs of the cross-attention split over the frames
    (``results``, each rank's ``tp_job`` result in rank order, over
    ``model`` ranks a data group) against ``cross_split_reference()``:
    prefill and decode logits within ``rel`` of max|x|, and every decoder
    layer's cross (k, v) holding the rank's block of the frames."""
    for key, axis in (("prefill", 0), ("decode", 1)):
        got = np.concatenate([results[r][key] for r in range(0, len(results), model)], axis=axis)
        close(got, want[key], rel)
    for res in results:
        crossed = {p: s for p, s in res["cache_shapes"].items() if "/cross/" in p}
        assert crossed and all(s[1] == want["frames"] // model for s in crossed.values())


SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
# lm_loss's gradient in float64, by the port in torch.float64 and by the
# reference under jax_enable_x64, for each job: argv[1] the pickled {name:
# (arch, replacements, reference params, batch)}, argv[2] where to write
# {name: {"port": {path: grad}, "reference": {path: grad}}} over the port's
# tree, argv[3] the packages' source.  Each package casts to fp32 at fixed
# points (scores, norms, logits), so the name float32 of torch and of
# jax.numpy is bound to float64 before either package is imported
ORACLES = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, sys.argv[3])
import torch
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
torch.float32 = torch.float64  # the packages' fp32 casts, in float64
jnp.float32 = jnp.float64
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding.specs import map_with_path


def oracles(arch, over, params, batch):
    jcfg = jget_config(arch).replace(**dict(over, dtype="float64"))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    jb = {k: jnp.asarray(v) if v.dtype.kind == "i" else jnp.asarray(v, jnp.float64)
          for k, v in batch.items()}
    jg = jax.grad(lambda p: jmodel.lm_loss(jcfg, p, jb))(jp)
    # its compute dtype: torch.float32, float64 here
    cfg = get_config(arch).replace(**dict(over, dtype="float32"))
    tp = map_with_path(params_from_jax(cfg, params, device="cpu"),
                       lambda _, t: t.to(torch.float64))
    tb = {k: torch.as_tensor(v) if v.dtype.kind == "i" else torch.as_tensor(v, dtype=torch.float64)
          for k, v in batch.items()}
    tg = torch.func.grad(lambda p: build_model(cfg).loss(p, tb))(tp)
    out = {"port": {}, "reference": {}}
    map_with_path(tg, lambda path, t: out["port"].__setitem__("/".join(path), t.numpy()))
    # the reference's tree in the port's layout, float64 kept (params_from_jax
    # casts to fp32): its stacked layers unstacked
    depth = {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers,
             "dec_layers": cfg.n_layers}
    ref = {k: [jax.tree.map(lambda a: np.asarray(a)[i], v) for i in range(depth[k])]
           if k in depth else jax.tree.map(np.asarray, v) for k, v in jg.items()}
    map_with_path(ref, lambda path, t: out["reference"].__setitem__("/".join(path), t))
    return out


jobs = pickle.load(open(sys.argv[1], "rb"))
pickle.dump({name: oracles(*job) for name, job in jobs.items()}, open(sys.argv[2], "wb"))
'''


def start_float64_oracles(root, jobs) -> subprocess.Popen:
    """The subprocess of ``ORACLES`` on ``jobs`` ({name: (arch, replacements,
    the reference's params as numpy, batch)}), writing under the directory
    ``root``."""
    with open(os.path.join(root, "in.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    return subprocess.Popen([sys.executable, "-c", ORACLES, os.path.join(root, "in.pkl"),
                             os.path.join(root, "out.pkl"), SRC],
                            env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def float64_oracles(sub, root) -> dict:
    """{name: {"port": {path: gradient}, "reference": {...}}} from the
    subprocess ``sub`` that :func:`start_float64_oracles` started under
    ``root``."""
    _, err = sub.communicate(timeout=300)
    assert sub.returncode == 0, err[-3000:]
    with open(os.path.join(root, "out.pkl"), "rb") as f:
        return pickle.load(f)
