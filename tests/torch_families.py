"""Model-level checks of the port's SSM, hybrid and VLM families against the
reference package, on the CPU: shared by ``tests/test_torch_ssm.py``,
``test_torch_hybrid.py`` and ``test_torch_vlm.py`` (one file a family, so
that ``--dist loadfile`` spreads them).

Parameters come from the reference's ``init_params`` through
``params_from_jax``; tokens, labels and patch embeddings are drawn with
numpy from a seed.  Tolerances, relative to the largest reference value:

* fp32: 1e-4 (GEMM and scan summation order only);
* bf16: 3e-2 (both sides round at the same points, but the frameworks'
  bf16 GEMMs differ inside), and at least 97% of the argmaxes equal.
"""
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
from repro_torch.tree import tree_leaves

REL = {"float32": 1e-4, "bfloat16": 3e-2}
ARGMAX = 0.97


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


def close_logits(got, want, dtype) -> None:
    close(got, want, REL[dtype])
    if dtype == "bfloat16":
        agree = float((np32(got).argmax(-1) == np32(want).argmax(-1)).mean())
        assert agree >= ARGMAX, agree


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
    """Numpy tokens and labels (B, S), and a VLM's 0.1·N(0, 1) patches."""
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        b["patch_embeds"] = (0.1 * r.standard_normal((B, cfg.n_patches, cfg.d_model))
                             ).astype(np.float32)
    return b


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
    close_logits(got.logits, want.logits, dtype)
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
        assert set(c) == set(w)
        for name in c:
            assert c[name].dtype == w[name].dtype and c[name].shape == w[name].shape, name
            if name == "pos":
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
    close_logits(np.stack([np32(g) for g in got]), np.stack([np32(w) for w in want]), dtype)
    for c, w in zip(cache, cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), device="cpu")):
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
    in fp32, leaf by leaf within 1e-4 of the largest reference gradient."""
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
    loop's from the same parameters, prompts and patches."""
    jcfg, cfg, jparams, params = setup(arch)
    batch = batch_np(cfg, B, S, seed=5)
    off = offset(cfg)
    res = serve_mod.serve(arch, gen=gen, verbose=False, device="cpu", dtype="float32",
                          params=params, prompts=torch.from_numpy(batch["tokens"]),
                          patch_embeds=(torch.from_numpy(batch["patch_embeds"])
                                        if "patch_embeds" in batch else None))
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

