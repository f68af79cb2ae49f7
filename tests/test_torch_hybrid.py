"""The port's hybrid family (``models/rglru.py``, the ``"rec"`` block, the
hybrid stack and ``recurrentgemma-9b-smoke``) against the reference package
on the CPU.

Module-level parameters come from the reference's ``rglru_init`` through
``tree_from_jax``; inputs are drawn with numpy from a seed.  Module-level
tolerance: fp32 within 1e-5 of the largest reference value (the doubling
scan sums in another order than ``jax.lax.associative_scan``).  Model-level
tolerances: ``tests/torch_families.py``.  The model-level prompts are longer
than the smoke config's local window (32), so the windowed prefill and the
wrapping ring cache both run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_families as fam  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, rglru  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import cache_from_jax, tree_from_jax  # noqa: E402

ARCH = "recurrentgemma-9b-smoke"
MODULE_REL = 1e-5
B, S, T = 2, 40, 4


def _close(got, want):
    fam.close(got, want, MODULE_REL)


def _rec_setup(dtype="float32", seed=0):
    jcfg = jget_config(ARCH).replace(dtype=dtype)
    cfg = get_config(ARCH).replace(dtype=dtype)
    jp = jrglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _normal(shape, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# the RG-LRU (twin of tests/test_layers.py::test_rglru_scan_matches_loop)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sn", [1, 9, 64, 513])
@pytest.mark.parametrize("initial", [False, True], ids=["h0-none", "h0"])
def test_linear_scan_matches_reference_and_loop(Sn, initial):
    w = 16
    jla, la = _normal((B, Sn, w), 0, 0.1)
    la, jla = -la.abs(), -jnp.abs(jla)  # decays in (0, 1]
    jb, b = _normal((B, Sn, w), 1)
    jh0, h0 = _normal((B, w), 2) if initial else (None, None)
    h = rglru._linear_scan(la, b, h0)
    _close(h, jrglru._linear_scan(jla, jb, jh0))
    want, state = [], (h0.double() if initial else torch.zeros((B, w), dtype=torch.float64))
    for t in range(Sn):  # the recurrence, a step at a time, in float64
        state = torch.exp(la[:, t].double()) * state + b[:, t].double()
        want.append(state)
    np.testing.assert_allclose(h.numpy(), torch.stack(want, 1).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_and_decode_match_reference(dtype):
    jcfg, cfg, jp, p = _rec_setup(dtype)
    rel = MODULE_REL if dtype == "float32" else fam.REL[dtype]
    jx, x = _normal((B, S, cfg.d_model), 5, 0.5)
    jx, x = jx.astype(dtype), x.to(getattr(torch, dtype))
    y, cache = rglru.rglru_apply(cfg, p, x, build_cache=True)
    jy, jcache = jrglru.rglru_apply(jcfg, jp, jx, build_cache=True)
    assert y.dtype == x.dtype and cache["h"].dtype == torch.float32
    assert cache["conv"].dtype == x.dtype and cache["conv"].shape == (B, 3, cfg.lru_width)
    fam.close(y, jy, rel)
    for name in ("h", "conv"):
        fam.close(cache[name], jcache[name], rel)
    cache = tree_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    for t in range(T):
        ju, u = _normal((B, 1, cfg.d_model), 10 + t, 0.5)
        ju, u = ju.astype(dtype), u.to(getattr(torch, dtype))
        jy, jcache = jrglru.rglru_decode_step(jcfg, jp, ju, jcache)
        y, out = rglru.rglru_decode_step(cfg, p, u, cache)
        assert out is cache
        fam.close(y, jy, rel)
        fam.close(cache["h"], jcache["h"], rel)
        fam.close(cache["conv"], jcache["conv"], rel)


def test_rglru_decode_matches_sequence():
    _, cfg, _, p = _rec_setup()
    _, x = _normal((B, 9, cfg.d_model), 1, 0.5)
    _, x_ext = _normal((B, 2, cfg.d_model), 2, 0.5)
    _, cache = rglru.rglru_apply(cfg, p, x, build_cache=True)
    y_full, _ = rglru.rglru_apply(cfg, p, torch.cat([x, x_ext], 1))
    for t in range(2):
        y_t, cache = rglru.rglru_decode_step(cfg, p, x_ext[:, t:t + 1], cache)
        np.testing.assert_allclose(y_t[:, 0].numpy(), y_full[:, 9 + t].numpy(),
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the model (twins of the hybrid cases of tests/test_models_smoke.py and
# tests/test_decode_consistency.py), against the reference
# ---------------------------------------------------------------------------


def test_layers_carry_over_in_pattern_order():
    """Five layers = one (rec, rec, attn) super-block + two remainder rec
    layers: the port's list holds the reference's super and rem trees in
    layer order, its caches likewise."""
    jcfg, cfg, jparams, params = fam.setup(ARCH, n_layers=5)
    assert cfg.pattern_for(5) == ("rec", "rec", "attn", "rec", "rec")
    assert [("rec" in p, "attn" in p) for p in params["layers"]] == [
        (True, False), (True, False), (False, True), (True, False), (True, False)]
    sup, rem = jparams["layers"]["super"], jparams["layers"]["rem"]
    pairs = [(params["layers"][0]["rec"]["lambda"], sup["b0_rec"]["rec"]["lambda"][0]),
             (params["layers"][1]["rec"]["lambda"], sup["b1_rec"]["rec"]["lambda"][0]),
             (params["layers"][2]["attn"]["wq"], sup["b2_attn"]["attn"]["wq"][0]),
             (params["layers"][3]["rec"]["lambda"], rem["rem0_rec"]["rec"]["lambda"]),
             (params["layers"][4]["rec"]["w_a"], rem["rem1_rec"]["rec"]["w_a"])]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batch = fam.batch_np(cfg, B, S)
    _, jcache = fam.jmodel.prefill(jcfg, jparams, fam.jb(batch), S + T)
    cache = cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), device="cpu")
    assert [set(c) for c in cache] == [{"h", "conv"}] * 2 + [{"k", "v", "pos"}] + [
        {"h", "conv"}] * 2
    np.testing.assert_array_equal(cache[4]["h"].numpy(),
                                  np.asarray(jcache["rem"]["rem1_rec"]["h"]))
    np.testing.assert_array_equal(cache[2]["pos"].numpy(),
                                  np.asarray(jcache["super"]["b2_attn"]["pos"][0]))
    assert cache[2]["k"].shape[1] == cfg.local_window  # the ring: min(S + T, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    fam.check_forward(ARCH, dtype, B, S)


@pytest.mark.parametrize("dtype,n_layers", [("float32", 3), ("bfloat16", 3), ("float32", 5)])
def test_prefill_and_decode_match_reference(dtype, n_layers):
    fam.check_prefill_decode(ARCH, dtype, 16, S, T, n_layers=n_layers)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_features_match_reference(dtype):
    fam.check_loss_and_features(ARCH, dtype, B, S)


def test_gradient_matches_jax_grad():
    fam.check_grad(ARCH, B, S)


def test_embedding_scale_is_rounded_to_the_compute_dtype(monkeypatch):
    """√128 = 11.3137 rounds to 11.3125 in bf16 before it multiplies, as the
    reference's ``jnp.asarray(d ** 0.5, dtype)``: the stack's input is the
    reference's bits."""
    cfg = get_config(ARCH)
    seen = []
    real = tfm.apply_hybrid

    def spy(cfg_, layers, x, **kw):
        seen.append(x)
        return real(cfg_, layers, x, **kw)

    monkeypatch.setattr(tfm, "apply_hybrid", spy)
    params = build_model(cfg).init(seed=0, device="cpu")
    toks = torch.tensor([[3, 4, 5]])
    build_model(cfg).forward(params, {"tokens": toks})
    emb = params["embed"]["embedding"][toks].to(torch.bfloat16)
    want = jnp.asarray(fam.np32(emb), jnp.bfloat16) * jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16)
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(fam.np32(seen[0]), fam.np32(want))
    assert not torch.equal(seen[0], (emb.float() * cfg.d_model ** 0.5).to(torch.bfloat16))


@pytest.mark.parametrize("S_own", [16, 40])
def test_prefill_decode_matches_own_full_forward(S_own):
    fam.check_own_consistency(ARCH, 2, S_own, 4)


def test_prefill_routes_the_local_attention_through_the_kernel(monkeypatch):
    """Prefill calls ops.flash_attention once an attention layer, with the
    local window; decode and the train forward never do."""
    cfg = get_config(ARCH).replace(n_layers=6, dtype="float32")
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = fam.tb(fam.batch_np(cfg, B, S + 1))["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, S + 1)
    assert calls == [{"causal": True, "window": cfg.local_window}] * 2
    model.decode_step(params, cache, toks[:, S:], S)
    model.forward(params, {"tokens": toks})
    assert len(calls) == 2


def test_serve_gives_the_reference_loops_tokens():
    fam.check_serve(ARCH, 2, S, 6)


def test_make_cache_and_train_step():
    cfg = get_config(ARCH).replace(n_layers=4)
    cache = build_model(cfg).make_cache(3, 40, device="cpu")
    assert [set(c) for c in cache] == [{"h", "conv"}] * 2 + [{"k", "v", "pos"}] + [{"h", "conv"}]
    assert cache[0]["h"].shape == (3, cfg.lru_width) and cache[0]["h"].dtype == torch.float32
    assert cache[0]["conv"].shape == (3, 3, cfg.lru_width)
    assert cache[2]["k"].shape == (3, cfg.local_window, cfg.n_kv_heads, cfg.hd)
    cfg = get_config(ARCH)
    params = build_model(cfg).init(seed=0, device="cpu")
    batch = fam.tb(fam.batch_np(cfg, 2, 32))
    step = make_train_step(cfg, lr=0.05)
    params2, loss1 = step(params, batch)
    _, loss2 = step(params2, batch)
    assert bool(torch.isfinite(loss2)) and float(loss2) < float(loss1) + 0.5
