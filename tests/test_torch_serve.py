"""The port's dense serving path (prefill, KV ring caches, decode, ``serve``)
against the reference's, at ``qwen2-7b-smoke``.

Parameters come from the reference's ``init_params`` through
``params_from_jax`` (Qwen2's QKV biases and untied ``lm_head`` included);
tokens are drawn with numpy; the decode tests start both packages from one
cache (``cache_from_jax``).  On the CPU the prefill's attention runs the
flash kernel's plain version.  Tolerances, relative to the largest logit:

* fp32: 2e-4, the reference's own decode-consistency bound (measured gap
  ≤ 1e-6: GEMM summation order only);
* bf16: 4 bf16 ulps (2⁻⁶).  Both sides round at the same points, but a
  rounding can land on either side of a tie and the frameworks' bf16 GEMMs
  and softmax differ inside; measured ≤ 2 ulps (7.9e-3) over two layers;
* the int8 cache against the full forward: each cached value is off by up
  to half an int8 step (1/254 of its row's absmax); over two layers that
  moved the logits by ≤ 8.3e-3 of the largest; bound 2e-2.

The int8 cache is held against the JITTED reference: compiled, XLA turns
``absmax / 127`` into ``absmax · fl(1/127)``, which the port computes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.convert import cache_from_jax, params_from_jax  # noqa: E402

ARCH = "qwen2-7b-smoke"
B, S, T = 2, 16, 4
REL = {"float32": 2e-4, "bfloat16": 2.0 ** -6}
INT8_VS_FULL_REL = 2e-2


def _setup(dtype="float32", **kw):
    jcfg = jget_config(ARCH).replace(dtype=dtype, **kw)
    cfg = get_config(ARCH).replace(dtype=dtype, **kw)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    return jcfg, cfg, jparams, params, toks


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _jitted(jcfg, capacity):
    pre = jax.jit(lambda p, b: jmodel.prefill(jcfg, p, b, capacity))
    dec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(jcfg, p, c, t, pos))
    return pre, dec


def test_params_from_jax_carries_qwen2_biases_and_lm_head():
    _, cfg, jparams, params, _ = _setup()
    assert set(params) == {"embed", "final_norm", "lm_head", "layers"}
    assert len(params["layers"]) == cfg.n_layers
    attn = params["layers"][1]["attn"]
    assert set(attn) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    np.testing.assert_array_equal(attn["bk"].numpy(), np.asarray(jparams["layers"]["attn"]["bk"][1]))
    np.testing.assert_array_equal(params["lm_head"]["kernel"].numpy(),
                                  np.asarray(jparams["lm_head"]["kernel"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [{}, {"sliding_window": 8}], ids=["full", "window8"])
def test_prefill_logits_and_cache_match_reference(dtype, extra):
    jcfg, cfg, jparams, params, toks = _setup(dtype, **extra)
    jlogits, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])}, S + T)
    logits, cache = build_model(cfg).prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                                             S + T)
    assert logits.shape == (B, cfg.padded_vocab) and logits.dtype == getattr(torch, dtype)
    _close(logits, jlogits, REL[dtype])
    cap = min(S + T, extra.get("sliding_window") or S + T)
    assert len(cache) == cfg.n_layers
    for i, c in enumerate(cache):
        assert c["k"].shape == (B, cap, cfg.n_kv_heads, cfg.hd) and c["k"].dtype == logits.dtype
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jcache["pos"][i]))
        for name in ("k", "v"):
            _close(c[name], jcache[name][i], REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference_from_one_cache(dtype):
    jcfg, cfg, jparams, params, toks = _setup(dtype)
    _, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])}, S + T)
    cache = cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), device="cpu")
    assert cache[0]["k"].dtype == getattr(torch, dtype) and cache[0]["pos"].dtype == torch.int32
    model = build_model(cfg)
    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                             jnp.int32(S + i))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok), S + i)
        _close(logits, jlogits, REL[dtype])
    for i, c in enumerate(cache):  # the ring after T in-place writes
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jcache["pos"][i]))
        _close(c["k"], jcache["k"][i], REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_matches_jitted_reference(dtype):
    jcfg, cfg, jparams, params, toks = _setup(dtype, kv_cache_quant=True)
    jpre, jdec = _jitted(jcfg, S + T)
    jlogits, jcache = jpre(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    model = build_model(cfg)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])}, S + T)
    _close(logits, jlogits, REL[dtype])
    for i, c in enumerate(cache):
        assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.float32
        for name in ("k", "v"):
            step = np.abs(c[name].numpy().astype(np.int32) - np.asarray(jcache[name][i], np.int32))
            assert step.max() <= (0 if dtype == "float32" else 2)  # bf16 inputs may round apart
            _close(c[name + "_scale"], jcache[name + "_scale"][i], REL[dtype])
    # decode from the reference's own int8 cache
    pcache = cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), device="cpu")
    assert pcache[0]["k"].dtype == torch.int8
    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcache = jdec(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        logits, pcache = model.decode_step(params, pcache, torch.from_numpy(tok), S + i)
        _close(logits, jlogits, REL[dtype])


@pytest.mark.parametrize("extra,rel", [
    ({}, 2e-4),
    ({"sliding_window": 8}, 2e-4),
    ({"kv_cache_quant": True}, INT8_VS_FULL_REL),
], ids=["full", "window8", "int8"])
def test_prefill_decode_matches_own_full_forward(extra, rel):
    """The decode-consistency test's twin: prefill + T decode steps against
    one train-mode forward over all S + T tokens (ring capacity clamped to
    the window)."""
    _, cfg, _, params, toks = _setup("float32", **extra)
    if extra.get("sliding_window"):
        S_, T_ = 24, 6  # the reference's sliding-window case: the ring wraps
        toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S_ + T_))
    else:
        S_, T_ = S, T
    model = build_model(cfg)
    full = model.forward(params, {"tokens": torch.from_numpy(toks)}).logits
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S_])}, S_ + T_)
    if extra.get("sliding_window"):
        assert cache[0]["k"].shape[1] == 8
    _close(logits, full[:, S_ - 1], rel)
    for i in range(T_):
        logits, cache = model.decode_step(params, cache, torch.from_numpy(toks[:, S_ + i:S_ + i + 1]),
                                          S_ + i)
        _close(logits, full[:, S_ + i], rel)


def test_serve_greedy_tokens_equal_reference_loop():
    jcfg, cfg, jparams, params, toks = _setup("float32")
    prompts, gen = toks[:, :S], 6
    jpre, jdec = _jitted(jcfg, S + gen)
    jlogits, jcache = jpre(jparams, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        jlogits, jcache = jdec(jparams, jcache, tok, jnp.int32(S + i))
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    res = serve_mod.serve(ARCH, gen=gen, verbose=False, device="cpu", dtype="float32",
                          params=params, prompts=torch.from_numpy(prompts))
    np.testing.assert_array_equal(res.tokens.numpy(), np.concatenate(want, axis=1))
    assert res.tokens.shape == (B, gen) and res.peak_bytes is None
    assert res.logits.shape == (gen, B, cfg.vocab_size)
    assert torch.equal(res.logits.argmax(-1).T, res.tokens)
    assert res.prefill_launches == res.decode_launches == 0  # the CPU runs the plain version


def test_serve_draws_its_own_params_prompts_and_samples():
    cfg = get_config(ARCH)
    a = serve_mod.serve(ARCH, batch=3, prompt_len=9, gen=5, greedy=False, verbose=False,
                        device="cpu", seed=4)
    b = serve_mod.serve(ARCH, batch=3, prompt_len=9, gen=5, greedy=False, verbose=False,
                        device="cpu", seed=4)
    assert a.tokens.shape == (3, 5) and torch.equal(a.tokens, b.tokens)  # seeded
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < cfg.vocab_size
    assert a.tokens_per_s > 0


def test_prefill_routes_attention_through_the_kernel_once_a_layer(monkeypatch):
    """Prefill calls ops.flash_attention once a layer; decode and the
    train / feature forward never do."""
    _, cfg, _, params, toks = _setup("float32")
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    prefill = steps.make_prefill_step(cfg, cache_capacity=S + T)
    decode = steps.make_decode_step(cfg)
    _, cache = prefill(params, {"tokens": torch.from_numpy(toks[:, :S])})
    assert calls == [{"causal": True, "window": None}] * cfg.n_layers
    decode(params, cache, torch.from_numpy(toks[:, S:S + 1]), S)
    model = build_model(cfg)
    model.forward(params, {"tokens": torch.from_numpy(toks)})
    model.extract_features(params, {"tokens": torch.from_numpy(toks)})
    assert len(calls) == cfg.n_layers


def test_make_cache_builds_rings_and_whispers_cross_caches():
    cfg = get_config(ARCH).replace(sliding_window=8)
    cache = build_model(cfg).make_cache(3, 40, device="cpu")
    assert len(cache) == cfg.n_layers and cache[0]["k"].shape == (3, 8, cfg.n_kv_heads, cfg.hd)
    assert cache[0]["k"].dtype == torch.bfloat16 and bool((cache[0]["pos"] == -1).all())
    q = build_model(get_config(ARCH).replace(kv_cache_quant=True)).make_cache(1, 4, device="cpu")
    assert q[0]["k"].dtype == torch.int8 and q[0]["k_scale"].shape == (1, 4, cfg.n_kv_heads, 1)
    audio = get_config("whisper-large-v3-smoke")
    cache = model_lib.make_cache(audio, 3, 40, device="cpu")
    assert len(cache) == audio.n_layers
    ring, (k, v) = cache[0]["self"], cache[0]["cross"]
    assert ring["k"].shape == (3, 40, audio.n_kv_heads, audio.hd)
    assert bool((ring["pos"] == -1).all())
    assert k.shape == v.shape == (3, audio.n_audio_frames, audio.n_kv_heads, audio.hd)
    assert k.dtype == torch.bfloat16 and not bool(k.any())
    with pytest.raises(ValueError, match="arch_type"):
        model_lib.make_cache(get_config(ARCH).replace(arch_type="conv"), 1, 4, device="cpu")


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve(ARCH, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config(ARCH)).make_cache(1, 4)
