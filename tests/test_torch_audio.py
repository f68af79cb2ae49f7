"""The port's audio family (``layers.py::sinusoidal_positions``,
``attention.py::cross_attn_apply``, the ``"enc"`` and ``"dec"`` blocks, the
encoder-decoder forward and caches, and ``whisper-large-v3-smoke``) against
the reference package on the CPU.

Module-level parameters come from the reference's initializers through
``tree_from_jax``; inputs are drawn with numpy from a seed.  Module-level
tolerance: fp32 within 1e-5 of the largest reference value (summation
order only).  Model-level tolerances: ``tests/torch_families.py``.  The
smoke config has 2 encoder and 2 decoder layers, d 128 and 32 frames.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_families as fam  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import cache_from_jax, tree_from_jax  # noqa: E402

ARCH = "whisper-large-v3-smoke"
MODULE_REL = 1e-5
B, S, T = 2, 16, 4


def _close(got, want, rel=MODULE_REL):
    fam.close(got, want, rel)


def _normal(shape, seed, scale=1.0, dtype="float32"):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _block_setup(kind, dtype="float32", seed=0):
    jcfg = jget_config(ARCH).replace(dtype=dtype)
    cfg = get_config(ARCH).replace(dtype=dtype)
    jp = jtfm.block_init(jax.random.PRNGKey(seed), jcfg, kind)
    # nonzero biases and norm offsets, so the test sees where each one lands
    r = np.random.default_rng(seed + 10)
    jp = jax.tree.map(lambda a: a + 0.05 * r.standard_normal(a.shape).astype(np.float32)
                      if a.ndim <= 2 else a, jp)
    return jcfg, cfg, jp, tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(32, 128), (1500, 1280)])
def test_sinusoidal_positions_match_reference(n, d):
    """Each entry within 4 ulps of its argument plus 4 of its value (measured:
    2.0 at Whisper's (1500, 1280)): torch's exp and XLA's round the
    frequencies an ulp apart, which a position up to 1499 carries into an
    argument of up to 1499 rad, and sin/cos differ there by its ulp
    (1.2e-4), not by theirs."""
    got = layers.sinusoidal_positions(n, d)
    want = np.asarray(jlayers.sinusoidal_positions(n, d))
    assert got.shape == (n, d) and got.dtype == torch.float32
    half = d // 2
    inv = np.exp(-math.log(1e4) / (half - 1) * np.arange(half)).astype(np.float32)
    arg = np.tile(np.arange(n, dtype=np.float32)[:, None] * inv[None], (1, 2))
    ulps = np.abs(got.numpy() - want) / (np.spacing(arg) + np.spacing(np.abs(want)))
    assert float(ulps.max()) <= 4.0
    np.testing.assert_array_equal(got[0].numpy(), np.r_[np.zeros(half), np.ones(half)])


# ---------------------------------------------------------------------------
# attention: cross-attention, and the encoder's bidirectional self-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_apply_matches_reference(dtype):
    """First pass from the encoder states (k and v projected with their
    biases), then from the returned (k, v): the same output, the cache the
    reference's.  bf16 within 4 bf16 ulps of the largest output."""
    jcfg, cfg, jp, p = _block_setup("dec", dtype)
    jp, p = jp["cross_attn"], p["cross_attn"]
    rel = MODULE_REL if dtype == "float32" else 2.0 ** -6
    jx, x = _normal((B, S, cfg.d_model), 1, dtype=dtype)
    jenc, enc = _normal((B, cfg.n_audio_frames, cfg.d_model), 2, dtype=dtype)
    want, jkv = jattn.cross_attn_apply(jcfg, jp, jx, enc_states=jenc)
    got, kv = attention.cross_attn_apply(cfg, p, x, enc_states=enc)
    assert got.dtype == x.dtype and kv[0].shape == (B, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)
    _close(got, want, rel)
    _close(kv[0], jkv[0], rel)
    _close(kv[1], jkv[1], rel)
    again, kv2 = attention.cross_attn_apply(cfg, p, x, enc_kv=kv)
    assert kv2[0] is kv[0] and kv2[1] is kv[1]  # read, not projected again
    assert torch.equal(again, got)
    with pytest.raises(ValueError, match="enc_states"):
        attention.cross_attn_apply(cfg, p, x)


def test_plain_flash_with_causal_off_matches_the_reference_bidirectional_attention():
    """The flash kernel's plain version with causal off, at Whisper's 1500
    frames and head width 64 (a ragged last key tile on the card), against
    the reference's ``multihead_attention(bidirectional=True)``: fp32 within
    1e-5 of max|o|, MHA and GQA."""
    for H, KV in ((4, 4), (4, 2)):
        jq, q = _normal((1, 1500, H, 64), 3)
        jk, k = _normal((1, 1500, KV, 64), 4)
        jv, v = _normal((1, 1500, KV, 64), 5)
        pos = jnp.arange(1500, dtype=jnp.int32)
        want = jattn.multihead_attention(jq, jk, jv, pos, pos, bidirectional=True)
        got = flash_attention_ref(q, k, v, causal=False)
        _close(got, want)
        assert float((got - flash_attention_ref(q, k, v)).abs().max()) > 0.1  # causal differs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_enc_and_dec_blocks_match_reference_in_each_mode(dtype):
    """The ``"enc"`` block in train and prefill (the prefill through the
    kernel's plain version, causal off), the ``"dec"`` block in train,
    prefill (its ring and cross (k, v)) and two decode steps from the
    reference's cache: outputs and caches against the reference's
    ``block_apply``."""
    rel = MODULE_REL if dtype == "float32" else 2.0 ** -6
    jcfg, cfg, jp, p = _block_setup("enc", dtype)
    jx, x = _normal((B, cfg.n_audio_frames, cfg.d_model), 6, dtype=dtype)
    want, _, _ = jtfm.block_apply(jcfg, "enc", jp, jx, angles=None, window=None, mode="train")
    for mode in ("train", "prefill"):
        got, cache, aux = tfm.block_apply(cfg, "enc", p, x, angles=None, window=None, mode=mode)
        assert cache is None and aux is None
        _close(got, want, rel)

    jcfg, cfg, jp, p = _block_setup("dec", dtype, seed=1)
    jx, x = _normal((B, S + 2, cfg.d_model), 7, dtype=dtype)
    jenc, enc = _normal((B, cfg.n_audio_frames, cfg.d_model), 8, dtype=dtype)
    kw = dict(angles=None, window=None)
    want, _, _ = jtfm.block_apply(jcfg, "dec", jp, jx, mode="train", enc_states=jenc, **kw)
    got, cache, _ = tfm.block_apply(cfg, "dec", p, x, mode="train", enc_states=enc, **kw)
    assert cache is None
    _close(got, want, rel)
    jy, jcache, _ = jtfm.block_apply(jcfg, "dec", jp, jx[:, :S], mode="prefill",
                                     enc_states=jenc, cache_capacity=S + 2, **kw)
    y, cache, _ = tfm.block_apply(cfg, "dec", p, x[:, :S], mode="prefill", enc_states=enc,
                                  cache_capacity=S + 2, **kw)
    _close(y, jy, rel)
    assert set(cache) == {"self", "cross"} and isinstance(cache["cross"], tuple)
    assert torch.equal(cache["self"]["pos"], torch.from_numpy(np.array(jcache["self"]["pos"])))
    for got_c, want_c in ((cache["self"]["k"], jcache["self"]["k"]), (cache["cross"][1],
                                                                       jcache["cross"][1])):
        _close(got_c, want_c, rel)
    cache = tree_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    cross = cache["cross"]
    for i in range(2):
        jy, jcache, _ = jtfm.block_apply(jcfg, "dec", jp, jx[:, S + i:S + i + 1], mode="decode",
                                         cache=jcache, decode_pos=jnp.int32(S + i), **kw)
        y, cache, _ = tfm.block_apply(cfg, "dec", p, x[:, S + i:S + i + 1], mode="decode",
                                      cache=cache, decode_pos=S + i, **kw)
        _close(y, jy, rel)
        assert cache["cross"] is cross  # decode reads the cross (k, v), never projects them
    _close(cache["self"]["v"], jcache["self"]["v"], rel)


def test_encoder_prefill_routes_through_the_kernel_with_causal_off(monkeypatch):
    """A prefill calls ops.flash_attention once an encoder layer (causal
    off) and once a decoder layer (causal); decode, the train forward and
    the features never do."""
    cfg = get_config(ARCH).replace(dtype="float32")
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = fam.tb(fam.batch_np(cfg, B, S + 1))
    _, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :S]), S + 1)
    F = cfg.n_audio_frames
    assert calls == ([(F, {"causal": False, "window": None})] * cfg.n_encoder_layers
                     + [(S, {"causal": True, "window": None})] * cfg.n_layers)
    model.decode_step(params, cache, batch["tokens"][:, S:], S)
    model.forward(params, batch)
    model.extract_features(params, batch)
    assert len(calls) == cfg.n_encoder_layers + cfg.n_layers


# ---------------------------------------------------------------------------
# parameters and caches across the packages
# ---------------------------------------------------------------------------


def test_params_and_cache_from_jax_carry_the_audio_layout():
    jcfg, cfg, jparams, params = fam.setup(ARCH)
    assert set(params) == {"embed", "final_norm", "enc_layers", "enc_norm", "dec_layers",
                           "dec_pos"}  # tied embeddings
    assert len(params["enc_layers"]) == cfg.n_encoder_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    assert set(params["dec_layers"][0]) == {"norm1", "self_attn", "norm2", "cross_attn", "norm3",
                                            "mlp"}
    assert set(params["enc_layers"][0]["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    assert params["dec_pos"]["embedding"].shape == (cfg.n_positions, cfg.d_model)
    np.testing.assert_array_equal(params["enc_layers"][1]["mlp"]["w_up"].numpy(),
                                  np.asarray(jparams["enc_layers"]["mlp"]["w_up"][1]))
    np.testing.assert_array_equal(params["dec_layers"][1]["cross_attn"]["wk"].numpy(),
                                  np.asarray(jparams["dec_layers"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(params["enc_norm"]["bias"].numpy(),
                                  np.asarray(jparams["enc_norm"]["bias"]))

    jcfg, cfg = jget_config(ARCH), get_config(ARCH)  # bf16 caches
    jcache = jax.tree.map(np.array, jbuild_model(jcfg).make_cache(3, 12))  # writable copies
    jcache["cross"][0][1, 2] = 7.0
    jcache["self"]["pos"][1, 4] = 4
    cache = cache_from_jax(cfg, jcache, device="cpu")
    assert len(cache) == cfg.n_layers
    k, v = cache[1]["cross"]
    assert k.shape == (3, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd) and k.dtype == torch.bfloat16
    assert bool((k[2] == 7.0).all()) and not bool(k[:2].any()) and not bool(v.any())
    assert cache[1]["self"]["pos"].tolist() == [-1] * 4 + [4] + [-1] * 7
    assert cache[0]["self"]["pos"].dtype == torch.int32


def test_make_cache_builds_the_self_rings_and_the_cross_caches():
    cfg = get_config(ARCH)
    cache = build_model(cfg).make_cache(3, 40, device="cpu")
    assert len(cache) == cfg.n_layers
    for layer in cache:
        assert set(layer) == {"self", "cross"}
        assert layer["self"]["k"].shape == (3, 40, cfg.n_kv_heads, cfg.hd)
        assert bool((layer["self"]["pos"] == -1).all())
        for t in layer["cross"]:
            assert t.shape == (3, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)
            assert t.dtype == torch.bfloat16 and not bool(t.any())


# ---------------------------------------------------------------------------
# the model (twins of the audio cases of tests/test_models_smoke.py and
# tests/test_decode_consistency.py), against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    fam.check_forward(ARCH, dtype, B, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    fam.check_prefill_decode(ARCH, dtype, 16, S, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_features_match_reference(dtype):
    fam.check_loss_and_features(ARCH, dtype, B, S)


def test_gradient_matches_jax_grad_encoder_included():
    """Every leaf within 1e-4 of the largest reference gradient, and the
    encoder's own leaves within 1e-4 of the encoder's largest: its
    gradients reach it through the decoder blocks' cross-attention."""
    grads, want = fam.check_grad(ARCH, B, S)
    enc = [n for n in grads if n.startswith("enc_")]
    assert len(enc) == 2 * 15 + 2  # 15 leaves an encoder layer, and enc_norm's two
    scale = max(float(want[n].abs().max()) for n in enc)
    assert scale > 0
    for n in enc:
        assert float((grads[n] - want[n]).abs().max()) <= fam.REL["float32"] * scale, n


def test_train_step_moves_the_encoder_under_torch_func():
    """``make_train_step`` (``torch.func.grad`` through the block
    recompute) moves every encoder leaf the loss reaches and lowers nothing
    to NaN; the twin of the audio case of tests/test_models_smoke.py."""
    cfg = get_config(ARCH)
    params = build_model(cfg).init(seed=0, device="cpu")
    batch = fam.tb(fam.batch_np(cfg, 2, 32))
    step = make_train_step(cfg, lr=0.05)
    params2, loss1 = step(params, batch)
    _, loss2 = step(params2, batch)
    assert bool(torch.isfinite(loss2)) and float(loss2) < float(loss1) + 0.5
    for name in ("wq", "wk", "wv", "wo"):
        for layer in (0, cfg.n_encoder_layers - 1):
            before = params["enc_layers"][layer]["attn"][name]
            assert not torch.equal(before, params2["enc_layers"][layer]["attn"][name]), name


def test_prefill_decode_matches_own_full_forward():
    fam.check_own_consistency(ARCH, 2, 16, 4)


def test_serve_gives_the_reference_loops_tokens():
    fam.check_serve(ARCH, 2, S, 6)


def test_serve_draws_frames_from_the_seed():
    from repro_torch.launch.serve import serve

    cfg = get_config(ARCH)
    a = serve(ARCH, batch=2, prompt_len=8, gen=3, verbose=False, device="cpu")
    b = serve(ARCH, batch=2, prompt_len=8, gen=3, verbose=False, device="cpu")
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
    assert a.tokens.shape == (2, 3) and int(a.tokens.max()) < cfg.vocab_size
    frames = torch.zeros((2, cfg.n_audio_frames, cfg.d_model))
    c = serve(ARCH, batch=2, prompt_len=8, gen=3, verbose=False, device="cpu",
              audio_frames=frames)
    assert not torch.equal(c.logits, a.logits)  # the frames reach the decoder
