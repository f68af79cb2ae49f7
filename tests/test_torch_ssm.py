"""The port's SSM family (``models/ssm.py``, ``layers.py``'s causal conv, the
``"ssm"`` block and ``mamba2-1.3b-smoke``) against the reference package on
the CPU.

Module-level parameters come from the reference's initializers through
``tree_from_jax``; inputs are drawn with numpy from a seed.  Module-level
tolerance: fp32 within 1e-5 of the largest reference value (summation
order only).  Model-level tolerances: ``tests/torch_families.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_families as fam  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, layers, ssm  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "mamba2-1.3b-smoke"
MODULE_REL = 1e-5
B, S, T = 2, 64, 4  # S spans two of the smoke config's 32-step chunks


def _close(got, want):
    fam.close(got, want, MODULE_REL)


def _ssm_setup(seed=0):
    jcfg = jget_config(ARCH).replace(dtype="float32")
    cfg = get_config(ARCH).replace(dtype="float32")
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _normal(shape, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# causal conv (twin of tests/test_layers.py::test_causal_conv_step_matches_sequence)
# ---------------------------------------------------------------------------


def test_causal_conv_apply_and_step_match_reference():
    C, W, Sc = 6, 4, 10
    jp = jlayers.causal_conv1d_init(jax.random.PRNGKey(3), C, W)
    jp = {"kernel": jp["kernel"], "bias": jnp.linspace(-0.5, 0.5, C)}  # a nonzero bias
    p = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jx, x = _normal((B, Sc, C), 1)
    y = layers.causal_conv1d_apply(p, x)
    _close(y, jlayers.causal_conv1d_apply(jp, jx))
    jstate, state = jnp.zeros((B, W - 1, C)), torch.zeros((B, W - 1, C))
    for t in range(Sc):
        jstate, jy = jlayers.causal_conv1d_step(jp, jstate, jx[:, t, :])
        state_out, y_t = layers.causal_conv1d_step(p, state, x[:, t, :])
        assert state_out is state  # shifted in place
        _close(y_t, jy)
        _close(state, jstate)
        np.testing.assert_allclose(y_t.numpy(), y[:, t].numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# SSD (twins of tests/test_layers.py's SSD tests)
# ---------------------------------------------------------------------------


def _naive_ssd(x, a, Bm, Cm):
    """Direct recurrence oracle: h_t = exp(a_t)·h_{t-1} + B_t x_tᵀ; y = C·h."""
    Bn, Sn, H, P = x.shape
    h = np.zeros((Bn, H, P, Bm.shape[-1]))
    ys = []
    for t in range(Sn):
        h = h * np.exp(a[:, t])[:, :, None, None] + np.einsum("bhn,bhp->bhpn", Bm[:, t], x[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", h, Cm[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("initial", [False, True], ids=["h0-none", "h0"])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, initial):
    Bn, Sn, H, P, N = 2, 16, 3, 4, 5
    jx, x = _normal((Bn, Sn, H, P), 0)
    ja, a = (v * 0.5 for v in _normal((Bn, Sn, H), 1))
    a, ja = -a.abs(), -jnp.abs(ja)
    jBm, Bm = _normal((Bn, Sn, H, N), 2)
    jCm, Cm = _normal((Bn, Sn, H, N), 3)
    jh0, h0 = _normal((Bn, H, P, N), 4) if initial else (None, None)
    y, h = ssm.ssd_chunked(x, a, Bm, Cm, chunk, initial_state=h0)
    jy, jh = jssm.ssd_chunked(jx, ja, jBm, jCm, chunk, initial_state=jh0)
    _close(y, jy)
    _close(h, jh)
    if not initial:
        y_ref, h_ref = _naive_ssd(*(v.numpy().astype(np.float64) for v in (x, a, Bm, Cm)))
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-4, atol=1e-4)


def test_ssd_chunked_refuses_a_sequence_the_chunk_does_not_divide():
    x = torch.zeros((1, 20, 2, 3))
    with pytest.raises(ValueError, match="not divisible"):
        ssm.ssd_chunked(x, torch.zeros((1, 20, 2)), torch.zeros((1, 20, 2, 4)),
                        torch.zeros((1, 20, 2, 4)), 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_and_decode_match_reference(dtype):
    jcfg, cfg, jp, p = _ssm_setup()
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    rel = MODULE_REL if dtype == "float32" else fam.REL[dtype]
    jx, x = _normal((B, S, cfg.d_model), 5, 0.5)
    jx, x = jx.astype(dtype), x.to(getattr(torch, dtype))
    y, cache = ssm.ssm_apply(cfg, p, x, build_cache=True)
    jy, jcache = jssm.ssm_apply(jcfg, jp, jx, build_cache=True)
    assert y.dtype == x.dtype and cache["state"].dtype == torch.float32
    assert cache["conv"].dtype == x.dtype
    fam.close(y, jy, rel)
    for name in ("state", "conv"):
        fam.close(cache[name], jcache[name], rel)
    cache = {k: v.clone() for k, v in tree_from_jax(jax.tree.map(np.asarray, jcache),
                                                    device="cpu").items()}
    for t in range(T):
        ju, u = _normal((B, 1, cfg.d_model), 10 + t, 0.5)
        ju, u = ju.astype(dtype), u.to(getattr(torch, dtype))
        jy, jcache = jssm.ssm_decode_step(jcfg, jp, ju, jcache)
        y, out = ssm.ssm_decode_step(cfg, p, u, cache)
        assert out is cache
        fam.close(y, jy, rel)
        fam.close(cache["state"], jcache["state"], rel)
        fam.close(cache["conv"], jcache["conv"], rel)


def test_ssm_decode_matches_sequence():
    """Twin of tests/test_layers.py::test_ssm_decode_matches_sequence."""
    _, cfg, _, p = _ssm_setup()
    _, u = _normal((B, 12, cfg.d_model), 1, 0.5)
    _, u_ext = _normal((B, 3, cfg.d_model), 2, 0.5)
    _, cache = ssm.ssm_apply(cfg, p, u, build_cache=True)
    y_full, _ = ssm.ssm_apply(cfg, p, torch.cat([u, u_ext], 1))
    for t in range(3):
        y_t, cache = ssm.ssm_decode_step(cfg, p, u_ext[:, t:t + 1], cache)
        np.testing.assert_allclose(y_t[:, 0].numpy(), y_full[:, 12 + t].numpy(),
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the model (twins of the SSM cases of tests/test_models_smoke.py and
# tests/test_decode_consistency.py), against the reference
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_the_ssm_leaves():
    _, cfg, jparams, params = fam.setup(ARCH)
    assert len(params["layers"]) == cfg.n_layers
    layer = params["layers"][1]["ssm"]
    assert set(layer) == {"in_proj", "conv", "A_log", "dt_bias", "D", "norm_scale", "out_proj"}
    for name in ("A_log", "dt_bias", "D", "norm_scale"):
        np.testing.assert_array_equal(layer[name].numpy(),
                                      np.asarray(jparams["layers"]["ssm"][name][1]))
    np.testing.assert_array_equal(layer["conv"]["kernel"].numpy(),
                                  np.asarray(jparams["layers"]["ssm"]["conv"]["kernel"][1]))
    fresh = build_model(cfg).init(seed=0, device="cpu")
    assert tree_map(lambda t: t.shape, fresh) == tree_map(lambda t: t.shape, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    fam.check_forward(ARCH, dtype, B, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    fam.check_prefill_decode(ARCH, dtype, 16, S, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_features_match_reference(dtype):
    fam.check_loss_and_features(ARCH, dtype, B, S)


def test_gradient_matches_jax_grad():
    fam.check_grad(ARCH, B, 32)


def test_prefill_decode_matches_own_full_forward():
    fam.check_own_consistency(ARCH, 2, 16, 4)


def test_serve_gives_the_reference_loops_tokens():
    fam.check_serve(ARCH, 2, S, 6)


def test_make_cache_and_train_step():
    cfg = get_config(ARCH)
    cache = build_model(cfg).make_cache(3, 40, device="cpu")
    assert len(cache) == cfg.n_layers
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    assert cache[0]["state"].shape == (3, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
    assert cache[0]["state"].dtype == torch.float32 and not cache[0]["state"].any()
    assert cache[0]["conv"].shape == (3, cfg.ssm_conv - 1, conv_ch)
    assert cache[0]["conv"].dtype == torch.bfloat16
    # twin of tests/test_models_smoke.py: one SGD step, finite, no blow-up
    params = build_model(cfg).init(seed=0, device="cpu")
    batch = fam.tb(fam.batch_np(cfg, 2, 32))
    step = make_train_step(cfg, lr=0.05)
    params2, loss1 = step(params, batch)
    _, loss2 = step(params2, batch)
    assert bool(torch.isfinite(loss2)) and float(loss2) < float(loss1) + 0.5


def test_bf16_decode_gap_is_the_references():
    """In bf16 the recurrent decode and the chunked forward round apart (the
    chunked form rounds x·Δ, C·Bᵀ and its two partial outputs to bf16): the
    port's gap between prefill + decode and its own forward is the
    reference's gap on the same parameters and tokens, within twice it."""
    jcfg, cfg, jparams, params = fam.setup(ARCH, "bfloat16", n_layers=4)
    toks = fam.batch_np(cfg, B, S + 32, seed=9)["tokens"]
    Sp, n = S, 8

    def gap(prefill, decode, forward):
        logits, cache = prefill(toks[:, :Sp])
        got = [fam.np32(logits)]
        for i in range(n):
            logits, cache = decode(cache, toks[:, Sp + i:Sp + i + 1], Sp + i)
            got.append(fam.np32(logits))
        ref = fam.np32(forward(toks))[:, Sp - 1:Sp + n]
        return float(np.abs(np.stack(got, 1) - ref).max())

    jpre = jax.jit(lambda p, t: fam.jmodel.prefill(jcfg, p, {"tokens": t}, Sp + n))
    jdec = jax.jit(lambda p, c, t, pos: fam.jmodel.decode_step(jcfg, p, c, t, pos))
    jfwd = jax.jit(lambda p, t: fam.jmodel.forward(jcfg, p, {"tokens": t}).logits)
    want = gap(lambda t: jpre(jparams, jnp.asarray(t)),
               lambda c, t, pos: jdec(jparams, c, jnp.asarray(t), jnp.int32(pos)),
               lambda t: jfwd(jparams, jnp.asarray(t)))
    model = build_model(cfg)
    got = gap(lambda t: model.prefill(params, {"tokens": torch.from_numpy(t)}, Sp + n),
              lambda c, t, pos: model.decode_step(params, c, torch.from_numpy(t), pos),
              lambda t: model.forward(params, {"tokens": torch.from_numpy(t)}).logits)
    assert 0 < want and got <= 2 * want, (got, want)
