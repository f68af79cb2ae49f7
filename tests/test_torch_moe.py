"""The port's MoE family (``models/moe.py`` and the MoE stack) and the copied
configs, against the reference package on the CPU.

Parameters come from the reference's ``moe_init`` / ``init_params`` through
``tree_from_jax`` / ``params_from_jax``; inputs are drawn with numpy from a
seed.  Tolerances:

* fp32: 2e-4 of the largest output (the reference's own MoE and
  decode-consistency bound; measured ≤ 1e-6: summation order only), the
  load-balance loss within 1e-6;
* bf16 ``moe_apply``: 4 bf16 ulps (2⁻⁶) of max|y|, as the dense serving
  path's bf16 bound.  Both sides round at the same points, but the
  frameworks' bf16 GEMMs differ inside; measured 5.8e-3 to 6.1e-3 of
  max|y|.  The router logits are a bf16 product, so a rounding apart could
  route a token elsewhere; at these seeds both sides route alike.

Drops are part of the contract: at the configs' capacity factor the smoke
prefills drop entries, and the port drops the same ones.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import ARCH_MODULES, get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_from_jax  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402

MOE_ARCHS = ["deepseek-moe-16b-smoke", "llama4-scout-17b-a16e-smoke"]
COPIED = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "command-r-plus-104b",
          "deepseek-coder-33b", "minitron-8b", "mamba2-1.3b", "recurrentgemma-9b", "qwen2-vl-2b"]
REL = {"float32": 2e-4, "bfloat16": 2.0 ** -6}
B, S, T = 2, 16, 4


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


def _moe_setup(arch, dtype="float32", seed=0, **kw):
    jcfg = jget_config(arch).replace(dtype=dtype, **kw)
    cfg = get_config(arch).replace(dtype=dtype, **kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _x(cfg, shape, seed=1, scale=1.0, skew=0.0):
    """Normal inputs; ``skew`` adds one shared direction to every token, which
    routes most tokens to the same experts (and past their capacity)."""
    rng = np.random.default_rng(seed)
    x = scale * rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    x = x.astype(np.float32)
    jx = jnp.asarray(x).astype(cfg.dtype)
    return jx, torch.from_numpy(x).to(getattr(torch, cfg.dtype))


def _model_setup(arch, dtype="float32", **kw):
    jcfg = jget_config(arch).replace(dtype=dtype, **kw)
    cfg = get_config(arch).replace(dtype=dtype, **kw)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", COPIED)
def test_copied_config_equals_reference(arch, smoke):
    name = arch + "-smoke" if smoke else arch
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
    assert arch.replace("-", "_").replace(".", "_") in ARCH_MODULES


# ---------------------------------------------------------------------------
# moe_apply (twins of tests/test_layers.py's MoE tests, and the reference)
# ---------------------------------------------------------------------------


def test_moe_no_drop_matches_dense_sum():
    """With no dropping, scatter-dispatch == every expert on every token,
    weighted by the top k (rtol = atol = 2e-4, the reference test's)."""
    _, cfg, _, p = _moe_setup("deepseek-moe-16b-smoke", capacity_factor=16.0,
                              n_shared_experts=0)
    _, x = _x(cfg, (2, 8, cfg.d_model), scale=0.3)
    y, aux = moe.moe_apply(cfg, p, x)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    top_p, top_idx = moe.route_top_k(probs, cfg.top_k)
    g = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf, p["w_gate"]))
    u = torch.einsum("td,edf->tef", xf, p["w_up"])
    all_out = torch.einsum("tef,efd->ted", g * u, p["w_down"])
    ref = torch.zeros_like(xf)
    for kk in range(cfg.top_k):
        ref = ref + all_out[torch.arange(xf.shape[0]), top_idx[:, kk]] * top_p[:, kk, None]
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)
    assert float(aux) > 0.0


def test_moe_shared_expert_fusion():
    """The fused ``shared`` MLP of two experts == the sum of the two
    SwiGLU experts it concatenates (1e-5, the reference test's)."""
    _, cfg, _, p = _moe_setup("deepseek-moe-16b-smoke", n_shared_experts=2)
    sh, f = p["shared"], cfg.d_expert
    assert sh["w_gate"].shape == (cfg.d_model, 2 * f)
    _, x = _x(cfg, (5, cfg.d_model))
    swiglu = cfg.replace(mlp_type="swiglu")
    sep = sum(mlp_apply(swiglu, {"w_gate": sh["w_gate"][:, i * f:(i + 1) * f],
                                 "w_up": sh["w_up"][:, i * f:(i + 1) * f],
                                 "w_down": sh["w_down"][i * f:(i + 1) * f]}, x)
              for i in range(2))
    np.testing.assert_allclose(sep.numpy(), mlp_apply(swiglu, sh, x).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_moe_capacity_drops_tokens():
    """A tenth of the capacity (floored at 8 slots an expert: 32 of the 64
    entries) drops half the entries or more; y stays finite and the
    reference's."""
    jcfg, cfg, jp, p = _moe_setup("deepseek-moe-16b-smoke", capacity_factor=0.1)
    jx, x = _x(cfg, (2, 16, cfg.d_model))
    tally = moe.DropTally()
    y, aux = moe.moe_apply(cfg, p, x, tally)
    assert bool(torch.isfinite(y).all())
    assert tally.routed == 2 * 16 * cfg.top_k and tally.share() >= 0.5
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    _close(y, jy, REL["float32"])
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_top_k_ties_pick_the_reference_experts():
    """Planted equal router logits: the port takes the lower expert first,
    as jax.lax.top_k does, and the whole layer follows the reference."""
    jcfg, cfg, jp, p = _moe_setup("deepseek-moe-16b-smoke", n_experts=8, top_k=3,
                                  capacity_factor=8.0)
    # experts 2i and 2i+1 share a router column: every logit ties with one other
    r = np.asarray(jp["router"]).copy()
    r[:, 1::2] = r[:, 0::2]
    r[:, 6:] = r[:, 2:4]  # and experts 2, 3, 6, 7 all tie
    jp = dict(jp, router=jnp.asarray(r))
    p = dict(p, router=torch.from_numpy(r))
    jx, x = _x(cfg, (3, 10, cfg.d_model))
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    jprobs = jax.nn.softmax(jx.reshape(-1, cfg.d_model) @ jp["router"], -1)
    jtop_p, jtop_idx = jax.lax.top_k(jprobs, cfg.top_k)
    top_p, top_idx = moe.route_top_k(probs, cfg.top_k)
    # the ties are real: the k-th and (k+1)-th probabilities are equal on
    # every token, so the cut falls inside a tie
    srt = torch.sort(probs, -1, descending=True).values
    assert bool((srt[:, cfg.top_k - 1] == srt[:, cfg.top_k]).all())
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jtop_idx))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), rtol=1e-6)
    y, aux = moe.moe_apply(cfg, p, x)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    _close(y, jy, REL["float32"])
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [None, 8.0], ids=["default-capacity", "capacity-8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, cf, dtype):
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, cfg, jp, p = _moe_setup(arch, dtype, **kw)
    jx, x = _x(cfg, (4, 24, cfg.d_model), skew=1.0)
    tally = moe.DropTally()
    y, aux = moe.moe_apply(cfg, p, x, tally)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    assert y.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    if cf is None:
        assert tally.share() > 0  # the default capacity drops here
    else:
        assert tally.share() == 0
    _close(y, jy, REL[dtype])
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_drop_tally_sums_calls_and_stays_out_of_the_gradient():
    _, cfg, _, p = _moe_setup("deepseek-moe-16b-smoke", capacity_factor=0.5)
    _, x = _x(cfg, (2, 16, cfg.d_model))
    one, two = moe.DropTally(), moe.DropTally()
    moe.moe_apply(cfg, p, x, one)
    moe.moe_apply(cfg, p, x, two)
    moe.moe_apply(cfg, p, x)
    moe.moe_apply(cfg, p, x, two)
    assert one.routed == 2 * 16 * cfg.top_k and two.routed == 2 * one.routed
    assert int(two.dropped) == 2 * int(one.dropped) > 0 and two.share() == one.share()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="outside a gradient"):
        model.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                      drops=moe.DropTally())


# ---------------------------------------------------------------------------
# the MoE models against the reference
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_every_moe_leaf_bitwise():
    for arch in MOE_ARCHS:
        _, cfg, jparams, params = _model_setup(arch)
        jl = jparams["layers"]
        for i, layer in enumerate(params["layers"]):
            assert set(layer) == {"norm1", "attn", "moe", "norm2"}
            m, jm = layer["moe"], jl["moe"]
            assert set(m) == {"router", "w_gate", "w_up", "w_down", "shared"}
            assert m["w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_expert)
            assert m["w_down"].shape == (cfg.n_experts, cfg.d_expert, cfg.d_model)
            for name in ("router", "w_gate", "w_up", "w_down"):
                np.testing.assert_array_equal(m[name].numpy(), np.asarray(jm[name][i]))
            for name in ("w_gate", "w_up", "w_down"):
                np.testing.assert_array_equal(m["shared"][name].numpy(),
                                              np.asarray(jm["shared"][name][i]))


def test_init_params_builds_the_reference_layout():
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        params = build_model(cfg).init(seed=0, device="cpu")
        jparams = jax.eval_shape(
            lambda: jbuild_model(jget_config(arch)).init(jax.random.PRNGKey(0)))
        jl = jparams["layers"]
        layer = params["layers"][0]
        for name in ("router", "w_gate", "w_up", "w_down"):
            assert tuple(layer["moe"][name].shape) == tuple(jl["moe"][name].shape[1:])
            assert layer["moe"][name].dtype == torch.float32
        for name in ("w_gate", "w_up", "w_down"):
            assert tuple(layer["moe"]["shared"][name].shape) == \
                tuple(jl["moe"]["shared"][name].shape[1:])
        assert build_model(cfg).param_count(params) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_matches_reference(arch):
    """Forward logits and aux, lm_loss, extract_features, prefill and
    decode logits (fp32, 2e-4), at the configs' own capacity factor: the
    prefill drops entries on both sides."""
    jcfg, cfg, jparams, params = _model_setup(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    model = build_model(cfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    jout = jmodel.forward(jcfg, jparams, jb)
    out = model.forward(params, tb)
    _close(out.logits, jout.logits, REL["float32"])
    assert out.aux_loss.dtype == torch.float32
    assert abs(float(out.aux_loss) - float(jout.aux_loss)) <= 1e-6
    assert float(out.aux_loss) > 0
    loss = model.loss(params, tb)
    assert abs(float(loss) - float(jmodel.lm_loss(jcfg, jparams, jb))) <= 2e-4 * float(loss)
    _close(model.extract_features(params, tb), jmodel.extract_features(jcfg, jparams, jb),
           REL["float32"])

    jlogits, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])}, S + T)
    tally = moe.DropTally()
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])}, S + T,
                                  tally)
    assert tally.share() > 0
    _close(logits, jlogits, REL["float32"])
    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                             jnp.int32(S + i))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok), S + i)
        _close(logits, jlogits, REL["float32"])


def test_moe_gradients_through_the_recompute_match_reference(monkeypatch):
    """Train mode under a gradient wraps each MoE block in the recompute
    (x and the block's load-balance loss out); the gradients of lm_loss
    (aux included) are the reference's."""
    arch = MOE_ARCHS[0]
    jcfg, cfg, jparams, params = _model_setup(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    calls = []
    real = tfm._recomputed_block

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tfm, "_recomputed_block", counting)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    grads, loss = torch.func.grad_and_value(lambda pp: build_model(cfg).loss(pp, tb))(params)
    assert len(calls) == cfg.n_layers
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(lambda pp: jmodel.lm_loss(jcfg, pp, jb))(jparams)
    assert abs(float(loss) - float(jloss)) <= 2e-4 * float(jloss)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    for i, layer in enumerate(grads["layers"]):
        for name in ("router", "w_gate", "w_up", "w_down"):
            _close(layer["moe"][name], want["layers"][i]["moe"][name], 1e-4)
        _close(layer["moe"]["shared"]["w_down"], want["layers"][i]["moe"]["shared"]["w_down"],
               1e-4)
        _close(layer["attn"]["wq"], want["layers"][i]["attn"]["wq"], 1e-4)


# ---------------------------------------------------------------------------
# prefill + decode against the port's own full forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["command-r-plus-104b-smoke", "minitron-8b-smoke",
                                  "deepseek-coder-33b-smoke"] + MOE_ARCHS)
def test_prefill_decode_matches_own_full_forward(arch):
    """The twin of tests/test_decode_consistency.py: prefill + T decode
    steps against one train-mode forward (fp32, 2e-4), MoE at capacity
    factor 8 (no drops, as the reference test)."""
    extra = {"capacity_factor": 8.0} if "moe" in get_config(arch).arch_type else {}
    cfg = get_config(arch).replace(dtype="float32", **extra)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + T)))
    full = model.forward(params, {"tokens": toks}).logits
    logits, cache = model.prefill(params, {"tokens": toks[:, :S]}, S + T)
    _close(logits, full[:, S - 1], REL["float32"])
    for i in range(T):
        logits, cache = model.decode_step(params, cache, toks[:, S + i:S + i + 1], S + i)
        _close(logits, full[:, S + i], REL["float32"])


def test_the_copied_dense_configs_run_their_layer_types():
    """Command R+ runs parallel blocks with layernorm and tied embeddings,
    Minitron layernorm with the non-gated GELU MLP and an untied head."""
    c = get_config("command-r-plus-104b-smoke")
    p = build_model(c).init(seed=0, device="cpu")
    assert c.parallel_block and "norm2" not in p["layers"][0] and "lm_head" not in p
    assert set(p["layers"][0]["norm1"]) == {"scale", "bias"}
    m = get_config("minitron-8b-smoke")
    p = build_model(m).init(seed=0, device="cpu")
    assert set(p["layers"][0]["mlp"]) == {"w_up", "b_up", "w_down", "b_down"}
    assert "lm_head" in p


def test_serve_reports_the_reference_drop_share(monkeypatch):
    """serve's prefill drop share equals the share of (token, choice)
    entries the reference's prefill drops, counted by its own formulas on
    the inputs of each of its MoE layers; greedy tokens equal the
    reference loop's."""
    arch = MOE_ARCHS[0]
    # the reference's layers unrolled (not scanned): its MoE inputs are concrete
    jcfg, cfg, jparams, params = _model_setup(arch, scan_layers=False)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    seen = []
    real = jtfm.moe_mod.moe_apply

    def recording(c, p, x):
        seen.append((p["router"], x))
        return real(c, p, x)

    monkeypatch.setattr(jtfm.moe_mod, "moe_apply", recording)
    gen = 4
    jlogits, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompts)}, S + gen)
    prefill_inputs = list(seen)
    tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        jlogits, jcache = jmodel.decode_step(jcfg, jparams, jcache, tok, jnp.int32(S + i))
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    dropped = routed = 0
    for router, x in prefill_inputs:  # moe.py:57-93 with G = 1
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax((xf @ router.astype(x.dtype)).astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, jcfg.top_k)
        onehot = jax.nn.one_hot(idx.reshape(-1), jcfg.n_experts, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
        dropped += int(jnp.sum(pos >= jmoe._capacity(jcfg, xf.shape[0])))
        routed += int(pos.shape[0])
    assert len(prefill_inputs) == cfg.n_layers and dropped > 0
    res = serve_mod.serve(arch, gen=gen, verbose=False, device="cpu", dtype="float32",
                          params=params, prompts=torch.from_numpy(prompts))
    assert res.prefill_drop_share == dropped / routed
    np.testing.assert_array_equal(res.tokens.numpy(), np.concatenate(want, axis=1))
    dense = serve_mod.serve("qwen2-7b-smoke", batch=1, prompt_len=4, gen=2, verbose=False,
                            device="cpu")
    assert dense.prefill_drop_share is None
