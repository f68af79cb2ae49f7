"""The port's dense backbone against the reference's, at the smoke config.

Parameters come from the reference's ``init_params`` and are carried over
by ``params_from_jax``; activations are drawn with numpy.  Each comparison
runs once with ``dtype="float32"`` (both sides differ only in GEMM
summation order: tight tolerance) and once in the config's bf16 (both sides
round at the same points, but a bf16 rounding can land on either side of a
tie and the two frameworks' bf16 GELU/softmax kernels differ inside: a loose
tolerance of a few bf16 ulps, relative to the largest magnitude).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCH = "fed3r-mnv2-proxy-smoke"
# (dtype name, relative tolerance): fp32 GEMM reassociation vs bf16 (eps 2^-8)
DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


def _cfgs(dtype, **kw):
    return jget_config(ARCH).replace(dtype=dtype, **kw), get_config(ARCH).replace(dtype=dtype, **kw)


def _close(got, want, rel):
    got = np.asarray(torch.as_tensor(got).to(torch.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _x(shape, dtype, seed=0, scale=1.0):
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)), jnp.asarray(a, jnp.dtype(dtype))


@pytest.mark.parametrize("dtype,rel", DTYPES)
@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
def test_norm_apply(dtype, rel, norm_type):
    jcfg, cfg = _cfgs(dtype, norm_type=norm_type)
    r = np.random.default_rng(1)
    p = {"scale": r.normal(size=128).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = r.normal(size=128).astype(np.float32)
    x, jx = _x((2, 5, 128), dtype, scale=3.0)
    out = layers.norm_apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, x)
    assert out.dtype == x.dtype
    _close(out, jlayers.norm_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jx), rel)


@pytest.mark.parametrize("dtype,rel", DTYPES)
@pytest.mark.parametrize("mlp_type", ["gelu", "swiglu"])
def test_mlp_apply(dtype, rel, mlp_type):
    jcfg, cfg = _cfgs(dtype, mlp_type=mlp_type)
    p = jax.tree.map(np.array, jlayers.mlp_init(jax.random.PRNGKey(2), jcfg))
    if "b_up" in p:  # zero at init: give the bias add something to do
        p["b_up"] = p["b_up"] + 0.1
        p["b_down"] = p["b_down"] - 0.1
    x, jx = _x((2, 7, 128), dtype, seed=3)
    out = layers.mlp_apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, x)
    _close(out, jlayers.mlp_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jx), rel)


@pytest.mark.parametrize("dtype,rel", DTYPES)
def test_apply_rope(dtype, rel):
    x, jx = _x((2, 9, 4, 32), dtype, seed=4)
    ang = layers.rope_angles(torch.arange(9), 32, 10_000.0)
    jang = jlayers.rope_angles(jnp.arange(9), 32, 10_000.0)
    _close(ang, jang, 1e-6)
    _close(layers.apply_rope(x, ang), jlayers.apply_rope(jx, jang), rel)


@pytest.mark.parametrize("dtype,rel", DTYPES)
@pytest.mark.parametrize("kv,window,bidir", [(4, None, False), (2, None, False), (4, 3, False), (1, None, True)])
def test_multihead_attention(dtype, rel, kv, window, bidir):
    q, jq = _x((2, 11, 4, 16), dtype, seed=5)
    k, jk = _x((2, 11, kv, 16), dtype, seed=6)
    v, jv = _x((2, 11, kv, 16), dtype, seed=7)
    pos = np.arange(11, dtype=np.int32)
    out = attention.multihead_attention(q, k, v, torch.from_numpy(pos), torch.from_numpy(pos),
                                        window=window, bidirectional=bidir)
    want = jattn.multihead_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                                     window=window, bidirectional=bidir)
    _close(out, want, rel)


def test_multihead_attention_chunked_branch_equals_unchunked(monkeypatch):
    """Queries beyond 2·Q_CHUNK run chunk by chunk: the same rows."""
    q, _ = _x((1, 16, 2, 8), "float32", seed=8)
    k, _ = _x((1, 16, 2, 8), "float32", seed=9)
    v, _ = _x((1, 16, 2, 8), "float32", seed=10)
    pos = torch.arange(16)
    for window in (None, 5):
        whole = attention.multihead_attention(q, k, v, pos, pos, window=window)
        monkeypatch.setattr(attention, "Q_CHUNK", 4)
        chunked = attention.multihead_attention(q, k, v, pos, pos, window=window)
        monkeypatch.undo()
        torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,rel", DTYPES)
def test_extract_features(dtype, rel):
    jcfg, cfg = _cfgs(dtype)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    model = build_model(cfg)
    feats = model.extract_features(params, {"tokens": torch.from_numpy(toks)})
    want = jmodel.extract_features(jparams, {"tokens": jnp.asarray(toks)})
    assert feats.dtype == torch.float32 and feats.shape == (3, cfg.d_feat)
    _close(feats, want, rel)
    assert model.param_count(params) == jmodel.param_count(jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_masks_padded_vocab_with_a_scalar(dtype):
    """vocab 500 padded to 512: the padded columns are −1e30 (a Python
    scalar in ``torch.where``), bitwise the logits of the former host-built
    ``torch.tensor(-1e30)``, and the reference's."""
    jcfg, cfg = _cfgs(dtype, vocab_size=500)
    assert cfg.padded_vocab == 512 > cfg.vocab_size
    r = np.random.default_rng(3)
    emb = r.normal(size=(cfg.padded_vocab, 128)).astype(np.float32)
    x, jx = _x((2, 3, 128), dtype, seed=4)
    got = layers.unembed_apply(cfg, {"embed": {"embedding": torch.from_numpy(emb)}}, x)
    raw = x @ torch.from_numpy(emb).to(x.dtype).T
    col = torch.arange(raw.shape[-1])
    before = torch.where(col < cfg.vocab_size, raw, torch.tensor(-1e30, dtype=raw.dtype))
    assert got.dtype == x.dtype and torch.equal(got, before)
    want = jlayers.unembed_apply(jcfg, {"embed": {"embedding": jnp.asarray(emb)}}, jx)
    _close(got, want, dict(DTYPES)[dtype])
    assert np.array_equal(np.asarray(got[..., 500:].float()),
                          np.asarray(jnp.asarray(want[..., 500:], jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_blocks_recompute_bitwise_the_plain_gradients(dtype):
    """Under grad, train mode recomputes each block's activations in the
    backward: the loss and the gradients are bitwise those of the plain
    block loop, one client or vmapped over a cohort."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed_apply, norm_apply, rope_angles
    from repro_torch.tree import tree_leaves

    _, cfg = _cfgs(dtype)
    params = build_model(cfg).init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 2, 8)))

    def plain(p, t):
        x = embed_apply(p["embed"], t, getattr(torch, dtype))
        angles = rope_angles(torch.arange(t.shape[1]), cfg.hd, cfg.rope_theta)
        for layer in p["layers"]:
            x = transformer.block_apply(cfg, "attn", layer, x, angles=angles, window=None)[0]
        return norm_apply(cfg, p["final_norm"], x).float().square().mean()

    def recomputed(p, t):
        h = build_model(cfg).forward(p, {"tokens": t}, return_logits=False).hidden
        return h.float().square().mean()

    g1, l1 = torch.func.grad_and_value(plain)(params, toks[0])
    g2, l2 = torch.func.grad_and_value(recomputed)(params, toks[0])
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    v1 = torch.func.vmap(torch.func.grad(plain), in_dims=(None, 0))(params, toks)
    v2 = torch.func.vmap(torch.func.grad(recomputed), in_dims=(None, 0))(params, toks)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(v1), tree_leaves(v2)))
