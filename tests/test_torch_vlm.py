"""The port's VLM family (``layers.py::mrope_angles``, ``model.py``'s
``vlm_positions_3d`` and patch prefix, and ``qwen2-vl-2b-smoke``) against
the reference package on the CPU.

Inputs are drawn with numpy from a seed.  Module-level tolerance: fp32
within 1e-5 of the largest reference value.  Model-level tolerances:
``tests/torch_families.py``.  Decode positions count the 16 patches of the
smoke config before the text.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_families as fam  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ARCH = "qwen2-vl-2b-smoke"
MODULE_REL = 1e-5
B, S, T = 2, 24, 4


# ---------------------------------------------------------------------------
# M-RoPE (twin of tests/test_layers.py::test_mrope_sections_sum)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,theta,sections", [(32, 1e4, (4, 6, 6)),
                                                (128, 1e6, (16, 24, 24))])
@pytest.mark.parametrize("batched", [False, True], ids=["(3,S)", "(3,B,S)"])
def test_mrope_angles_match_reference(hd, theta, sections, batched):
    shape = (3, B, 50) if batched else (3, 50)
    pos = np.random.default_rng(0).integers(0, 5000, shape).astype(np.int32)
    got = layers.mrope_angles(torch.from_numpy(pos), hd, theta, sections)
    want = jlayers.mrope_angles(jnp.asarray(pos), hd, theta, sections)
    assert got.shape == shape[1:] + (hd // 2,) and got.dtype == torch.float32
    fam.close(got, want, MODULE_REL)


def test_mrope_sections_must_cover_the_rotary_dims():
    ang = layers.mrope_angles(torch.zeros((3, 8), dtype=torch.int32), 32, 1e4, (4, 6, 6))
    assert ang.shape == (8, 16)
    with pytest.raises(ValueError, match="sections"):
        layers.mrope_angles(torch.zeros((3, 8), dtype=torch.int32), 32, 1e4, (4, 6, 5))


def test_equal_streams_are_the_plain_rope():
    """Text tokens carry one position in all three streams: their M-RoPE
    angles are the 1-D rotary angles."""
    pos = torch.arange(40)
    got = layers.mrope_angles(pos.expand(3, 40), 128, 1e6, (16, 24, 24))
    torch.testing.assert_close(got, layers.rope_angles(pos, 128, 1e6), rtol=0, atol=0)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-2b"])
def test_vlm_positions_match_reference(arch):
    from repro.models import model as jmodel

    cfg, jcfg = get_config(arch), jget_config(arch)
    idx = np.arange(cfg.n_patches + 37, dtype=np.int32)
    got = model_lib.vlm_positions_3d(cfg, torch.from_numpy(idx))
    want = np.asarray(jmodel.vlm_positions_3d(jcfg, jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    g = int(round(cfg.n_patches ** 0.5))
    assert got[:, cfg.n_patches].tolist() == [g, g, g]  # text continues after the grid
    for i in (0, 5, cfg.n_patches + 3):  # decode: one position at a time, on its own
        one = model_lib.vlm_positions_3d(cfg, torch.full((1,), int(i)))
        np.testing.assert_array_equal(one[:, 0].numpy(), want[:, i])


# ---------------------------------------------------------------------------
# the model (twins of the VLM cases of tests/test_models_smoke.py and
# tests/test_decode_consistency.py), against the reference
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_the_qkv_biases():
    _, cfg, jparams, params = fam.setup(ARCH)
    assert set(params) == {"embed", "final_norm", "layers"}  # tied embeddings
    attn = params["layers"][1]["attn"]
    assert set(attn) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    np.testing.assert_array_equal(attn["bv"].numpy(), np.asarray(jparams["layers"]["attn"]["bv"][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    fam.check_forward(ARCH, dtype, B, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    fam.check_prefill_decode(ARCH, dtype, 16, S, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_features_match_reference(dtype):
    fam.check_loss_and_features(ARCH, dtype, B, S)


def test_loss_and_features_read_the_text_positions_only():
    cfg = get_config(ARCH).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = fam.tb(fam.batch_np(cfg, B, S))
    out = model.forward(params, batch)
    text = out.logits[:, cfg.n_patches:].float()
    ce = (torch.logsumexp(text, -1)
          - torch.gather(text, -1, batch["labels"].long()[..., None])[..., 0]).mean()
    torch.testing.assert_close(model.loss(params, batch), ce)
    torch.testing.assert_close(model.extract_features(params, batch),
                               out.hidden[:, cfg.n_patches:].float().mean(1))


def test_gradient_matches_jax_grad():
    fam.check_grad(ARCH, B, S)


def test_prefill_decode_matches_own_full_forward():
    fam.check_own_consistency(ARCH, 2, 16, 4)


def test_serve_gives_the_reference_loops_tokens():
    fam.check_serve(ARCH, 2, S, 6)


def test_serve_draws_patches_and_offsets_the_cache():
    cfg = get_config(ARCH)
    from repro_torch.launch.serve import serve

    a = serve(ARCH, batch=2, prompt_len=8, gen=3, verbose=False, device="cpu")
    b = serve(ARCH, batch=2, prompt_len=8, gen=3, verbose=False, device="cpu")
    assert torch.equal(a.tokens, b.tokens)  # prompts and patches from the seed
    assert a.tokens.shape == (2, 3) and int(a.tokens.max()) < cfg.vocab_size
    cache = build_model(cfg).make_cache(2, cfg.n_patches + 8 + 3, device="cpu")
    assert cache[0]["k"].shape == (2, cfg.n_patches + 11, cfg.n_kv_heads, cfg.hd)


def test_train_step():
    cfg = get_config(ARCH)
    params = build_model(cfg).init(seed=0, device="cpu")
    batch = fam.tb(fam.batch_np(cfg, 2, 32))
    step = make_train_step(cfg, lr=0.05)
    params2, loss1 = step(params, batch)
    _, loss2 = step(params2, batch)
    assert bool(torch.isfinite(loss2)) and float(loss2) < float(loss1) + 0.5
