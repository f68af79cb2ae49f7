"""The port's flash attention against the reference's Pallas kernel.

On the CPU the port's wrapper runs its plain version
(``kernels/ref.py::flash_attention_ref``); the reference's
``flash_attention_pallas`` runs in interpret mode, as the reference's own
tests run it.  Inputs are drawn with numpy and rounded to bf16 the same way
on both sides.  Tolerances are the reference test's
(``tests/test_kernels.py``): 2e-5 in fp32 (the same fp32 softmax, summed in
another order) and 3e-2 in bf16 (the kernel takes its scores in fp32, the
plain version rounds them to bf16 first, and p is rounded to bf16 at
different running maxima).  The CUDA kernel is held against the plain
version on the card by ``test_torch_kernels.py`` (marked ``gpu``) and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models.attention import multihead_attention as jmultihead_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models.attention import multihead_attention  # noqa: E402

SHAPES = [
    (1, 128, 2, 2, 32),  # MHA
    (2, 256, 4, 2, 64),  # GQA
    (1, 384, 8, 1, 16),  # MQA, 3 tiles
    (1, 256, 4, 1, 256),  # recurrentgemma-9b's head width
    (1, 128, 2, 2, 48),  # a width the card runs on its 64-column instance
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# the reference's own bound between its kernel and its XLA attention
# (tests/test_kernels.py::test_flash_attention_matches_model_attention)
MODEL_ATTN_TOL = 2e-4


def _qkv(B, S, H, KV, hd, dtype, seed=0):
    r = np.random.default_rng(seed)
    arrs = [r.normal(size=(B, S, n, hd)).astype(np.float32) for n in (H, KV, KV)]
    port = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    ref = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    return port, ref


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,S,H,KV,hd", SHAPES)
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(B, S, H, KV, hd, window, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(B, S, H, KV, hd, dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", SHAPES)
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(B, S, H, KV, hd, window, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(B, S, H, KV, hd, dtype, seed=1)
    got = flash_attention_ref(q, k, v, causal=True, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 100])
def test_non_causal_plain_version_matches_pallas_kernel(window):
    (q, k, v), (jq, jk, jv) = _qkv(1, 256, 4, 2, 32, "float32", seed=2)
    got = ops.flash_attention(q, k, v, causal=False, window=window)
    want = flash_attention_pallas(jq, jk, jv, causal=False, window=window, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["float32"], atol=TOL["float32"])


def test_plain_version_matches_model_attention():
    """The same contract as the backbone's plain attention, in fp32."""
    (q, k, v), (jq, jk, jv) = _qkv(2, 256, 4, 2, 32, "float32", seed=3)
    pos = torch.arange(256)
    got = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(multihead_attention(q, k, v, pos, pos)),
                               rtol=MODEL_ATTN_TOL, atol=MODEL_ATTN_TOL)
    jpos = jnp.arange(256, dtype=jnp.int32)
    np.testing.assert_allclose(_f32(got), _f32(jmultihead_attention(jq, jk, jv, jpos, jpos)),
                               rtol=MODEL_ATTN_TOL, atol=MODEL_ATTN_TOL)


@pytest.mark.parametrize("S,window", [(200, None), (200, 64), (1, None), (130, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 48, 256])
def test_ragged_length_equals_padded_then_cropped(S, window, dtype, hd):
    """Any S: the rows of a ragged run are those of a 128-padded run (the
    only lengths the Pallas kernel takes), whatever the padding holds."""
    Sp = -(-S // 128) * 128
    (q, k, v), (jq, jk, jv) = _qkv(2, Sp, 4, 2, hd, dtype, seed=4)
    got = ops.flash_attention(q[:, :S].contiguous(), k[:, :S].contiguous(),
                              v[:, :S].contiguous(), causal=True, window=window)
    padded = ops.flash_attention(q, k, v, causal=True, window=window)[:, :S]
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window, interpret=True)[:, :S]
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(padded), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    (q, k, v), _ = _qkv(1, 64, 4, 2, 32, "float32")
    with pytest.raises(TypeError):  # mixed dtypes
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):  # neither bf16 nor fp32
        ops.flash_attention(q.half(), k.half(), v.half())
    (q3, k3, v3), _ = _qkv(1, 64, 3, 2, 32, "float32")
    with pytest.raises(ValueError, match="group"):  # H % KV != 0
        ops.flash_attention(q3, k3, v3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    for hd in (12, 264):  # not a multiple of 8; wider than 256
        (q5, k5, v5), _ = _qkv(1, 64, 4, 2, hd, "float32")
        with pytest.raises(ValueError, match="head width"):
            ops.flash_attention(q5, k5, v5)
    with pytest.raises(ValueError):  # k and v of different shapes
        ops.flash_attention(q, k, v[:, :32])
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)


@pytest.mark.parametrize("hd", [8, 16, 40, 64, 72, 128, 136, 200, 256])
def test_wrapper_takes_every_multiple_of_8_up_to_256(hd):
    """The contract the card's kernel takes: the plain version runs at each
    such width and agrees with the reference's oracle."""
    (q, k, v), (jq, jk, jv) = _qkv(1, 40, 2, 1, hd, "float32", seed=6)
    got = ops.flash_attention(q, k, v, causal=True, window=16)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=16)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["float32"], atol=TOL["float32"])


def test_private_launch_refuses_a_wrong_lse_buffer():
    """The lse buffer (chip_smoke.py's check of the kernel's row sums) is
    fp32 (B, H, S); anything else is refused before any build or launch."""
    (q, k, v), _ = _qkv(2, 64, 4, 2, 32, "bfloat16")
    for lse in (torch.empty(2, 64, 4), torch.empty(2, 4, 64, dtype=torch.bfloat16),
                torch.empty(2, 4, 128)[..., ::2]):
        with pytest.raises(ValueError, match="lse"):
            fa_mod._launch(q, k, v, True, None, lse)
    assert fa_mod.LIBRARY.lib is None


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    (q, k, v), _ = _qkv(1, 96, 4, 2, 32, "bfloat16")
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=40)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True, window=40))
    assert ops.flash_attention.launches == before
    assert fa_mod.LIBRARY.lib is None  # nothing was built or loaded
    assert fa_mod.LIBRARY.source.name == "flash_attention.cu" and fa_mod.LIBRARY.source.exists()
