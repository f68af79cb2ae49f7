"""The port's ``launch/flops.py`` and ``launch/shapes.py`` against the
reference's, for every assigned architecture at full size and every input
shape: equal outputs, and nothing allocated (the port's parameters and
caches are built on the meta device).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as JASSIGNED  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import flops as jflops  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import flops, shapes  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

_ABSTRACT = {}


def _abstract(arch):
    """Both packages' abstract parameters of ``arch`` (shared by the shapes:
    a long_500k variant changes no parameter)."""
    if arch not in _ABSTRACT:
        _ABSTRACT[arch] = (jshapes.abstract_params(jget_config(arch)),
                           shapes.abstract_params(get_config(arch)))
    return _ABSTRACT[arch]


def _spec(s):
    return (tuple(s.shape), str(s.dtype).replace("torch.", ""))


def _per_layer(cfg, jcache):
    """The reference's abstract decode cache as the port's per-layer list:
    each stacked leaf without its leading n_layers (a hybrid's super-block
    and remainder trees in layer order)."""
    if cfg.arch_type != "hybrid":
        n = next(iter(jax.tree.leaves(jcache))).shape[0]
        one = jax.tree.map(lambda s: (tuple(s.shape[1:]), s.dtype.name), jcache)
        return [one] * n
    pat, nb = cfg.block_pattern, cfg.n_superblocks
    out = []
    for layer, kind in enumerate(cfg.pattern_for(cfg.n_layers)):
        r = layer - nb * len(pat)
        if r < 0:
            tree = jcache["super"][f"b{layer % len(pat)}_{kind}"]
            out.append(jax.tree.map(lambda s: (tuple(s.shape[1:]), s.dtype.name), tree))
        else:
            out.append(jax.tree.map(lambda s: (tuple(s.shape), s.dtype.name),
                                    jcache["rem"][f"rem{r}_{kind}"]))
    return out


def test_assigned_archs_and_shapes_are_the_references():
    assert ASSIGNED_ARCHS == JASSIGNED
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert shapes.LONG_500K_SKIPS == jshapes.LONG_500K_SKIPS
    assert shapes.NATIVE_SUBQUADRATIC == jshapes.NATIVE_SUBQUADRATIC
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_and_flops_equal_the_references(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sh, jsh = INPUT_SHAPES[shape], JSHAPES[shape]
    variant, jvariant = shapes.variant_for(cfg, sh), jshapes.variant_for(jcfg, jsh)
    if jvariant is None:
        assert variant is None and arch == "whisper-large-v3" and shape == "long_500k"
        return
    assert dataclasses.asdict(variant) == dataclasses.asdict(jvariant)

    specs, jspecs = shapes.input_specs(variant, sh), jshapes.input_specs(jvariant, jsh)
    assert list(specs) == list(jspecs)
    if sh.kind == "decode":
        assert _spec(specs["token"]) == _spec(jspecs["token"])
        assert _spec(specs["pos"]) == _spec(jspecs["pos"])
        got = [jax.tree.map(_spec, layer, is_leaf=lambda s: isinstance(s, shapes.TensorSpec))
               for layer in specs["cache"]]
        assert got == _per_layer(jvariant, jspecs["cache"])
    else:
        batch, jbatch = specs["batch"], jspecs["batch"]
        assert list(batch) == list(jbatch)
        assert {k: _spec(v) for k, v in batch.items()} == {k: _spec(v) for k, v in jbatch.items()}

    jparams, params = _abstract(arch)
    assert {t.device.type for t in tree_leaves(params)} == {"meta"}  # no storage
    pb, jpb = flops.param_breakdown(variant, params), jflops.param_breakdown(jvariant, jparams)
    assert pb == jpb
    assert flops.model_flops(variant, sh, params) == jflops.model_flops(jvariant, jsh, jparams)


def test_whisper_counts_and_meta_params():
    """whisper-large-v3: 1,577,661,440 parameters (dec_layers 839.6 M,
    enc_layers 629.6 M, embed 66.5 M, dec_pos 41.9 M); the abstract tree
    has the shapes of the real one at the smoke width."""
    params = shapes.abstract_params(get_config("whisper-large-v3"))
    n = {k: sum(t.numel() for t in tree_leaves(v)) for k, v in params.items()}
    assert sum(n.values()) == 1_577_661_440
    assert round(n["dec_layers"] / 1e6, 1) == 839.6 and round(n["enc_layers"] / 1e6, 1) == 629.6
    assert n["embed"] == 51_968 * 1280 and n["dec_pos"] == 32_768 * 1280
    from repro_torch.models import build_model

    cfg = get_config("whisper-large-v3-smoke")
    real = build_model(cfg).init(seed=0, device="cpu")
    meta = shapes.abstract_params(cfg)
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(meta)] == [
        (tuple(t.shape), t.dtype) for t in tree_leaves(real)]
    cache = shapes.input_specs(cfg, INPUT_SHAPES["decode_32k"])["cache"]
    k, v = cache[0]["cross"]
    assert k == v == shapes.TensorSpec((128, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd),
                                       torch.bfloat16)
    assert np.prod(cache[0]["self"]["k"].shape) == 128 * 32_768 * cfg.n_kv_heads * cfg.hd
