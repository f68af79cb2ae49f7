"""The port's sharding rules against the reference's, on abstract trees only.

Twins ``tests/test_sharding_rules.py`` (its six tests at ``AX = {model 16,
data 16, pod 2}`` over ``ASSIGNED_ARCHS`` × ``INPUT_SHAPES``) on the port's
parameter trees and caches, built on the meta device by
``launch/shapes.py`` (nothing allocated), and holds every leaf's spec equal
to the reference's: ``param_specs`` with and without FSDP for every
architecture, ``cache_specs`` at one decode shape a family, each port leaf
against the reference's stacked leaf with the stack dim dropped.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.shapes import abstract_params, input_specs, variant_for  # noqa: E402
from repro_torch.sharding.specs import (  # noqa: E402
    P,
    PartitionSpec,
    batch_specs,
    cache_specs,
    kv_cache_layout,
    param_specs,
)

AX = {"model": 16, "data": 16, "pod": 2}
_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = abstract_params(get_config(arch))
    return _PARAMS[arch]


def _axis_size(entry):
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        s = 1
        for a in entry:
            s *= AX[a]
        return s
    return AX[entry]


def _leaves(tree):
    """Leaves of a port tree: tensors, TensorSpecs and PartitionSpecs whole
    (``tree_leaves`` walks into tuples)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not (hasattr(tree, "shape") or _is_spec(tree)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _check_divisible(tree, specs):
    leaves = _leaves(tree)
    spec_leaves = _leaves(specs)
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        assert isinstance(spec, PartitionSpec)
        for dim, entry in zip(leaf.shape, tuple(spec)):
            assert dim % _axis_size(entry) == 0, (leaf.shape, spec)


def _is_spec(x):
    return isinstance(x, PartitionSpec)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_divisible(arch, fsdp):
    cfg = get_config(arch)
    params = _params(arch)
    specs = param_specs(cfg, params, AX, fsdp=fsdp)
    _check_divisible(params, specs)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_embedding_is_sharded_not_replicated(arch):
    cfg = get_config(arch)
    specs = param_specs(cfg, _params(arch), AX)
    emb_spec = specs["embed"]["embedding"]
    assert tuple(emb_spec) != (), f"{arch}: embedding replicated"


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-scout-17b-a16e"])
def test_moe_experts_expert_parallel(arch):
    cfg = get_config(arch)
    specs = param_specs(cfg, _params(arch), AX)
    wg = specs["layers"][0]["moe"]["w_gate"]  # (E, d, f): the reference's (L, E, d, f)
    assert all(tuple(layer["moe"]["w_gate"])[0] == "model" for layer in specs["layers"]), \
        "experts must shard on the E axis"
    assert tuple(wg) == ("model", None, None)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_batch_and_cache_specs_divisible(arch, shape_name):
    cfg = variant_for(get_config(arch), INPUT_SHAPES[shape_name])
    if cfg is None:
        pytest.skip("documented long_500k skip")
    shape = INPUT_SHAPES[shape_name]
    specs = input_specs(cfg, shape)
    da = ("data",)
    if "batch" in specs:
        _check_divisible(specs["batch"], batch_specs(cfg, specs["batch"], da, AX))
    if "cache" in specs:
        _check_divisible(specs["cache"], cache_specs(cfg, specs["cache"], da, AX))


def test_qwen2_head_fallback_row_parallel():
    """28 heads don't divide 16 → wq falls back to sharding d_model."""
    cfg = get_config("qwen2-7b")
    specs = param_specs(cfg, _params("qwen2-7b"), AX)
    wq = tuple(specs["layers"][0]["attn"]["wq"])  # (d, H, hd)
    assert wq[1] != "model" and wq[0] == "model"


def test_command_r_heads_shard_on_model():
    """96 q-heads divide 16 → primary head sharding is used."""
    cfg = get_config("command-r-plus-104b")
    specs = param_specs(cfg, _params("command-r-plus-104b"), AX)
    wq = tuple(specs["layers"][0]["attn"]["wq"])
    assert wq[1] == "model"


# ---------------------------------------------------------------------------
# leaf by leaf against the reference
# ---------------------------------------------------------------------------


def _ref_flat(tree, specs):
    """{key path: (shape, spec)} of the reference's abstract tree."""
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(paths) == len(spec_leaves)
    out = {}
    for (path, leaf), spec in zip(paths, spec_leaves):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = (tuple(leaf.shape), tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec))))
    return out


def _port_flat(tree, specs, prefix=()):
    """[(key path parts, shape, spec)] of the port's tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _port_flat(tree[k], specs[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [x for i, (t, s) in enumerate(zip(tree, specs))
                for x in _port_flat(t, s, prefix + (str(i),))]
    assert _is_spec(specs)
    return [(prefix, tuple(tree.shape), tuple(specs.full(len(tree.shape))))]


def _ref_key(cfg, parts):
    """The reference's key path of a port leaf, and whether the reference
    stacks it (a hybrid's layers live in super-blocks and a remainder)."""
    if parts[0] in ("layers", "enc_layers", "dec_layers") and parts[1].isdigit():
        i, rest = int(parts[1]), parts[2:]
        if cfg.arch_type == "hybrid":
            pat, nb = cfg.block_pattern, cfg.n_superblocks
            kind = cfg.pattern_for(cfg.n_layers)[i]
            r = i - nb * len(pat)
            if r < 0:
                return "/".join((parts[0], "super", f"b{i % len(pat)}_{kind}") + rest), True
            return "/".join((parts[0], "rem", f"rem{r}_{kind}") + rest), False
        return "/".join((parts[0],) + rest), True
    return "/".join(parts), False


def _stack_cache_key(cfg, parts):
    """The reference's key of a port cache leaf: layer i's leaf of the
    stacked cache (a hybrid's in its super-block or remainder tree)."""
    i, rest = int(parts[0]), parts[1:]
    if cfg.arch_type == "hybrid":
        pat, nb = cfg.block_pattern, cfg.n_superblocks
        kind = cfg.pattern_for(cfg.n_layers)[i]
        r = i - nb * len(pat)
        if r < 0:
            return "/".join(("super", f"b{i % len(pat)}_{kind}") + rest), True
        return "/".join(("rem", f"rem{r}_{kind}") + rest), False
    return "/".join(rest), True


def _assert_equal_leaf_by_leaf(port, ref, keyfn, cfg):
    seen = set()
    for parts, shape, spec in port:
        key, stacked = keyfn(cfg, parts)
        rshape, rspec = ref[key]
        if stacked:
            assert rshape[1:] == shape, (key, rshape, shape)
            rspec = rspec[1:]
        else:
            assert rshape == shape, (key, rshape, shape)
        assert spec == rspec, (key, spec, rspec)
        seen.add(key)
    assert seen == set(ref)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_equal_the_references_leaf_by_leaf(arch, fsdp):
    cfg, jcfg = get_config(arch), jget_config(arch)
    jparams = jshapes.abstract_params(jcfg)
    ref = _ref_flat(jparams, jspecs.param_specs(jcfg, jparams, AX, fsdp=fsdp))
    params = _params(arch)
    port = _port_flat(params, param_specs(cfg, params, AX, fsdp=fsdp))
    _assert_equal_leaf_by_leaf(port, ref, _ref_key, cfg)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-moe-16b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "qwen2-vl-2b", "whisper-large-v3"])
def test_cache_specs_equal_the_references_leaf_by_leaf(arch):
    """One decode shape a family (dense, MoE, SSM, hybrid, VLM, audio)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = INPUT_SHAPES["decode_32k"], JSHAPES["decode_32k"]
    jcache = jshapes.input_specs(jcfg, jshape)["cache"]
    ref = _ref_flat(jcache, jspecs.cache_specs(jcfg, jcache, ("data",), AX))
    cache = input_specs(cfg, shape)["cache"]
    port = _port_flat(cache, cache_specs(cfg, cache, ("data",), AX))
    _assert_equal_leaf_by_leaf(port, ref, _stack_cache_key, cfg)


def test_partition_spec_cuts_a_ranks_block():
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    sizes = {"data": 2, "model": 3, "pod": 2}
    spec = P(("pod", "data"), "model")
    got = spec.block(x, {"pod": 1, "data": 0, "model": 2}, sizes)
    assert torch.equal(got, x[2:3, 4:6])  # pod-major: (1, 0) is block 2 of 4
    assert P().block(x, {}, sizes) is x and P(None, None).is_replicated()
    assert spec.full(3) == (("pod", "data"), "model", None) and repr(P("model")) == "P('model')"
    with pytest.raises(ValueError, match="does not split"):
        P(None, None, "model").block(x[:, :, :7], {"model": 0}, sizes)


def test_kv_cache_layout_follows_the_fallback_chain():
    ax = {"data": 1, "model": 4}
    assert kv_cache_layout(4, 264, 8, 128, ("data",), ax) == "heads"  # llama4-scout on 4
    assert kv_cache_layout(4, 264, 2, 32, ("data",), ax) == "sequence"  # KV 2 < 4
    assert kv_cache_layout(4, 263, 2, 32, ("data",), ax) == "replicated"
