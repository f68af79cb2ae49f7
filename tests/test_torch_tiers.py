"""The port's host-tier aggregation trees against the reference, and on their own.

Twins ``tests/test_tiers.py``'s spec, host-tree, absorber, report and
pricing tests on the port (:mod:`repro_torch.federated.tiers`), on the CPU.
On grid-exact statistics an all-fp32 tree of ANY shape is a reassociation
of the flat sum — bitwise equal — while lossy tiers quantize exactly once
per boundary, so the tree matches a manual per-boundary roundtrip bit for
bit.  The :class:`TieredAbsorber`'s overlapped and blocking forms agree
bitwise with each other and with ``absorb_stats`` of the flat sum, and its
W agrees with the reference absorber's within tolerance.  The mesh-routed
forms run here on a one-rank world (the tree's all-reduce sums one rank,
bitwise the merge fold); ``tests/test_tiers.py:229-347`` on 4 ranks is
twinned in ``tests/test_torch_dist_engines.py``.

``obs_report``: the same snapshot JSON, read by both packages, gives the
same text.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fed3r as jfed3r  # noqa: E402
from repro.federated import tiers as jtiers  # noqa: E402
from repro.federated.compress import WireFormat as JWireFormat  # noqa: E402
from repro.federated.streaming_engine import StreamConfig as JStreamConfig  # noqa: E402
from repro.federated.streaming_engine import StreamingEngine as JStreamingEngine  # noqa: E402
from repro.federated.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import obs_report as jobs_report  # noqa: E402
from repro_torch.core import fed3r  # noqa: E402
from repro_torch.federated import compress  # noqa: E402
from repro_torch.federated.compress import WireFormat  # noqa: E402
from repro_torch.federated.costs import CostModel  # noqa: E402
from repro_torch.federated.dist import DistConfig  # noqa: E402
from repro_torch.federated.engine import shard_stats  # noqa: E402
from repro_torch.federated.streaming_engine import StreamConfig, StreamingEngine  # noqa: E402
from repro_torch.federated.telemetry import Telemetry  # noqa: E402
from repro_torch.federated.tiers import (  # noqa: E402
    TIER_WIRE_KINDS,
    AggregationTree,
    TierSpec,
    TieredAbsorber,
    mesh_tree,
    two_stage_tree,
)
from repro_torch.data.pipeline import pack_client_shards  # noqa: E402
from repro_torch.federated.engine import AccumulationEngine, EngineConfig  # noqa: E402
from repro_torch.launch import mesh, obs_report  # noqa: E402
from repro_torch.launch.world import single_rank_world  # noqa: E402

D, C, LAM = 16, 5, 0.1


def _grid(rng, shape):
    """Features on a 1/8 grid in [-2, 2]: fp32 partial Gram sums are EXACT
    at this scale, so any reduction order is bitwise identical."""
    return (rng.integers(-16, 17, size=shape) / 8.0).astype(np.float32)


def _leaf_payloads(k, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [
        fed3r.client_stats(torch.as_tensor(_grid(rng, (n, D))),
                           torch.as_tensor(rng.integers(0, C, size=n).astype(np.int32)), C)
        for _ in range(k)
    ]


def _flat_sum(payloads):
    return fed3r.merge(*payloads)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# spec validation
# ---------------------------------------------------------------------------


def test_tierspec_validation():
    with pytest.raises(ValueError):
        TierSpec("edge", fan_in=0)
    with pytest.raises(ValueError):
        TierSpec("edge", fan_in=2, staleness=-1)
    with pytest.raises(ValueError):
        TierSpec("edge", fan_in=2, bandwidth=0.0)
    # sketch is a client-uplink format, not a tier-boundary format
    with pytest.raises(ValueError):
        TierSpec("edge", fan_in=2, wire=WireFormat(kind="sketch"))
    for kind in TIER_WIRE_KINDS:
        TierSpec("edge", fan_in=2, wire=WireFormat(kind=kind))
    assert TIER_WIRE_KINDS == jtiers.TIER_WIRE_KINDS


def test_tree_validation():
    with pytest.raises(ValueError):
        AggregationTree(())
    with pytest.raises(ValueError):  # duplicate tier names
        AggregationTree((TierSpec("a", fan_in=2), TierSpec("a", fan_in=2)))
    with pytest.raises(ValueError):  # duplicate mesh axes
        AggregationTree((
            TierSpec("a", fan_in=2, axis="data"),
            TierSpec("b", fan_in=2, axis="data"),
        ))
    tree = AggregationTree((
        TierSpec("edge", fan_in=3),
        TierSpec("region", fan_in=2),
        TierSpec("cloud", fan_in=2),
    ))
    assert tree.leaves == 12
    assert tree.lossy_wire is None
    with pytest.raises(ValueError):  # wrong leaf count
        tree.reduce(_leaf_payloads(5))


def test_two_stage_tree_matches_reduce_order():
    tree = two_stage_tree(("pod", "data"))
    # leaf tier on the INNERMOST axis — the two-stage psum order
    assert tree.axes == ("data", "pod")
    with pytest.raises(ValueError):
        two_stage_tree(())
    tree.validate_mesh_axes(("pod", "data"))
    with pytest.raises(ValueError):
        tree.validate_mesh_axes(("data", "pod"))


def test_lossy_wire_is_topmost_non_fp32():
    tree = AggregationTree((
        TierSpec("edge", fan_in=2, wire=WireFormat(kind="int8")),
        TierSpec("cloud", fan_in=2),
    ))
    assert tree.lossy_wire is not None and tree.lossy_wire.kind == "int8"
    assert AggregationTree((TierSpec("edge", fan_in=2),)).lossy_wire is None


def test_resolved_keeps_every_field():
    tree = AggregationTree((
        TierSpec("edge", fan_in=2, wire=WireFormat(kind="fp8", tile=32), bandwidth=3e9,
                 staleness=1),
        TierSpec("cloud", fan_in=3, wire=WireFormat(kind="int8"), staleness=2),
    ))
    assert tree.resolved() == tree  # fp8 is native here: nothing falls back


def test_collective_forms_wait_for_the_collective_half():
    """The reference's refusals (tests/test_tiers.py:233-245), and the
    collective forms on a one-rank world: ``mesh_tree`` of a 1-axis tier
    mesh, ``AggregationTree.psum`` and the tree-routed statistics engine,
    bitwise the merge fold (tests/test_tiers.py:248-271)."""
    tree = AggregationTree((TierSpec("data", fan_in=1, axis="data"),))
    with pytest.raises(ValueError):  # a tree routes the psum backend
        DistConfig(tree=tree)
    with pytest.raises(ValueError):  # no reduce axes for the tree to cover
        DistConfig(aggregation="psum", tree=tree)
    with pytest.raises(ValueError):  # merge is the single-process backend
        DistConfig(mesh=object())
    rng = np.random.default_rng(0)
    clients = [(_grid(rng, (8, D)), rng.integers(0, C, size=8).astype(np.int32))
               for _ in range(2)]
    packed = pack_client_shards(clients, 2)
    ref_eng = AccumulationEngine(EngineConfig(n_classes=C), device="cpu")
    ref = ref_eng.accumulate(ref_eng.init(D), packed)
    with single_rank_world("gloo", "cpu"):
        tiers = mesh.make_tier_host_mesh((1,), device_type="cpu")
        routed = mesh_tree(tiers)
        assert routed.axes == ("edge",) and routed.leaves == 1
        with pytest.raises(ValueError):  # the tree's axes must be the mesh's
            DistConfig(aggregation="psum", mesh=tiers, tree=tree)
        payload = {"A": torch.arange(4.0).reshape(2, 2), "n": torch.tensor(3.0)}
        summed = routed.psum(payload, tiers)
        eng = AccumulationEngine(EngineConfig(
            n_classes=C, dist=DistConfig(aggregation="psum", mesh=tiers, tree=routed)),
            device="cpu")
        acc = eng.accumulate(eng.init(D), pack_client_shards(clients, 2, mesh=tiers))
    assert torch.equal(summed["A"], payload["A"]) and torch.equal(summed["n"], payload["n"])
    assert torch.equal(acc.stats.A, ref.stats.A) and torch.equal(acc.stats.b, ref.stats.b)
    assert eng.dispatches == 1


def test_bandwidth_constants_equal_the_reference():
    assert (mesh.ICI_BW, mesh.DCN_BW, mesh.WAN_BW) == (jmesh.ICI_BW, jmesh.DCN_BW, jmesh.WAN_BW)
    assert mesh.TIER_BANDWIDTHS == jmesh.TIER_BANDWIDTHS
    assert TierSpec("e", fan_in=1).bandwidth == jtiers.TierSpec("e", fan_in=1).bandwidth


# ---------------------------------------------------------------------------
# fp32 trees are exact reassociations (bitwise)
# ---------------------------------------------------------------------------


def test_tree_reduce_bitwise_equals_flat_sum():
    payloads = _leaf_payloads(12)
    tree = AggregationTree((
        TierSpec("edge", fan_in=3),
        TierSpec("region", fan_in=2),
        TierSpec("cloud", fan_in=2),
    ))
    assert _bitwise(tree.reduce(payloads), _flat_sum(payloads))


def test_single_tier_tree_is_flat_fold():
    payloads = _leaf_payloads(6, seed=3)
    tree = AggregationTree((TierSpec("edge", fan_in=6),))
    assert _bitwise(tree.reduce(payloads), _flat_sum(payloads))


def test_fully_masked_leaves_are_exact_noops():
    rng = np.random.default_rng(7)
    x = torch.as_tensor(_grid(rng, (8, D)))
    y = torch.as_tensor(rng.integers(0, C, size=8).astype(np.int32))
    real = shard_stats(x, y, C, torch.ones(8))
    pad = shard_stats(x, y, C, torch.zeros(8))
    tree = AggregationTree((TierSpec("e", fan_in=2), TierSpec("c", fan_in=2)))
    out = tree.reduce([real, pad, pad, pad])
    assert _bitwise(out, real)


def test_int8_tier_quantizes_exactly_once_per_boundary():
    """A lossy tier must match the manual per-boundary fused
    dequantize-accumulate bit for bit (no double quantization)."""
    payloads = _leaf_payloads(4, seed=5)
    wire = WireFormat(kind="int8")
    tree = AggregationTree((
        TierSpec("edge", fan_in=2),  # exact lower fold
        TierSpec("cloud", fan_in=2, wire=wire),
    ))
    got = tree.reduce(payloads)
    mids = [fed3r.merge(payloads[0], payloads[1]), fed3r.merge(payloads[2], payloads[3])]

    def cross(acc, child):  # one roundtrip per 2-D matrix per boundary
        A = compress.matrix_roundtrip_add(acc.A, child.A, wire)
        b = compress.matrix_roundtrip_add(acc.b, child.b, wire)
        return child._replace(A=A, b=b, n=acc.n + child.n)

    zero = mids[0]._replace(A=torch.zeros_like(mids[0].A), b=torch.zeros_like(mids[0].b),
                            n=torch.zeros_like(mids[0].n))
    want = cross(cross(zero, mids[0]), mids[1])
    # n is a scalar sidecar: stays exact fp32, never quantized
    assert _bitwise((got.A, got.b, got.n), (want.A, want.b, mids[0].n + mids[1].n))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_lossy_tree_reduce_equals_reference(kind):
    """The same grid payloads through both packages' trees with a lossy
    middle tier: the sums agree within 1e-6 of max|·| (XLA may or may not
    contract the vmapped ``acc + q·s`` into one FMA; the port always does)
    and n exactly."""
    rng = np.random.default_rng(12)
    xs = [(_grid(rng, (12, D)), rng.integers(0, C, size=12).astype(np.int32)) for _ in range(8)]
    spec = [("edge", 2, "fp32"), ("region", 2, kind), ("cloud", 2, "fp32")]
    tree = AggregationTree(tuple(TierSpec(n, fan_in=k, wire=WireFormat(kind=w, tile=8))
                                 for n, k, w in spec))
    jtree = jtiers.AggregationTree(tuple(
        jtiers.TierSpec(n, fan_in=k, wire=JWireFormat(kind=w, tile=8)) for n, k, w in spec))
    got = tree.reduce([fed3r.client_stats(torch.as_tensor(x), torch.as_tensor(y), C)
                       for x, y in xs])
    # the reference's compiled arithmetic (eager JAX divides by 127 where
    # XLA multiplies by fl(1/127))
    want = jax.jit(lambda ps: jtree.reduce(ps, use_kernel=False))(
        [jfed3r.client_stats(jnp.asarray(x), jnp.asarray(y), C) for x, y in xs])
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * float(np.abs(w).max()))
    assert float(got.n) == float(want.n) == 96.0


# ---- property: any fan-in assignment, any leaf order, still the flat sum ---

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dependency
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    _PAYLOADS = _leaf_payloads(16, seed=11)

    @st.composite
    def tree_shapes(draw):
        fans = draw(
            st.lists(st.integers(1, 4), min_size=1, max_size=3).filter(
                lambda f: np.prod(f) <= 16
            )
        )
        leaves = int(np.prod(fans))
        order = draw(st.permutations(list(range(leaves))))
        return fans, order

    @settings(max_examples=25, deadline=None)
    @given(tree_shapes())
    def test_property_any_tree_any_order_bitwise(shape):
        fans, order = shape
        tree = AggregationTree(
            tuple(TierSpec(f"t{i}", fan_in=k) for i, k in enumerate(fans))
        )
        chosen = [_PAYLOADS[i] for i in order]
        assert _bitwise(tree.reduce(chosen), _flat_sum(chosen))


# ---------------------------------------------------------------------------
# TieredAbsorber (host tiers)
# ---------------------------------------------------------------------------

_HOST_TREE = AggregationTree((
    TierSpec("edge", fan_in=2),
    TierSpec("cloud", fan_in=2, staleness=1),
))


def _segments(s, leaves, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (
            _grid(rng, (leaves, n, D)),
            rng.integers(0, C, size=(leaves, n)).astype(np.int32),
            np.ones((leaves, n), np.float32),
        )
        for _ in range(s)
    ]


def _run_absorber(tree, segs, *, overlap, telemetry=None, cost_model=None):
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=LAM), device="cpu")
    ab = eng.tiered_absorber(tree, overlap=overlap, telemetry=telemetry, cost_model=cost_model)
    before = ab.dist.dispatches
    for f, l, m in segs:
        ab.absorb_segment(f, l, m)
    state = ab.drain()
    return state, ab.dist.dispatches - before


def _jtree(tree):
    return jtiers.AggregationTree(tuple(
        jtiers.TierSpec(t.name, fan_in=t.fan_in, wire=JWireFormat(kind=t.wire.kind,
                                                                  tile=t.wire.tile),
                        staleness=t.staleness)
        for t in tree.tiers))


def test_absorber_blocking_overlap_flat_bitwise():
    segs = _segments(4, _HOST_TREE.leaves)
    st_b, disp_b = _run_absorber(_HOST_TREE, segs, overlap=False)
    st_o, disp_o = _run_absorber(_HOST_TREE, segs, overlap=True)
    assert torch.equal(st_b.W, st_o.W)
    assert disp_b == len(segs)  # one blocking step per segment
    assert disp_o == 2 * len(segs)  # lower + upper per segment

    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=LAM), device="cpu")
    st = eng.init(D)
    for f, l, m in segs:
        s = shard_stats(torch.as_tensor(f).reshape(-1, D), torch.as_tensor(l).reshape(-1), C,
                        torch.as_tensor(m).reshape(-1))
        st = eng.absorb_stats(st, s.A, s.b, s.n)
    assert torch.equal(st.W, st_o.W) and torch.equal(st.L, st_o.L)
    assert st_o.wave == len(segs) and float(st_o.n) == float(st.n)


def test_absorber_int8_tier_paths_agree_bitwise():
    tree = AggregationTree((
        TierSpec("edge", fan_in=2),
        TierSpec("cloud", fan_in=2, wire=WireFormat(kind="int8"), staleness=2),
    ))
    segs = _segments(3, tree.leaves, seed=4)
    st_b, _ = _run_absorber(tree, segs, overlap=False)
    st_o, _ = _run_absorber(tree, segs, overlap=True)
    assert torch.equal(st_b.W, st_o.W)


@pytest.mark.parametrize("top_wire", ["fp32", "int8"])
def test_absorber_matches_reference_absorber(top_wire):
    """The port's edge/region/cloud absorber against the reference's on the
    same grid-exact segments: W within 1e-5 of max|W|."""
    tree = AggregationTree((
        TierSpec("edge", fan_in=2),
        TierSpec("region", fan_in=2),
        TierSpec("cloud", fan_in=2, wire=WireFormat(kind=top_wire, tile=8), staleness=1),
    ))
    segs = _segments(3, tree.leaves, seed=10)
    st, _ = _run_absorber(tree, segs, overlap=True)
    jeng = JStreamingEngine(JStreamConfig(n_classes=C, ridge_lambda=LAM, use_kernel=False))
    jab = jeng.tiered_absorber(_jtree(tree), overlap=True, telemetry=JTelemetry())
    for f, l, m in segs:
        jab.absorb_segment(f, l, m)
    jst = jab.drain()
    W, jW = st.W.numpy(), np.asarray(jst.W)
    np.testing.assert_allclose(W, jW, rtol=1e-5, atol=1e-5 * float(np.abs(jW).max()))
    assert float(st.n) == float(jst.n) and st.wave == int(jst.wave)


def test_absorber_fp8_tier_bitwise_and_finite():
    tree = AggregationTree((
        TierSpec("edge", fan_in=2, wire=WireFormat(kind="fp8", tile=8)),
        TierSpec("cloud", fan_in=2, staleness=1),
    ))
    segs = _segments(2, tree.leaves, seed=3)
    st_b, _ = _run_absorber(tree, segs, overlap=False)
    st_o, _ = _run_absorber(tree, segs, overlap=True)
    assert torch.equal(st_b.W, st_o.W) and bool(torch.isfinite(st_o.W).all())


def test_absorber_int8_launches_two_quant_pairs_per_child(monkeypatch):
    """The loop over children and groups: one quantize and one dequant call
    per child matrix crossing the int8 tier, one fed3r_stats per leaf."""
    from repro_torch.federated import engine as engine_mod

    calls = {"q": 0, "dq": 0, "stats": 0}
    q0, dq0, st0 = compress.quantize_tiles, compress.dequant_accumulate, engine_mod.fed3r_stats

    def q(*a, **k):
        calls["q"] += 1
        return q0(*a, **k)

    def dq(*a, **k):
        calls["dq"] += 1
        return dq0(*a, **k)

    def stats(*a, **k):
        calls["stats"] += 1
        return st0(*a, **k)

    monkeypatch.setattr(compress, "quantize_tiles", q)
    monkeypatch.setattr(compress, "dequant_accumulate", dq)
    monkeypatch.setattr(engine_mod, "fed3r_stats", stats)
    tree = AggregationTree((
        TierSpec("edge", fan_in=4),
        TierSpec("region", fan_in=2, wire=WireFormat(kind="int8", tile=8)),
        TierSpec("cloud", fan_in=2, wire=WireFormat(kind="int8", tile=8), staleness=1),
    ))
    segs = _segments(3, tree.leaves, seed=1)
    _run_absorber(tree, segs, overlap=True)
    # per segment: 4 children cross region, 2 cross cloud; A and b each
    assert calls == {"q": 3 * 2 * (4 + 2), "dq": 3 * 2 * (4 + 2), "stats": 3 * tree.leaves}


def test_absorber_staleness_budget_and_gauges():
    tel = Telemetry()
    segs = _segments(4, _HOST_TREE.leaves, seed=2)
    _run_absorber(_HOST_TREE, segs, overlap=True, telemetry=tel)
    snap = tel.snapshot()
    # ring depth 1: every segment after the first forces the oldest flush
    stale = [e for e in snap["events"] if e["kind"] == "tier_staleness_exceeded"]
    assert len(stale) == len(segs) - 1
    eff = {g["name"]: g["value"] for g in snap["gauges"]}
    assert eff["tier_overlap_efficiency"] == 1.0  # no absorb-path syncs

    tel2 = Telemetry()
    _run_absorber(_HOST_TREE, segs, overlap=False, telemetry=tel2)
    eff2 = {g["name"]: g["value"] for g in tel2.snapshot()["gauges"]}
    assert eff2["tier_overlap_efficiency"] == 0.0  # one sync per segment


def test_absorber_cost_model_drift_gauge():
    tel = Telemetry()
    cm = CostModel(b=1e6, d=D, C=C)
    segs = _segments(3, _HOST_TREE.leaves, seed=6)
    _run_absorber(_HOST_TREE, segs, overlap=False, telemetry=tel, cost_model=cm)
    drift = {g["name"]: g["value"] for g in tel.snapshot()["gauges"]}["tier_cost_model_drift"]
    assert 0.5 <= drift <= 2.0


def test_absorber_validation():
    eng = StreamingEngine(StreamConfig(n_classes=C, ridge_lambda=LAM), device="cpu")
    with pytest.raises(ValueError):  # mesh tiers route through DistConfig
        TieredAbsorber(eng, AggregationTree((TierSpec("data", fan_in=1, axis="data"),)))
    with pytest.raises(ValueError):  # overlap needs a staleness budget
        TieredAbsorber(eng, AggregationTree((TierSpec("edge", fan_in=2),)), overlap=True)
    with pytest.raises(ValueError):  # psum needs its axes (the reference's validation)
        StreamConfig(n_classes=C, ridge_lambda=LAM, dist=DistConfig(aggregation="psum"))
    wired = StreamingEngine(StreamConfig(
        n_classes=C, ridge_lambda=LAM, wire=WireFormat(kind="int8")
    ), device="cpu")
    with pytest.raises(ValueError):  # compression lives on the tiers
        TieredAbsorber(wired, _HOST_TREE, overlap=False)
    ab = eng.tiered_absorber(_HOST_TREE, overlap=False)
    assert isinstance(ab, TieredAbsorber)
    f, l, m = _segments(1, _HOST_TREE.leaves + 1)[0]
    with pytest.raises(ValueError):  # segment width != tree.leaves
        ab.absorb_segment(f, l, m)
    with pytest.raises(ValueError):
        ab.classifier()  # nothing absorbed yet


def test_obs_report_renders_tier_tree():
    tel = Telemetry()
    segs = _segments(2, _HOST_TREE.leaves, seed=8)
    _run_absorber(_HOST_TREE, segs, overlap=True, telemetry=tel)
    report = obs_report.render(tel.snapshot())
    assert "aggregation tree (leaf tier first):" in report
    assert "edge" in report and "cloud" in report


def test_merge_snapshot_carries_tier_counters():
    tel = Telemetry()
    segs = _segments(2, _HOST_TREE.leaves, seed=9)
    _run_absorber(_HOST_TREE, segs, overlap=False, telemetry=tel)
    parent = Telemetry()
    parent.merge_snapshot(tel.snapshot())
    parent.merge_snapshot(tel.snapshot())  # counters ADD across workers
    merged = {
        (c["name"], tuple(sorted(c["labels"].items()))): c["value"]
        for c in parent.snapshot()["counters"]
    }
    for c in tel.snapshot()["counters"]:
        key = (c["name"], tuple(sorted(c["labels"].items())))
        assert merged[key] == 2 * c["value"]


def test_tier_counters_equal_the_reference_absorbers():
    """Both absorbers meter the same crossings: the same tier counters,
    gauges and flight-recorder event kinds."""
    tree = AggregationTree((
        TierSpec("edge", fan_in=2),
        TierSpec("cloud", fan_in=2, wire=WireFormat(kind="int8"), staleness=1),
    ))
    segs = _segments(3, tree.leaves, seed=5)
    tel, jtel = Telemetry(), JTelemetry()
    _run_absorber(tree, segs, overlap=True, telemetry=tel, cost_model=CostModel(b=1e6, d=D, C=C))
    jeng = JStreamingEngine(JStreamConfig(n_classes=C, ridge_lambda=LAM, use_kernel=False))
    from repro.federated.costs import CostModel as JCostModel

    jab = jeng.tiered_absorber(_jtree(tree), overlap=True, telemetry=jtel,
                               cost_model=JCostModel(b=1e6, d=D, C=C))
    for f, l, m in segs:
        jab.absorb_segment(f, l, m)
    jab.drain()

    def tier_view(snap):
        counters = sorted((c["name"], sorted(c["labels"].items()), c["value"])
                          for c in snap["counters"] if c["name"].startswith("tier_"))
        gauges = sorted((g["name"], g["value"]) for g in snap["gauges"])
        kinds = [e["kind"] for e in snap["events"] if e["kind"].startswith("tier_")]
        return counters, gauges, kinds

    assert tier_view(tel.snapshot()) == tier_view(jtel.snapshot())


def _snapshot_of_a_run():
    """A snapshot with dispatches, tier counters, async chaos counters,
    gauges, spans and events, from the port's engines on the CPU."""
    from repro_torch.federated.arrivals import ChaosSpec, chaos_timeline, latency_profile
    from repro_torch.federated.async_engine import AsyncConfig, AsyncRoundEngine, \
        run_chaos_timeline
    from repro_torch.federated.telemetry import set_telemetry

    tel = Telemetry()
    prev = set_telemetry(tel)
    try:
        _run_absorber(_HOST_TREE, _segments(2, _HOST_TREE.leaves, seed=1), overlap=True,
                      telemetry=tel)
        payloads = _leaf_payloads(6, seed=2)
        cohorts = [[0, 1, 2], [3, 4, 5], [1, 4, 5]]
        events = chaos_timeline(cohorts, latency_profile(6, 0.3, seed=1),
                                ChaosSpec(duplicate=0.5, reorder=0.5, delay=0.3, seed=4))
        eng = AsyncRoundEngine(AsyncConfig(n_classes=C, ridge_lambda=LAM, cohort=3,
                                           staleness_rounds=1), device="cpu")
        run_chaos_timeline(eng, eng.init(D), cohorts, events, lambda c, r: payloads[c])
        tel.gauge("driver_wall_seconds", driver="test").set(0.125)
    finally:
        set_telemetry(prev)
    return tel.snapshot()


@pytest.mark.parametrize("events", [0, 5, 20])
def test_obs_report_equals_reference_on_the_same_snapshot(events):
    blob = json.dumps(_snapshot_of_a_run())
    snap, jsnap = json.loads(blob), json.loads(blob)
    got = obs_report.render(snap, events=events)
    assert got == jobs_report.render(jsnap, events=events)
    assert "aggregation tree (leaf tier first):" in got and "async_folded_total" in got
    assert obs_report._snapshot_prometheus(snap) == jobs_report._snapshot_prometheus(jsnap)


def test_obs_report_cli_equals_reference(tmp_path, capsys):
    path = tmp_path / "telemetry_tiers.json"
    path.write_text(json.dumps(_snapshot_of_a_run()))
    for flags in ([], ["--jsonl"], ["--events", "3"]):
        assert obs_report.main([str(path)] + flags) == 0
        got = capsys.readouterr().out
        assert jobs_report.main([str(path)] + flags) == 0
        assert got == capsys.readouterr().out


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------


def test_tiered_allreduce_two_fp32_tiers_match_two_stage():
    cm = CostModel(b=1e6, d=128, C=32)
    dp, pods = 16, 4
    tree = AggregationTree((
        TierSpec("data", fan_in=dp, bandwidth=50e9),
        TierSpec("pod", fan_in=pods, bandwidth=12.5e9),
    ))
    tiered = cm.tiered_allreduce(tree.as_cost_tiers())
    two = cm.two_stage_allreduce(dp, pods, ici_bw=50e9, dcn_bw=12.5e9)
    assert tiered["leaves"] == dp * pods
    assert tiered["total_s"] == pytest.approx(two["ici_s"] + two["dcn_s"])
    assert tiered["flat_allreduce_s"] == pytest.approx(two["flat_allreduce_s"])


def test_tiered_allreduce_single_leaf_is_free():
    cm = CostModel(b=1e6, d=64, C=16)
    priced = cm.tiered_allreduce(AggregationTree((TierSpec("edge", fan_in=1),)).as_cost_tiers())
    assert priced["leaves"] == 1
    assert priced["total_s"] == 0.0
    assert priced["flat_allreduce_s"] == 0.0


def test_tiered_allreduce_lossy_tier_shrinks_bytes():
    cm = CostModel(b=1e6, d=128, C=32)

    def total(wire):
        tree = AggregationTree((
            TierSpec("edge", fan_in=4),
            TierSpec("cloud", fan_in=4, wire=WireFormat(kind=wire), bandwidth=1.25e9),
        ))
        return cm.tiered_allreduce(tree.as_cost_tiers())["total_s"]

    assert total("int8") < total("fp32")


def test_as_cost_tiers_equals_reference():
    spec = [("edge", 4, "fp32", mesh.ICI_BW), ("region", 2, "int8", mesh.DCN_BW),
            ("cloud", 2, "fp8", mesh.WAN_BW)]
    tree = AggregationTree(tuple(TierSpec(n, fan_in=k, wire=WireFormat(kind=w), bandwidth=bw)
                                 for n, k, w, bw in spec))
    jtree = jtiers.AggregationTree(tuple(
        jtiers.TierSpec(n, fan_in=k, wire=JWireFormat(kind=w), bandwidth=bw)
        for n, k, w, bw in spec))
    assert tree.as_cost_tiers() == jtree.as_cost_tiers()
    assert tree.leaves == jtree.leaves == 16
