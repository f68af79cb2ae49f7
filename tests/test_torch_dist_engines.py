"""The port's engines sharded over 4 gloo ranks on the CPU, against merge and the reference.

Twins ``tests/test_dist.py``'s four-engine psum == merge tests and the pod
mesh, ``tests/test_tiers.py:229-347`` (mesh-routed trees, the async engine
under a mesh tree) and ``tests/test_round_engine.py:300-330`` (the psum
round), and adds the async engine's flat psum and the int8 wire's psum
form (the statistics engine's partials, the stream's waves and a mesh
tree's int8 tier, each against the reference's quantizer).  One 4-rank
world (:func:`repro_torch.launch.world.run_world`) runs
:func:`repro_torch.launch.dist_check.engines_program`: every rank builds the
same grid-exact inputs from numpy seeds, runs each engine under
``DistConfig(aggregation="psum", mesh=...)`` on its block and the same
engine on the merge backend over everything, and returns both.

The contract, as the reference's: psum equals merge bitwise on grid-exact
inputs (any summation order is exact there), the round within rtol 1e-5
and atol 1e-6, personalized heads' α bitwise and W within 1e-5; every rank
holds the same bits; and each sharded result agrees with the REFERENCE's
merge engine on the same numpy inputs within fp32 tolerance (1e-5 of the
largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core import fed3r as jfed3r  # noqa: E402
from repro.data.pipeline import FederatedDataset as JFederatedDataset  # noqa: E402
from repro.data.pipeline import pack_arrival_waves as jpack_arrival_waves  # noqa: E402
from repro.data.pipeline import pack_client_shards as jpack_client_shards  # noqa: E402
from repro.data.pipeline import pack_cohort_batches as jpack_cohort_batches  # noqa: E402
from repro.data.pipeline import pack_personal_cohort as jpack_personal_cohort  # noqa: E402
from repro.federated import async_engine as jasync  # noqa: E402
from repro.federated import compress as jcompress  # noqa: E402
from repro.federated.algorithms import make_algorithm as jmake_algorithm  # noqa: E402
from repro.federated.arrivals import UploadEvent as JUploadEvent  # noqa: E402
from repro.federated.engine import AccumulationEngine as JAccumulationEngine  # noqa: E402
from repro.federated.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.federated.personalization import PersonalizationEngine as JPersEngine  # noqa: E402
from repro.federated.personalization import PersonalizeConfig as JPersConfig  # noqa: E402
from repro.federated.round_engine import RoundConfig as JRoundConfig  # noqa: E402
from repro.federated.round_engine import RoundEngine as JRoundEngine  # noqa: E402
from repro.federated.simulator import linear_head_task as jlinear_head_task  # noqa: E402
from repro.federated.simulator import pack_round as jpack_round  # noqa: E402
from repro.federated.streaming_engine import StreamConfig as JStreamConfig  # noqa: E402
from repro.federated.streaming_engine import StreamingEngine as JStreamingEngine  # noqa: E402
from repro_torch.launch import dist_check  # noqa: E402
from repro_torch.launch.dist_check import C, D, LAM, grid, grid_clients  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

WORLD = 4
PORT_REL = 1e-5  # port vs reference: fp32 reassociation, relative to max|x|


@pytest.fixture(scope="module")
def ranks():
    return run_world(dist_check.engines_program, WORLD, backend="gloo", device="cpu",
                     timeout_s=150)


def _same(a, b, keys):
    for k in keys:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _near_ref(got, want, rel=PORT_REL):
    want = np.asarray(want)
    assert float(np.abs(np.asarray(got) - want).max()) <= rel * float(np.abs(want).max())


def test_every_rank_holds_the_same_bits(ranks):
    for r in ranks[1:]:
        assert dist_check.digest(r) == dist_check.digest(ranks[0])


# ---------------------------------------------------------------------------
# the four engines: psum == merge on the sharded host mesh
# ---------------------------------------------------------------------------


def test_accumulation_engine_sharded_matches_merge_bitwise(ranks):
    out = ranks[0]["accumulate"]
    assert out["psum"]["dispatches"] == 1
    # exact grid features: the all-reduce cannot change a bit of A or b
    _same(out["psum"], out["merge"], ("A", "b", "counts", "n"))
    np.testing.assert_allclose(out["psum"]["W"], out["merge"]["W"], rtol=0, atol=1e-5)
    clients = grid_clients(3, [9, 3, 14, 6, 1, 11, 8, 4])
    jeng = JAccumulationEngine(JEngineConfig(n_classes=C))
    ref = jeng.accumulate(jeng.init(D), jpack_client_shards(clients, 2, max_n=16, num_shards=4))
    _near_ref(out["psum"]["A"], ref.stats.A)
    _near_ref(out["psum"]["b"], ref.stats.b)


JINT8 = jcompress.WireFormat(kind="int8", tile=8)  # engines_program's int8 wire
# the reference's wire as its engines run it: jitted, so XLA folds the
# scale's division by 127 into a product, as its kernel computes it
_jwire = jax.jit(jcompress.wire_roundtrip, static_argnames=("fmt", "use_kernel"))


def _blocks(packed, world=WORLD):
    """The reference's packed arrays cut into the ranks' blocks of dim 0."""
    k = packed.inputs.shape[0] // world
    return [type(packed)(*(a[r * k:(r + 1) * k] for a in packed)) for r in range(world)]


def test_int8_wire_crosses_the_all_reduce_once_a_rank(ranks):
    """Each rank's partial (its clients folded through the int8 wire, as
    merge folds them) crosses the all-reduce roundtripped once.  The
    expectation is the reference's: its merge engine under the int8 wire
    on each rank's block of shards, each result through its
    ``wire_roundtrip``, the four summed — within the ring's fp32
    reassociation of four terms."""
    out = ranks[0]["accumulate_int8"]
    packed = jpack_client_shards(grid_clients(3, [9, 3, 14, 6, 1, 11, 8, 4]), 2, max_n=16,
                                 num_shards=WORLD)
    jeng = JAccumulationEngine(JEngineConfig(n_classes=C, wire=JINT8))
    parts = [_jwire(*jeng.accumulate(jeng.init(D), blk).stats[:2], JINT8)
             for blk in _blocks(packed)]
    for i, k in enumerate(("A", "b")):
        want = np.asarray(sum(p[i] for p in parts))
        assert float(np.abs(out[k] - want).max()) <= 1e-6 * float(np.abs(want).max()), k
    assert not np.array_equal(out["A"], ranks[0]["accumulate"]["merge"]["A"])  # it quantized


def _jint8_psum_stream(waves, world=WORLD):
    """The reference's psum wave body under the int8 wire, one rank's block
    of every wave at a time: each rank's (S, ΔB) through ``wire_roundtrip``,
    the sum, G = L Lᵀ + S, the guarded Cholesky (its jitter sized by the
    reduced S, as the port's every rank sizes it), the refreshed W."""
    packed = jpack_arrival_waves(waves, num_shards=world)
    fac = jfed3r.init_factored(D, C, LAM)
    L, b = fac.L, fac.b
    for t in range(packed.inputs.shape[0]):
        k = packed.inputs.shape[1] // world
        S = dB = 0.0
        for r in range(world):
            blk = slice(r * k, (r + 1) * k)
            z, yh, _ = jfed3r.masked_design(jnp.asarray(packed.inputs[t, blk].reshape(-1, D)),
                                            jnp.asarray(packed.labels[t, blk].reshape(-1)), C,
                                            jnp.asarray(packed.mask[t, blk].reshape(-1)))
            Sr, dBr = _jwire(z.T @ z, z.T @ yh, JINT8)
            S, dB = S + Sr, dB + dBr
        L = jcompress.psd_cholesky(L @ L.T + S, jcompress.quant_spectral_bound(S, JINT8))
        b = b + dB
    return L, jfed3r.factored_solution(jfed3r.Fed3RFactored(L=L, b=b), True)


def test_int8_psum_stream_crosses_the_all_reduce_once_a_rank(ranks):
    """The stream's psum wave under the int8 wire: each rank's (S, ΔB)
    roundtripped once before the all-reduce, held against the reference's
    wave algebra on the same numpy inputs (fp32 reassociation, 1e-5 of the
    largest entry), and away from the fp32 stream."""
    out = ranks[0]["stream_int8"]
    assert out["dispatches"] == 1 and out["refreshed"].all()
    L, W = _jint8_psum_stream([grid_clients(10 + t, [8] * (2 + t % 2)) for t in range(5)])
    _near_ref(out["L"], L)
    _near_ref(out["W"], W)
    assert not np.allclose(out["W"], ranks[0]["stream"]["psum"]["W"], rtol=0, atol=1e-4)


def test_streaming_engine_sharded_matches_merge_bitwise(ranks):
    out = ranks[0]["stream"]
    assert out["psum"]["dispatches"] == 1
    # exact per-wave Grams ⇒ identical refactorizations ⇒ bitwise L and W
    _same(out["psum"], out["merge"], ("L", "W", "n"))
    assert out["psum"]["refreshed"].all()
    waves = [grid_clients(10 + t, [8] * (2 + t % 2)) for t in range(5)]
    jeng = JStreamingEngine(JStreamConfig(n_classes=C, ridge_lambda=LAM))
    ref, _ = jeng.absorb(jeng.init(D), jpack_arrival_waves(waves, num_shards=WORLD))
    _near_ref(out["psum"]["W"], ref.W)
    _near_ref(out["psum"]["L"], ref.L)


def test_absorb_stats_refused_under_a_mesh(ranks):
    kind, msg = ranks[0]["absorb_stats under mesh"]
    assert kind == "ValueError" and "dist-owned mesh" in msg


def _jlinear_loss(params, batch):
    logits = batch["x"] @ params["W"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, batch["y"][:, None].astype(jnp.int32), axis=-1)[:, 0]
    return lse - picked


def test_round_engine_sharded_matches_merge(ranks):
    out = ranks[0]["round_grid"]
    assert out["dispatches"] == 1
    np.testing.assert_allclose(out["merge"]["W"], out["psum"]["W"], rtol=1e-5, atol=1e-6)
    cohort = jpack_cohort_batches(grid_clients(4, [24, 18, 30, 12]), 8, 3, num_shards=WORLD)
    params0 = {"W": jnp.zeros((D, C), jnp.float32)}
    jeng = JRoundEngine(JRoundConfig(algo=jmake_algorithm("fedavg"), client_lr=0.1,
                                     n_total_clients=4), _jlinear_loss,
                        jax.tree.map(lambda _: 1.0, params0))
    ref = jeng.step(jeng.init(params0), cohort)
    np.testing.assert_allclose(out["psum"]["W"], np.asarray(ref.params["W"]),
                               rtol=1e-5, atol=1e-6)


def test_round_engine_psum_matches_merge_on_host_mesh(ranks):
    """tests/test_round_engine.py:300: the padded cohort under psum == the
    plain cohort under merge, and == the reference's merge engine."""
    out = ranks[0]["round_task"]
    for k in ("W", "bias"):
        np.testing.assert_allclose(out["merge"][k], out["psum"][k], rtol=1e-5, atol=1e-6)
    fed, (tf, tl), W0 = dist_check.round_data()
    jfed = JFederatedDataset(fed.features, fed.labels, fed.client_indices, fed.n_classes)
    fc = dist_check.round_fc()
    jfc = JFederatedConfig(**{f: getattr(fc, f) for f in fc.__dataclass_fields__})
    task = jlinear_head_task(dist_check.ROUND_D, dist_check.ROUND_C, jnp.asarray(tf),
                             jnp.asarray(tl), W_init=jnp.asarray(W0))
    jeng = JRoundEngine(JRoundConfig(algo=jmake_algorithm("fedavg"), client_lr=0.1,
                                     n_total_clients=dist_check.ROUND_CLIENTS),
                        task.per_example_loss, task.freeze)
    ref = jeng.step(jeng.init(task.params0), jpack_round(jfed, jfc, 0, n_batches=4)[1])
    for k in ("W", "bias"):
        np.testing.assert_allclose(out["psum"][k], np.asarray(ref.params[k]),
                                   rtol=1e-5, atol=1e-6)


def test_psum_config_validation(ranks):
    kind, msg = ranks[0]["scaffold under psum"]
    assert kind == "ValueError"
    assert msg == ("scaffold needs the global cohort for the cvar scatter; "
                   "use aggregation='merge' (GSPMD) for mesh runs")


def test_personalization_engine_sharded_matches_merge(ranks):
    out = ranks[0]["personalization"]
    assert out["dispatches"] == 2  # solve_heads, solve_at
    assert np.array_equal(out["psum"]["alpha"], out["merge"]["alpha"])
    for k in ("W", "W_at"):
        np.testing.assert_allclose(out["psum"][k], out["merge"][k], rtol=0, atol=1e-5)
    clients = dist_check.personal_clients()
    jfac = jfed3r.factored_update(
        jfed3r.init_factored(D, C, LAM),
        jnp.asarray(np.concatenate([x for x, _ in clients])),
        jnp.asarray(np.concatenate([y for _, y in clients])))
    ref = JPersEngine(JPersConfig(n_classes=C)).solve_heads(
        jfac, jpack_personal_cohort(clients, num_shards=WORLD))
    assert np.array_equal(out["psum"]["alpha"], np.asarray(ref.alpha))
    np.testing.assert_allclose(out["psum"]["W"], np.asarray(ref.W), rtol=0, atol=1e-5)


def test_streaming_sharded_on_pod_mesh(ranks):
    """The 3-axis ("pod", "data", "model") mesh end to end: the wave
    statistics reduce intra-pod then cross-pod and still match merge."""
    out = ranks[0]["pod_stream"]
    _same(out["psum"], out["merge"], ("L", "W"))
    assert out["psum"]["dispatches"] == 1


# ---------------------------------------------------------------------------
# mesh-routed trees (DistConfig(tree=...)) and the async engine
# ---------------------------------------------------------------------------


def test_mesh_tree_routes_engine_bitwise(ranks):
    out = ranks[0]["tree_accumulate"]
    assert out["axes"] == ("edge",)
    _same(out["tree"], out["merge"], ("A", "b"))
    assert out["tree"]["dispatches"] == 1


def test_mesh_tree_two_tier_bitwise_vs_two_stage(ranks):
    """On a multi-axis tier mesh the fp32 tree gives the SAME result as the
    un-routed two-stage psum AND the merge backend."""
    out = ranks[0]["tree_stream"]
    assert out["axes"] == ("edge", "region") and out["fan_in"] == (WORLD // 2, 2)
    assert np.array_equal(out["tree"], out["flat"])
    assert np.array_equal(out["tree"], out["merge"])


def test_int8_tier_crosses_each_boundary_once(ranks):
    """An int8 region tier: each region's fp32 edge sum is roundtripped
    once and the two summed.  The expectation is the reference's merge
    engine on each rank's block (grid-exact, so any fp32 order is exact),
    each region's sum through its ``wire_roundtrip`` — two-term sums, so
    the expectation in rank order is the all-reduce's bits."""
    out = ranks[0]["tree_int8"]
    assert out["lossy"] == "int8"
    packed = jpack_client_shards(grid_clients(7, [8] * (2 * WORLD)), 2, num_shards=WORLD)
    jeng = JAccumulationEngine(JEngineConfig(n_classes=C))
    parts = [jeng.accumulate(jeng.init(D), blk).stats for blk in _blocks(packed)]
    regions = [_jwire(parts[2 * g].A + parts[2 * g + 1].A, parts[2 * g].b + parts[2 * g + 1].b,
                      JINT8)
               for g in range(2)]
    assert np.array_equal(out["A"], np.asarray(regions[0][0] + regions[1][0]))
    assert np.array_equal(out["b"], np.asarray(regions[0][1] + regions[1][1]))


def test_async_engine_dist_mesh_tree_bitwise(ranks):
    """The async ring's retire folds route through the mesh (slots sharded
    over the data axes) with and without a tree, bitwise equal to the merge
    backend; K must divide over the shards; secure excludes psum."""
    out = ranks[0]["async"]
    for mode in ("tree", "flat"):
        _same(out[mode], out["merge"], ("W", "L", "live"))
        assert out[mode]["status"] == ["folded"] * WORLD and out[mode]["folded"] == WORLD
    assert out["K=3"][0] == "ValueError" and "divide" in out["K=3"][1]
    assert out["secure"] == ("ValueError", "secure mode and psum aggregation are exclusive")
    rng = np.random.default_rng(2)  # engines_program's draw
    payloads = {}
    for c in range(WORLD):
        x = grid(rng, (8, D))
        y = rng.integers(0, C, size=8)
        payloads[c] = jfed3r.client_stats(jnp.asarray(x), jnp.asarray(y.astype(np.int32)), C)
    jeng = jasync.AsyncRoundEngine(jasync.AsyncConfig(n_classes=C, ridge_lambda=LAM,
                                                      cohort=WORLD))
    st = jeng.init(D)
    jeng.begin_round(0, list(range(WORLD)), 0.0)
    for i, c in enumerate(np.random.default_rng(3).permutation(WORLD)):
        st, _ = jeng.deliver(st, JUploadEvent(0.1 * i, 0, int(c), 0), payloads[int(c)])
    st = jeng.drain(jeng.close_round(st, 0, now=1.0))
    _near_ref(out["flat"]["W"], st.W)
