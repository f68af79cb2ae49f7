"""``launch/hlo_analysis.py`` against the reference's, on the same collectives.

The reference parses partitioned HLO; the port prices the census its
collectives record (``sharding/hints.py::census``).  Each case writes the
same collectives both ways, as HLO lines (iota and explicit replica
groups, ``-start`` forms) for the reference and as census records for the
port, and holds ``collective_stats``, the ``CollectiveStats`` arithmetic
and ``roofline_terms`` equal: the same ring factors on the same numbers,
so equal exactly.  Then the census itself on a one-rank gloo world: every
helper records its logical collective, censuses nest, and a record's
group spans nodes only across ``RANKS_PER_NODE`` ranks.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW,
    NETWORK_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    link_bw,
    make_host_mesh,
)
from repro_torch.launch.world import single_rank_world  # noqa: E402
from repro_torch.sharding import hints  # noqa: E402
from repro_torch.sharding.hints import Collective  # noqa: E402

_BYTES = {"f32": 4, "bf16": 2, "s32": 4, "f16": 2, "s8": 1}

# (kind, dtype, shape, group size, replica-group form) — the buffer is the
# op's result: an all-gather's gathered array, a reduce-scatter's block
CASES = {
    "mixed": [("all-reduce", "f32", (1024, 512), 16, "iota"),
              ("all-reduce", "bf16", (8, 4096), 2, "explicit"),
              ("all-gather", "bf16", (4096, 128), 4, "explicit"),
              ("reduce-scatter", "f32", (64, 128), 8, "iota"),
              ("all-to-all", "bf16", (16, 64), 2, "explicit"),
              ("collective-permute", "f32", (128,), 2, "pairs"),
              ("all-reduce", "f32", (256,), 32, "start"),
              ("all-gather", "s32", (32, 16), 16, "start")],
    "tensor-parallel block": [("all-reduce", "f32", (2, 4096, 12288), 16, "iota")] * 6
    + [("all-gather", "f32", (4096, 256000), 16, "iota"),
       ("reduce-scatter", "f32", (4096, 16000), 16, "iota")],
    "fsdp": [("all-gather", "bf16", (12288, 2112), 16, "iota")] * 4
    + [("reduce-scatter", "f32", (768, 2112), 16, "iota")] * 2
    + [("all-reduce", "f32", (3584, 5612), 32, "explicit")],
}


def _groups(n, form):
    if form in ("iota", "start"):
        return f"replica_groups=[{256 // n},{n}]<=[256]"
    ids = ",".join(str(i) for i in range(n))
    return f"replica_groups={{{{{ids}}},{{...}}}}"


def hlo_text(case):
    lines = ["HloModule m, entry_computation_layout={()->()}", "ENTRY %main {"]
    for i, (kind, dt, shape, n, form) in enumerate(case):
        ty = f"{dt}[{','.join(str(d) for d in shape)}]{{{','.join(str(j) for j in reversed(range(len(shape))))}}}"
        op = kind + ("-start" if form == "start" else "")
        tail = ("source_target_pairs={{0,1},{1,0}}" if form == "pairs"
                else _groups(n, form))
        lines.append(f"  %c.{i} = {ty} {op}({ty} %p.{i}), channel_id={i + 1}, {tail}, "
                     f"metadata={{op_name=\"all-reduce(\"}}")
    lines.append("}")
    return "\n".join(lines)


def records(case):
    return [Collective(kind, math.prod(shape) * _BYTES[dt], 2 if form == "pairs" else n, True)
            for kind, dt, shape, n, form in case]


def _as_dicts(stats):
    return ({k: v for k, v in stats.counts.items() if v},
            {k: v for k, v in stats.buffer_bytes.items() if v or stats.counts.get(k)},
            {k: v for k, v in stats.wire_bytes.items() if v or stats.counts.get(k)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_stats_equal_the_references(name):
    want = jhlo.collective_stats(hlo_text(CASES[name]))
    got = hlo_analysis.collective_stats(records(CASES[name]))
    assert sum(want.counts.values()) == len(CASES[name])  # every line parsed
    assert _as_dicts(got) == _as_dicts(want)
    assert got.total_wire_bytes == want.total_wire_bytes
    assert got.summary() == want.summary()


@pytest.mark.parametrize("factor", [0.5, 3.0, 16])
def test_collective_stats_arithmetic_equals_the_references(factor):
    a_ref, b_ref = (jhlo.collective_stats(hlo_text(CASES[n])) for n in ("mixed", "fsdp"))
    a, b = (hlo_analysis.collective_stats(records(CASES[n])) for n in ("mixed", "fsdp"))
    for got, want in ((a.scaled(factor), a_ref.scaled(factor)),
                      (a.minus(b), a_ref.minus(b_ref)),
                      (b.minus(a), b_ref.minus(a_ref)),
                      (a.plus_scaled(b.minus(a), factor), a_ref.plus_scaled(b_ref.minus(a_ref),
                                                                             factor))):
        assert _as_dicts(got) == _as_dicts(want)
        assert got.total_wire_bytes == want.total_wire_bytes


@pytest.mark.parametrize("flops,nbytes,wire,chips", [
    (2.6e15, 7.1e12, 3.9e10, 256), (6.0e13, 9.0e11, 1.2e8, 512), (1.0e9, 4.0e12, 0.0, 256),
    (3.0e9, 1.0e6, 5.0e9, 256)])
def test_roofline_terms_equal_the_references(flops, nbytes, wire, chips):
    kw = dict(peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=NETWORK_BW)
    got = hlo_analysis.roofline_terms(flops, nbytes, wire, chips, **kw)
    want = jhlo.roofline_terms(flops, nbytes, wire, chips, **kw)
    for f in ("compute_s", "memory_s", "collective_s", "hlo_flops_global", "hlo_bytes_global",
              "collective_wire_bytes_per_chip", "n_chips", "dominant"):
        assert getattr(got, f) == getattr(want, f), f


def test_wire_bytes_names_the_kinds():
    assert hlo_analysis.wire_bytes("all-reduce", 1600.0, 16) == 2.0 * 15 / 16 * 1600
    with pytest.raises(ValueError, match="unknown collective kind"):
        hlo_analysis.wire_bytes("broadcast", 1.0, 2)


def test_link_rates_are_the_data_sheets():
    """Data-sheet figures, not measurements: NVLink inside a node, the
    400 Gb/s port across nodes; the roofline's peak and HBM rate."""
    assert (link_bw(False), link_bw(True)) == (NVLINK_BW, NETWORK_BW) == (450e9, 50e9)
    assert (PEAK_FLOPS_BF16, HBM_BW) == (989e12, 3.35e12)


def test_the_census_records_each_collective_as_what_it_stands_for():
    """On a one-rank gloo world: an all-reduce (sum and max), an all-gather
    emulated by a zero-filled all-reduce and its reduce-scatter backward,
    the engines' psum stage and gather_blocks; censuses nest and stop
    recording when they close."""
    from repro_torch.federated.dist import DistConfig, DistContext, psum_axis

    with single_rank_world("gloo", "cpu"):
        mesh = make_host_mesh(1, device_type="cpu")
        x = torch.arange(12.0).reshape(3, 4)
        with hints.census() as outer:
            hints.all_reduce(x.clone(), (mesh.get_group("model"),))
            with hints.census() as inner:
                psum_axis({"a": x}, mesh, "data")
                ctx = DistContext(DistConfig(aggregation="psum", mesh=mesh))
                ctx.gather_blocks([x])
            with hints.use_mesh(mesh):
                g = torch.zeros(3, 4, requires_grad=True)
                y = hints._Gather.apply(g, 1, ("data",))
                y.sum().backward()
        hints.all_reduce(x.clone(), (mesh.get_group("model"),))  # no census open
    assert [r.kind for r in inner] == ["all-reduce", "all-gather"]
    assert [r.kind for r in outer] == ["all-reduce", "all-reduce", "all-gather", "all-gather",
                                       "reduce-scatter"]
    assert all(r.group == 1 and not r.cross_node for r in outer)
    assert outer[0].nbytes == 48 and outer[3].nbytes == 48 and outer[4].nbytes == 48
    assert np.array_equal(g.grad.numpy(), np.ones((3, 4), np.float32))
