"""Communication & computation cost meters (paper Appendix D and E).

A copy of the reference's ``federated/costs.py`` (numpy only; importing the
reference's module would run ``repro.federated``'s package init, which
imports JAX), with two differences, each a contract of the port:

* ``comm_per_client`` / ``comp_per_client`` raise ``ValueError`` for
  ``"fed3r-rf"`` on a model without random features (D = 0), where the
  reference fails an ``assert`` (which ``python -O`` removes);
* the hardware rates of ``serving_qps_roofline`` and ``two_stage_allreduce``
  and each tier's ``bandwidth`` in ``tiered_allreduce`` have no defaults:
  the caller names the device it prices (the reference defaults to a TPU's
  rates).

Exact re-implementation of the paper's cost accounting, parameterized by:
  b  — feature-extractor parameter count
  d  — feature dimensionality (c = d·C classifier size)
  C  — number of classes
  D  — random-feature count (FED3R-RF)
  F_phi / F_head — forward FLOPs per image of extractor / classifier head
  E  — local epochs, n_k — client dataset size, κ — clients per round

All communication figures are in *parameters per client per round*
(multiply by 4 for FP32 bytes, as the paper does); computation in FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

FP32_BYTES = 4

# wire formats of the compressed statistics uplink (repro_torch.federated.compress)
WIRE_KINDS = ("fp32", "int8", "fp8", "sketch")


def stats_wire_bytes(
    d: int, C: int, kind: str = "fp32", tile: int = 128, rank: int = 16
) -> float:
    """Wire bytes of ONE (A_k, b_k) statistics upload under a wire format.

    The single pricing formula the cost model, the compression layer, and
    the accuracy-vs-bytes bench all share:

    * ``fp32``   — dense d² + d·C at 4 B/element (today's uplink).
    * ``int8`` / ``fp8`` — 1 B/element payload plus one fp32 absmax scale
      per (tile × tile) block of A and of b (the per-tile scale grid of
      :func:`repro_torch.kernels.ops.quantize_tiles`): → ~4× reduction.
    * ``sketch`` — A travels as its rank-r factor Z_k (r × d fp32, with
      A_k ≈ Z_kᵀZ_k); b stays dense fp32.  Wins over int8 when r ≪ d/4
      and C ≪ d (the b payload is incompressible here).
    """
    if kind not in WIRE_KINDS:
        raise ValueError(f"unknown wire kind: {kind!r} (expected one of {WIRE_KINDS})")
    if kind == "fp32":
        return float(d * d + d * C) * FP32_BYTES
    if kind in ("int8", "fp8"):
        dt = -(-d // tile)  # ⌈d/tile⌉
        ct = -(-C // tile)
        payload = float(d * d + d * C)  # 1 byte per element
        scales = float(dt * dt + dt * ct) * FP32_BYTES
        return payload + scales
    # sketch: rank-r fp32 factor of A + dense fp32 b
    return float(rank * d + d * C) * FP32_BYTES


@dataclass(frozen=True)
class CostModel:
    b: float  # extractor params
    d: int  # feature dim
    C: int  # classes
    D: int = 0  # random features (RF variant)
    F_phi: float = 332.9e6  # MobileNetV2 forward FLOPs / image (paper Table 5)
    E: int = 5  # local epochs (paper App. C)

    def _require_rf(self, algorithm: str) -> None:
        if self.D <= 0:
            raise ValueError(
                f"{algorithm!r} prices D random features, but this CostModel has D={self.D}"
            )

    @property
    def head(self) -> float:
        return self.d * self.C

    @property
    def m(self) -> float:  # full model size
        return self.b + self.head

    @property
    def F_head(self) -> float:
        return self.d * self.C

    @property
    def F_M(self) -> float:
        return self.F_phi + self.F_head

    # --- communication per sampled client per round (params) ---------------

    def comm_per_client(self, algorithm: str) -> Dict[str, float]:
        a = algorithm.lower()
        if a in ("fedavg", "fedavgm"):
            return {"down": self.m, "up": self.m}
        if a == "scaffold":
            return {"down": 2 * self.m, "up": 2 * self.m}
        if a in ("fedavg-lp", "fedavgm-lp"):
            return {"down": self.head, "up": self.head}
        if a == "scaffold-lp":
            return {"down": 2 * self.head, "up": 2 * self.head}
        if a == "fed3r":
            return {"down": 0.0, "up": self.d**2 + self.d * self.C}
        if a == "fed3r-rf":
            self._require_rf(a)
            return {"down": 0.0, "up": self.D**2 + self.D * self.C}
        if a == "fed3r+ft-feat":
            return {"down": self.b, "up": self.b}
        if a == "fed3r-personalized":
            # the ONE-TIME (A_k, b_k) upload the per-tenant closed form is
            # served from — the same statistics the client sent for the
            # global head, so the MARGINAL wire cost of personalizing on
            # top of fed3r is zero (this entry prices the shared upload,
            # not an extra one)
            return {"down": 0.0, "up": self.d**2 + self.d * self.C}
        if a == "personalized-ft":
            # the gradient-FL personalization baseline: a full model copy
            # pushed down and a fine-tuned one uploaded back, per tenant
            return {"down": self.m, "up": self.m}
        raise ValueError(algorithm)

    # --- computation per sampled client per round (FLOPs) ------------------

    def comp_per_client(self, algorithm: str, n_k: float) -> float:
        a = algorithm.lower()
        if a in ("fedavg", "fedavgm", "scaffold"):
            # forward + backward (B ≈ 2F) through the whole model
            return 3 * self.E * n_k * self.F_M
        if a in ("fedavg-lp", "fedavgm-lp", "scaffold-lp"):
            # full forward, backward only through the head
            return self.E * n_k * (self.F_phi + 3 * self.F_head)
        if a == "fed3r":
            # one extractor pass + A_k (symmetric: d(d+1)/2) + b_k (dC)
            return n_k * (self.F_phi + 0.5 * self.d * (self.d + 1) + self.d * self.C)
        if a == "fed3r-rf":
            self._require_rf(a)
            rf_map = self.d * self.D  # Z·Ω
            return n_k * (
                self.F_phi + rf_map + 0.5 * self.D * (self.D + 1) + self.D * self.C
            )
        if a == "fed3r+ft-feat":
            return 3 * self.E * n_k * self.F_M
        if a == "fed3r-personalized":
            # MARGINAL cost on top of fed3r, and it is server-side: one
            # rank-n_k Gram update + d×d refactorization + two triangular
            # solves per head — no client compute at all
            return (
                n_k * 0.5 * self.d * (self.d + 1)
                + self.d**3 / 3.0
                + 2.0 * self.d**2 * self.C
            )
        if a == "personalized-ft":
            # per-tenant fine-tuning pass (forward + backward, E epochs)
            return 3 * self.E * n_k * self.F_M
        raise ValueError(algorithm)

    # --- cumulative curves (paper Fig. 2 middle/right) -----------------------

    def cumulative_comm_bytes(
        self, algorithm: str, n_rounds: int, clients_per_round: int
    ) -> np.ndarray:
        c = self.comm_per_client(algorithm)
        per_round = (c["down"] + c["up"]) * clients_per_round * FP32_BYTES
        return per_round * np.arange(1, n_rounds + 1, dtype=np.float64)

    def cumulative_comp_flops_per_client(
        self,
        algorithm: str,
        n_rounds: int,
        clients_per_round: int,
        n_clients: int,
        avg_n_k: float,
    ) -> np.ndarray:
        """Average cumulative FLOPs per client: T_t = T · t · κ/K (App. E)."""
        T = self.comp_per_client(algorithm, avg_n_k)
        t = np.arange(1, n_rounds + 1, dtype=np.float64)
        return T * t * clients_per_round / n_clients

    def fed3r_total_comm_bytes(self, n_clients: int, include_extractor_push: bool = False
                               ) -> float:
        """FED3R end-to-end: every client uploads its statistics exactly once."""
        up = (self.d**2 + self.d * self.C) * n_clients
        down = self.b * n_clients if include_extractor_push else 0.0
        return (up + down) * FP32_BYTES

    # --- multi-tenant personalized serving (repro_torch.federated.personalization)

    def head_cache_bytes(self, n_tenants: int) -> float:
        """Serving-side memory for n cached per-tenant heads (d·C fp32 each).

        The LRU head cache (repro_torch.launch.serve_heads) holds solved heads
        only — the capacity knob trades this memory against re-solve
        dispatches, so size it against the hot-tenant working set.
        """
        return n_tenants * self.head * FP32_BYTES

    def tenant_stats_bytes(self, n_tenants: int) -> float:
        """Server-side retained per-tenant statistics (A_k: d², b_k: d·C).

        What the server must keep per tenant to re-solve its head after
        every global stream advance; the d² second moment dominates, so
        compressed/quantized stats upload (ROADMAP) attacks this figure.
        """
        return n_tenants * (self.d**2 + self.d * self.C) * FP32_BYTES

    # --- compressed statistics uplink (repro_torch.federated.compress) -----------

    def compressed_stats_bytes(
        self, kind: str, n_tenants: int = 1, tile: int = 128, rank: int = 16
    ) -> float:
        """Wire/retention bytes of n (A_k, b_k) uploads under a wire format.

        ``kind="fp32"`` reproduces :meth:`tenant_stats_bytes` exactly; the
        compressed kinds re-price the same payload as it actually crosses
        the uplink (int8/fp8 tiles + scale grid, or the rank-r sketch).
        """
        return n_tenants * stats_wire_bytes(self.d, self.C, kind, tile, rank)

    def wire_compression_ratio(
        self, kind: str, tile: int = 128, rank: int = 16
    ) -> float:
        """fp32 bytes over compressed bytes for one statistics upload."""
        return self.compressed_stats_bytes("fp32") / self.compressed_stats_bytes(
            kind, tile=tile, rank=rank
        )

    # --- continuous-batching slot serving (repro_torch.launch.serving_engine) ----

    def slot_table_bytes(self, n_slots: int) -> float:
        """Device-resident slot-table memory at S slots (S·d·C fp32 heads).

        The slot engine's whole device footprint: a FIXED donated buffer
        sized by the hot working set, not the tenant universe — compare
        against :meth:`head_cache_bytes` at the full tenant count to see
        what the slots buy (a 1M-tenant head store vs a few thousand
        resident slots serving the same Zipf traffic).
        """
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        return n_slots * self.head * FP32_BYTES

    def slot_solve_flops(
        self, n_solved: float, avg_n_k: float, grid: int = 5
    ) -> float:
        """Solve-stage FLOPs for one tick batching ``n_solved`` cache misses.

        Per head: one rank-n_k symmetric update of the tenant's Gram
        contribution, then the α-grid sweep pays ``grid`` refactorizations
        (d³/3) + two triangular solves (2·d²·C) each — all inside ONE
        dispatch over the cohort, so this is the tick's arithmetic, not a
        per-tenant loop count.
        """
        per_head = (
            avg_n_k * 0.5 * self.d * (self.d + 1)
            + grid * (self.d**3 / 3.0 + 2.0 * self.d**2 * self.C)
        )
        return n_solved * per_head

    def serve_flops(self, n_queries: float) -> float:
        """Serve-stage FLOPs for one tick answering q queries.

        One gathered batched matvec: 2·d·C per query against its slot's
        head.  Orders of magnitude below :meth:`slot_solve_flops`, which
        is why the engine amortizes solves across ticks and serves hits
        from resident slots.
        """
        return 2.0 * n_queries * self.d * self.C

    def serving_qps_roofline(
        self,
        flops_per_s: float,  # the device's peak FLOP/s for the serve stage's type
        hbm_bw: float,  # the device's memory bytes/s
    ) -> Dict[str, float]:
        """Sustained-QPS ceiling of the serve stage on one device.

        Each query touches its gathered head (d·C), its feature row (d)
        and its score row (C) — at d·C fp32 bytes per 2·d·C FLOPs the
        arithmetic intensity is ~0.5 FLOP/byte, so the stage is
        MEMORY-BOUND on any accelerator: the roofline is HBM bandwidth
        over bytes-per-query, and batching queries per tick is how the
        engine actually reaches it (dispatch overhead amortized to O(1)
        per batch, not per query).
        """
        flops_q = self.serve_flops(1)
        bytes_q = FP32_BYTES * (self.head + self.d + self.C)
        compute_qps = flops_per_s / flops_q
        memory_qps = hbm_bw / bytes_q
        return {
            "flops_per_query": flops_q,
            "bytes_per_query": bytes_q,
            "compute_bound_qps": compute_qps,
            "memory_bound_qps": memory_qps,
            "qps": min(compute_qps, memory_qps),
            "bound": "memory" if memory_qps < compute_qps else "compute",
        }

    # --- two-stage statistics all-reduce (repro_torch.federated.dist) ------------

    @property
    def stats_payload_bytes(self) -> float:
        """The per-device all-reduce payload of one statistics aggregation:
        the d² second moment + the d·C class sums, fp32 (the n scalar and
        class counts are noise)."""
        return (self.d**2 + self.d * self.C) * FP32_BYTES

    def two_stage_allreduce(
        self,
        data_parallel: int,
        n_pods: int = 1,
        *,
        ici_bw: float,  # bytes/s per device of the intra-group ring
        dcn_bw: float,  # bytes/s per group boundary (the cross-group link)
        wire: str = "fp32",  # statistics wire format of the reduced payload
        tile: int = 128,
        rank: int = 16,
    ) -> Dict[str, float]:
        """Per-stage wire bytes and latency of the hierarchical all-reduce.

        The dist layer reduces the statistics in two stages — intra-pod
        over ICI across ``data_parallel`` chips, then cross-pod over DCN
        across ``n_pods`` pods (one psum per mesh axis, innermost first) —
        so each stage is costed with the ring all-reduce wire formula
        2·(n−1)/n · payload at its own bandwidth.  The DCN stage moves the
        ALREADY-REDUCED payload once per pod boundary, which is why the
        hierarchy wins: a flat all-reduce would drag every intra-pod hop
        across the slow cross-pod wire.

        ``wire`` re-prices the moving payload under a compressed statistics
        format (repro_torch.federated.compress): each device's local partial
        crosses the wire as int8/fp8 tiles or a rank-r sketch instead of
        dense fp32, shrinking both stages by the format's compression
        ratio.  ``"fp32"`` reproduces the uncompressed figures exactly.
        """
        if data_parallel < 1 or n_pods < 1:
            raise ValueError(
                f"data_parallel and n_pods must be >= 1, got "
                f"{data_parallel}, {n_pods}"
            )
        payload = self.compressed_stats_bytes(wire, tile=tile, rank=rank)
        ici_bytes = 2.0 * (data_parallel - 1) / data_parallel * payload
        dcn_bytes = 2.0 * (n_pods - 1) / n_pods * payload
        ici_s = ici_bytes / ici_bw
        dcn_s = dcn_bytes / dcn_bw
        flat_n = data_parallel * n_pods  # flat all-reduce, DCN-bound
        flat_s = (2.0 * (flat_n - 1) / flat_n * payload) / (
            dcn_bw if n_pods > 1 else ici_bw
        )
        return {
            "payload_bytes": payload,
            "ici_bytes_per_chip": ici_bytes,
            "dcn_bytes_per_pod": dcn_bytes,
            "ici_s": ici_s,
            "dcn_s": dcn_s,
            "total_s": ici_s + dcn_s,
            "flat_allreduce_s": flat_s,
        }

    def tiered_allreduce(
        self,
        tiers,
        *,
        rank: int = 16,
    ) -> Dict[str, object]:
        """Per-tier wire bytes and latency of an N-tier aggregation tree.

        ``tiers`` is the plain-data description
        ``repro.federated.tiers.AggregationTree.as_cost_tiers()`` emits —
        a sequence of dicts with ``fan_in`` (participants reduced at the
        tier), ``wire`` (the tier's boundary format), ``bandwidth``
        (bytes/s of the tier's interconnect: ICI / DCN / WAN) and
        optionally ``name``/``tile`` — LEAF (edge) TIER FIRST.  Keeping
        the input jax-free lets this module price topologies without
        importing the tree implementation.

        Each tier is costed two ways:

        * ``ring_bytes`` / ``tier_s`` — the collective form: a ring
          all-reduce over ``fan_in`` participants at the tier's bandwidth
          (2·(n−1)/n · payload), the payload already shrunk to the tier's
          wire format.  ``total_s`` sums the stages; ``flat_allreduce_s``
          is the flat baseline dragging every hop across the SLOWEST
          tier's wire, and for two fp32 tiers ``total_s`` reproduces
          :meth:`two_stage_allreduce` exactly.
        * ``uplink_bytes`` — the host-tree form: ``prod(fan_in[i:])``
          child payloads cross INTO tier i per reduction, each at the
          tier's wire bytes.  This is the figure the
          :class:`repro.federated.tiers.TieredAbsorber` meters per
          segment, so measured-vs-model drift should sit at 1.0.
        """
        parsed = []
        for i, t in enumerate(tiers):
            name = str(t.get("name", f"tier{i}"))
            fan_in = int(t["fan_in"])
            wire = str(t.get("wire", "fp32"))
            if "bandwidth" not in t:
                raise ValueError(f"tier {name!r}: bandwidth (bytes/s) is required")
            bw = float(t["bandwidth"])
            tile = int(t.get("tile", 128))
            if fan_in < 1:
                raise ValueError(f"tier {name!r}: fan_in must be >= 1, got {fan_in}")
            if bw <= 0:
                raise ValueError(f"tier {name!r}: bandwidth must be > 0, got {bw}")
            parsed.append((name, fan_in, wire, bw, tile))
        if not parsed:
            raise ValueError("tiered_allreduce needs at least one tier")
        leaves = 1
        for _, fan_in, _, _, _ in parsed:
            leaves *= fan_in
        out_tiers = []
        total_s = 0.0
        uplink_total = 0.0
        entering = leaves
        slowest_bw = min(bw for _, _, _, bw, _ in parsed)
        for name, fan_in, wire, bw, tile in parsed:
            payload = self.compressed_stats_bytes(wire, tile=tile, rank=rank)
            ring_bytes = 2.0 * (fan_in - 1) / fan_in * payload
            tier_s = ring_bytes / bw
            uplink_bytes = entering * payload
            out_tiers.append(
                {
                    "name": name,
                    "fan_in": fan_in,
                    "wire": wire,
                    "bandwidth": bw,
                    "payload_bytes": payload,
                    "ring_bytes": ring_bytes,
                    "tier_s": tier_s,
                    "uplink_bytes": uplink_bytes,
                }
            )
            total_s += tier_s
            uplink_total += uplink_bytes
            entering //= fan_in
        # flat baseline: same (leaf-tier) payload, but every hop of the
        # single big ring crosses the slowest interconnect — consistent
        # with two_stage_allreduce's flat figure
        name0, _, wire0, _, tile0 = parsed[0]
        flat_payload = self.compressed_stats_bytes(wire0, tile=tile0, rank=rank)
        flat_s = (
            (2.0 * (leaves - 1) / leaves * flat_payload) / slowest_bw
            if leaves > 1
            else 0.0
        )
        return {
            "tiers": out_tiers,
            "n_tiers": len(out_tiers),
            "leaves": leaves,
            "total_s": total_s,
            "uplink_bytes_total": uplink_total,
            "flat_allreduce_s": flat_s,
            "speedup_vs_flat": flat_s / total_s if total_s > 0 else float("inf"),
        }

    # --- straggler-tail round pricing (repro.federated.async_engine) --------

    def straggler_tail(
        self,
        clients_per_round: int,
        straggler_frac: float,
        *,
        straggler_factor: float = 8.0,
        base_s: float = 0.3,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, float]:
        """Expected round-completion time: synchronous barrier vs async close.

        The synchronous engines complete a round at the MAX of the cohort's
        upload latencies, so any sampled straggler (latency ≈
        ``straggler_factor × base_s``) stretches the whole round; with a
        straggler fraction p the probability a K-client round contains at
        least one is 1 − (1−p)^K — near-certain already at K = 16, p = 0.2.
        The asynchronous engine closes at ``deadline_s`` regardless (late
        uploads keep merging under the staleness bound), so its completion
        is min(deadline, tail).  The returned ``speedup`` is the analytic
        counterpart of the measured ``benchmarks/bench_async.py`` figure;
        wire bytes are unchanged (the same uploads move, just later), so
        this prices TIME, not bytes.
        """
        if clients_per_round < 1:
            raise ValueError(
                f"clients_per_round must be >= 1, got {clients_per_round}"
            )
        if not 0.0 <= straggler_frac <= 1.0:
            raise ValueError(
                f"straggler_frac must be in [0, 1], got {straggler_frac}"
            )
        p_tail = 1.0 - (1.0 - straggler_frac) ** clients_per_round
        tail_s = straggler_factor * base_s
        sync_s = p_tail * tail_s + (1.0 - p_tail) * base_s
        deadline = base_s if deadline_s is None else deadline_s
        async_s = min(deadline, sync_s)
        return {
            "p_straggler_round": p_tail,
            "sync_round_s": sync_s,
            "async_round_s": async_s,
            "speedup": sync_s / async_s if async_s > 0 else float("inf"),
        }

    def personalization_vs_model_push_ratio(self) -> float:
        """Wire cost of personalized-FT (a full model roundtrip per tenant,
        re-paid on every refresh) over the ONE-TIME stats upload the closed
        form reuses.  The closed form's marginal upload beyond fed3r is
        zero, so this ratio is its conservative lower bound — and it grows
        with every FT refresh while the closed form re-solves server-side
        for free."""
        closed = self.comm_per_client("fed3r-personalized")["up"]
        ft = sum(self.comm_per_client("personalized-ft").values())
        return ft / closed


# Paper-configured instances (Table 4/5): d=1280 (MobileNetV2 features).
LANDMARKS = CostModel(b=2.22e6, d=1280, C=2028, F_phi=332.9e6)
INATURALIST = CostModel(b=2.22e6, d=1280, C=1203, F_phi=332.9e6)
CIFAR100 = CostModel(b=2.22e6, d=1280, C=100, F_phi=332.9e6)


def speedup_table(
    cm: CostModel, target_rounds: Dict[str, float]
) -> Dict[str, float]:
    """Rounds-to-target speedups vs FED3R (paper §5.2 reports ×19.3–×82.4)."""
    base = target_rounds.get("fed3r") or target_rounds.get("fed3r-rf")
    return {k: v / base for k, v in target_rounds.items()}
