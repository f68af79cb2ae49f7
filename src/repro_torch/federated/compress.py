"""Compressed statistics uplink — quantized / sketched (A_k, b_k) wire formats.

The port of the reference's ``federated/compress.py``.  Fed3R's wire cost is
the d×d second moment every client uploads
(:meth:`repro_torch.federated.costs.CostModel.tenant_stats_bytes`).  Every
(A_k, b_k) statistics payload can travel as

* ``int8``  — per-tile absmax symmetric int8 (1 B/element + one fp32 scale
  per (tile × tile) block; ~4× fewer bytes), packed and unpacked by the
  CUDA kernels :func:`repro_torch.kernels.ops.quantize_tiles` /
  :func:`repro_torch.kernels.ops.dequant_accumulate` on the card and by
  their plain versions on the CPU (the tensor's device decides);
* ``fp8``   — the same tiling algebra with a ``float8_e4m3fn`` payload
  (the byte count of int8, a coarser mantissa, a wider per-tile dynamic
  range), in plain PyTorch ops (the reference has no kernel for it).  A
  torch build without ``float8_e4m3fn`` falls back to int8 with a warning
  (:func:`fp8_supported`); the card (Hopper) and the CPU both have it;
* ``sketch`` — a rank-r factor Z_k (r × d) with A_k ≈ Z_kᵀZ_k (top-r
  eigenpairs, the optimal Frobenius rank-r approximation of the PSD second
  moment); b_k stays dense fp32.

``fp32`` is the identity format: its code path adds the raw tensors exactly
as the uncompressed engines do, so it stays BITWISE identical to them.

Rounding follows the reference's COMPILED arithmetic, which is what its
engines run: the per-tile scale is max|x| times the rounded reciprocal
fl(1/127) (or fl(1/448)), because XLA folds a division by a constant under
``jit``; the payload divides by the scale.  The cohort quantizer of the
secure-aggregation interop runs eagerly in the reference, so its shared
scale is the true quotient max|x| / 127.

Error feedback: a lossy uplink hit repeatedly by the same client repeats
the SAME rounding error every round.  A per-client residual e_k carried
between uploads (send Q(x + e_k), keep e_k ← (x + e_k) − Q(x + e_k)) makes
the aggregate over R uploads telescope to Σ x_t − e_R: off by ONE
quantization step regardless of R.  :func:`compress_stats_ef` is the
algebra; :class:`UplinkCompressor` the per-client residual store with
wire-byte accounting priced by
:func:`repro_torch.federated.costs.stats_wire_bytes`.

Engine integration: :class:`repro_torch.federated.engine.AccumulationEngine`
folds each client's payload into the fp32 accumulator through
:func:`roundtrip_add` (``EngineConfig(wire=...)``);
:class:`repro_torch.federated.streaming_engine.StreamingEngine` compresses
each wave's rank-n statistics before they touch the carried factor
(``StreamConfig(wire=...)``).  The psum form (each device's partial through
the wire before an all-reduce) waits for the distributed layer.

Secure-aggregation interop (paper App. B): :func:`cohort_quantize_int8`
quantizes a whole cohort against SHARED per-tile scales into int32 working
precision, so pairwise masks added mod 2³² cancel exactly in the sum
(:func:`repro_torch.federated.secure_agg.mask_quantized_payload`), and one
shared-scale dequantization recovers the cohort aggregate.
"""
from __future__ import annotations

import functools
import math
import warnings
from dataclasses import dataclass, replace
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch

from repro_torch.core import fed3r
from repro_torch.core.fed3r import Fed3RStats
from repro_torch.federated.costs import WIRE_KINDS, stats_wire_bytes
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.telemetry import get_telemetry
from repro_torch.kernels.ops import dequant_accumulate, quantize_tiles
from repro_torch.kernels.ref import INT8_QMAX, expand_tiles, pad_to_tiles

FP8_QMAX = 448.0  # float8_e4m3fn max finite value


@functools.lru_cache(maxsize=1)
def fp8_supported() -> bool:
    """Can this torch build round-trip ``float8_e4m3fn``?"""
    dtype = getattr(torch, "float8_e4m3fn", None)
    if dtype is None:
        return False
    try:
        x = torch.tensor([1.0, -2.5], dtype=torch.float32)
        return bool(torch.equal(x.to(dtype).to(torch.float32), x))
    except (RuntimeError, TypeError):  # a build that names the dtype but cannot cast
        return False


@functools.lru_cache(maxsize=1)
def _warn_fp8_fallback() -> None:
    """Emit the fp8→int8 fallback warning once per process (fp8 support
    cannot change within a process; tests reset it via ``cache_clear()``)."""
    warnings.warn(
        f"fp8 wire format is unsupported by torch {torch.__version__}; falling back "
        "to int8 (identical wire bytes, round-to-nearest int mantissa)",
        RuntimeWarning,
        stacklevel=4,  # engine ctor → WireFormat.resolved → here
    )


@dataclass(frozen=True)
class WireFormat:
    """Static wire-format configuration of the statistics uplink.

    ``kind`` ∈ {"fp32", "int8", "fp8", "sketch"}; ``tile`` is the absmax
    granularity of the quantized kinds (one fp32 scale per tile × tile
    block); ``rank`` is the sketch rank r; ``error_feedback`` enables the
    per-client residual carry in :class:`UplinkCompressor` (the engines'
    folds are single-shot per client and stateless).
    """

    kind: str = "fp32"
    tile: int = 128
    rank: int = 16
    error_feedback: bool = True

    def __post_init__(self):
        if self.kind not in WIRE_KINDS:
            raise ValueError(
                f"unknown wire kind: {self.kind!r} (expected one of {WIRE_KINDS})"
            )
        if self.tile < 1:
            raise ValueError(f"tile must be >= 1, got {self.tile}")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")

    def resolved(self) -> "WireFormat":
        """The format actually used: fp8 degrades to int8 (same byte count)
        with a once-per-process warning only where torch cannot represent
        ``float8_e4m3fn``."""
        if self.kind == "fp8" and not fp8_supported():
            _warn_fp8_fallback()
            get_telemetry().event("fp8_fallback", backend=f"torch {torch.__version__}")
            return replace(self, kind="int8")
        return self

    def wire_bytes(self, d: int, C: int) -> float:
        """Bytes one (A_k, b_k) upload costs under this format."""
        return stats_wire_bytes(d, C, self.kind, self.tile, self.rank)


# ---------------------------------------------------------------------------
# Quantization algebra (the tensor's device picks kernel or plain version)
# ---------------------------------------------------------------------------


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _int8_roundtrip_add(acc: torch.Tensor, x: torch.Tensor, tile: int) -> torch.Tensor:
    """acc + Q(x): one ``quantize_tiles`` and one ``dequant_accumulate``."""
    q, s = quantize_tiles(_f32(x), tile=tile)
    return dequant_accumulate(_f32(acc), q, s, tile=tile)


def _fp8_roundtrip(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile scaled fp8 quantize→dequantize; the scale is max|x|·fl(1/448)."""
    M, N = x.shape
    xp = pad_to_tiles(x.to(torch.float32), tile)
    Mt, Nt = xp.shape[0] // tile, xp.shape[1] // tile
    blocks = xp.reshape(Mt, tile, Nt, tile)
    absmax = blocks.abs().amax(dim=(1, 3))
    inv = torch.tensor(1.0 / FP8_QMAX, dtype=torch.float32, device=x.device)
    scales = torch.where(absmax > 0.0, absmax * inv, torch.ones_like(absmax))[:, None, :, None]
    q = (blocks / scales).to(torch.float8_e4m3fn)
    back = q.to(torch.float32) * scales
    return back.reshape(xp.shape)[:M, :N]


def sketch_psd(A: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank-r factor Z (r, d) of a PSD matrix with A ≈ ZᵀZ.

    Top-r eigenpairs of the symmetric A; negative eigenvalues (fp noise
    around zero for a true second moment) clamp to 0 so ZᵀZ stays PSD.  Z
    is defined up to the signs of its rows; ZᵀZ is not.
    """
    w, V = torch.linalg.eigh(A.to(torch.float32))  # ascending eigenvalues
    w_top = w[-rank:].clamp_min(0.0)
    return (V[:, -rank:] * torch.sqrt(w_top)[None, :]).T


def unsketch(Z: torch.Tensor) -> torch.Tensor:
    """The aggregator's view of a sketched upload: A ≈ ZᵀZ."""
    return Z.T @ Z


def wire_roundtrip(
    A: torch.Tensor, b: torch.Tensor, fmt: WireFormat
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate the lossy uplink: the (Â, b̂) the aggregator receives.

    ``fp32`` returns the inputs UNTOUCHED; under ``sketch`` only A is
    sketched and b stays dense fp32.
    """
    if fmt.kind == "fp32":
        return A, b
    if fmt.kind == "sketch":
        return unsketch(sketch_psd(A, fmt.rank)), b
    if fmt.kind == "fp8":
        return _fp8_roundtrip(A, fmt.tile), _fp8_roundtrip(b, fmt.tile)
    return (_int8_roundtrip_add(torch.zeros_like(A, dtype=torch.float32), A, fmt.tile),
            _int8_roundtrip_add(torch.zeros_like(b, dtype=torch.float32), b, fmt.tile))


def roundtrip_add(
    accA: torch.Tensor, accb: torch.Tensor, A: torch.Tensor, b: torch.Tensor, fmt: WireFormat
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one compressed (A_k, b_k) upload into the fp32 accumulator.

    Under ``int8`` the payload lands through the fused dequantize-accumulate
    (two ``quantize_tiles`` and two ``dequant_accumulate`` launches on the
    card); under ``fp32`` this is exactly ``acc + A``.
    """
    if fmt.kind == "fp32":
        return accA + A, accb + b
    if fmt.kind == "int8":
        return (_int8_roundtrip_add(accA, A, fmt.tile),
                _int8_roundtrip_add(accb, b, fmt.tile))
    Ah, bh = wire_roundtrip(A, b, fmt)
    return accA + Ah, accb + bh


def matrix_roundtrip(x: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """Lossy wire roundtrip of ONE 2-D matrix (``fp32`` = identity).

    The per-leaf primitive of a tier boundary of an aggregation tree;
    ``sketch`` is a client-uplink format for PSD second moments and is
    rejected here.
    """
    if fmt.kind == "fp32":
        return x
    if fmt.kind == "fp8":
        return _fp8_roundtrip(x, fmt.tile)
    if fmt.kind == "int8":
        return _int8_roundtrip_add(torch.zeros_like(x, dtype=torch.float32), x, fmt.tile)
    raise ValueError(
        f"wire kind {fmt.kind!r} is not a tier-boundary format (expected fp32 | int8 | fp8)"
    )


def matrix_roundtrip_add(acc: torch.Tensor, x: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """Fold one matrix across a lossy tier boundary into an fp32 accumulator
    (``int8`` through the fused dequantize-accumulate; ``fp32`` is exactly
    ``acc + x``)."""
    if fmt.kind == "fp32":
        return acc + x
    if fmt.kind == "int8":
        return _int8_roundtrip_add(acc, x, fmt.tile)
    return acc + matrix_roundtrip(x, fmt)


def quant_spectral_bound(S: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """Data-dependent bound on ‖E‖₂ of the quantization error E = Ŝ − S.

    Per-tile absmax quantization errs at most ``max_scale/2`` per entry
    (int8) or ``|S_ij|·2⁻⁴`` (fp8's 3-bit mantissa); the spectral norm of a
    dense d×d perturbation with entries bounded by δ is near √d·δ.  It sizes
    the jitter of :func:`psd_cholesky`; ``sketch`` and ``fp32`` introduce no
    indefiniteness and return 0.  A 0-d tensor on S's device (no host sync).
    """
    if fmt.kind in ("fp32", "sketch"):
        return torch.zeros((), dtype=torch.float32, device=S.device)
    amax = S.abs().amax()
    per_entry = amax / 16.0 if fmt.kind == "fp8" else 0.5 * amax / INT8_QMAX
    return math.sqrt(S.shape[0]) * per_entry


def psd_cholesky(G: torch.Tensor, bound: Union[torch.Tensor, float]) -> torch.Tensor:
    """Cholesky of a nominally PSD matrix whose smallest eigenvalues
    quantization noise may have pushed negative: the plain factorization
    where it succeeds (bit-identical), else retries with diagonal jitter
    τ ∈ {1, 4, 16}·bound, branch-free
    (:func:`repro_torch.core.fed3r.psd_cholesky`)."""
    return fed3r.psd_cholesky(G, bound=bound)


# ---------------------------------------------------------------------------
# Error feedback — per-client residual carry across repeated participation
# ---------------------------------------------------------------------------


class EFState(NamedTuple):
    """Per-client error-feedback residuals (what the wire has not yet sent)."""

    eA: torch.Tensor  # (d, d) fp32
    eb: torch.Tensor  # (d, C) fp32


def ef_init(d: int, n_classes: int, device: Union[str, torch.device] = "cuda") -> EFState:
    dev = resolve_device(device)
    return EFState(
        eA=torch.zeros((d, d), dtype=torch.float32, device=dev),
        eb=torch.zeros((d, n_classes), dtype=torch.float32, device=dev),
    )


def compress_stats_ef(
    A: torch.Tensor, b: torch.Tensor, ef: EFState, fmt: WireFormat
) -> Tuple[torch.Tensor, torch.Tensor, EFState]:
    """One error-compensated upload: send Q(x + e), carry e ← (x+e) − Q(x+e).

    Returns the aggregator's view (Â, b̂) and the new residual.  Under
    ``fp32`` the upload is exact: A, b and the residual pass through.
    """
    if fmt.kind == "fp32":
        return A, b, ef
    xA, xb = A + ef.eA, b + ef.eb
    Ah, bh = wire_roundtrip(xA, xb, fmt)
    return Ah, bh, EFState(eA=xA - Ah, eb=xb - bh)


class UplinkCompressor:
    """Per-client compressed uplink with error-feedback residuals.

    Each client owns one residual that persists across its repeated
    participations, so the server-side accumulated A stays within one
    quantization step of the truth however many lossy uploads a client
    makes.  ``upload`` is one plain call (no compilation) on the tensors'
    device.  ``bytes_sent`` / ``bytes_fp32`` price the wire under the
    configured format against the dense fp32 uplink, as the telemetry
    counters ``wire_bytes_sent_total`` / ``wire_bytes_fp32_total`` (with
    ``wire_uploads_total``), and the gauges ``wire_compression_ratio`` and
    ``wire_cost_model_drift`` (bytes priced per upload over the
    ``cost_model``'s prediction).
    """

    def __init__(self, fmt: WireFormat, *, cost_model=None, telemetry=None):
        self.fmt = fmt.resolved()
        self.cost_model = cost_model  # Optional[repro_torch.federated.costs.CostModel]
        self._residuals: Dict[int, EFState] = {}
        t = self.telemetry = get_telemetry() if telemetry is None else telemetry
        inst = t.next_instance("uplink")
        self._c_uploads = t.counter("wire_uploads_total", kind=self.fmt.kind, inst=inst)
        self._c_sent = t.counter("wire_bytes_sent_total", kind=self.fmt.kind, inst=inst)
        self._c_fp32 = t.counter("wire_bytes_fp32_total", kind=self.fmt.kind, inst=inst)
        self._g_ratio = t.gauge("wire_compression_ratio", kind=self.fmt.kind, inst=inst)
        self._g_drift = t.gauge("wire_cost_model_drift", kind=self.fmt.kind, inst=inst)

    @property
    def uploads(self) -> int:
        return int(self._c_uploads.value)

    @property
    def bytes_sent(self) -> float:
        return float(self._c_sent.value)

    @property
    def bytes_fp32(self) -> float:
        return float(self._c_fp32.value)

    def upload(self, client_id: int, stats: Fed3RStats) -> Fed3RStats:
        """Compress one client upload; returns the statistics AS RECEIVED by
        the aggregator (dequantized), advancing the client's residual."""
        with self.telemetry.span("upload", engine="uplink"):
            d, C = stats.b.shape
            ef = self._residuals.get(client_id)
            if ef is None or not self.fmt.error_feedback:
                ef = ef_init(d, C, stats.b.device)
            Ah, bh, new_ef = compress_stats_ef(stats.A, stats.b, ef, self.fmt)
            if self.fmt.error_feedback:
                self._residuals[client_id] = new_ef
            sent = self.fmt.wire_bytes(d, C)
            self._c_uploads.inc()
            self._c_sent.inc(sent)
            self._c_fp32.inc(stats_wire_bytes(d, C, "fp32"))
            self._g_ratio.set(self.compression_ratio)
            if self.cost_model is not None:
                predicted = self.cost_model.compressed_stats_bytes(
                    self.fmt.kind, tile=self.fmt.tile, rank=self.fmt.rank
                )
                self._g_drift.set(sent / predicted if predicted else float("inf"))
            return Fed3RStats(A=Ah, b=bh, n=stats.n)

    @property
    def compression_ratio(self) -> float:
        """fp32 bytes over bytes actually sent (1.0 before any upload)."""
        return self.bytes_fp32 / self.bytes_sent if self.bytes_sent else 1.0


# ---------------------------------------------------------------------------
# Secure-aggregation interop — shared-scale integer payloads
# ---------------------------------------------------------------------------


class IntPayload(NamedTuple):
    """One client's shared-scale integer upload (int32 working precision so
    cohort sums and mod-2³² masks never saturate the int8 value range)."""

    qA: torch.Tensor  # (d, d) int32 — int8-valued entries
    qb: torch.Tensor  # (d, C) int32


def _shared_scales(xs: Sequence[torch.Tensor], tile: int, qmax: float) -> torch.Tensor:
    """Per-tile scales from the COHORT absmax, max|x| / qmax (in deployment:
    a public per-tile bound agreed before upload, so no raw data leaks)."""
    absmax = None
    for x in xs:
        xp = pad_to_tiles(x.to(torch.float32), tile)
        blocks = xp.reshape(xp.shape[0] // tile, tile, xp.shape[1] // tile, tile)
        am = blocks.abs().amax(dim=(1, 3))
        absmax = am if absmax is None else torch.maximum(absmax, am)
    return torch.where(absmax > 0.0, absmax / qmax, torch.ones_like(absmax))


def _quantize_shared(x: torch.Tensor, scales: torch.Tensor, tile: int, qmax: float) -> torch.Tensor:
    M, N = x.shape
    s = expand_tiles(scales, tile, M, N)
    return torch.round(x.to(torch.float32) / s).clamp_(-qmax, qmax).to(torch.int32)


def cohort_quantize_int8(
    stats: Sequence[Fed3RStats], tile: int = 128
) -> Tuple[List[IntPayload], torch.Tensor, torch.Tensor]:
    """Quantize a cohort's uploads against SHARED per-tile scales.

    Shared scales make the integer payloads ADDITIVE: Σ_k q_k dequantizes
    with one multiply to Σ_k Q(x_k), the property masked (secure)
    aggregation needs, since the server only ever sees the masked integer
    sum.  Returns the per-client payloads and the (A, b) scale grids.
    """
    sA = _shared_scales([s.A for s in stats], tile, INT8_QMAX)
    sb = _shared_scales([s.b for s in stats], tile, INT8_QMAX)
    payloads = [
        IntPayload(qA=_quantize_shared(s.A, sA, tile, INT8_QMAX),
                   qb=_quantize_shared(s.b, sb, tile, INT8_QMAX))
        for s in stats
    ]
    return payloads, sA, sb


def dequantize_int_sum(
    q_sum: IntPayload, sA: torch.Tensor, sb: torch.Tensor, tile: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared-scale dequantization of an aggregated integer payload."""
    d, C = q_sum.qb.shape
    return (q_sum.qA.to(torch.float32) * expand_tiles(sA, tile, d, d),
            q_sum.qb.to(torch.float32) * expand_tiles(sb, tile, d, C))
