"""Client-side data pipeline: per-client views, padding, packing.

The port of the reference's ``data/pipeline.py``, cut to the statistics
path.  The packers are numpy, as in the reference, so the port packs the
same arrays from the same clients bit for bit.

* ``FederatedDataset`` — the simulator's handle on a partitioned dataset:
  one global array store + per-client index lists.
* :func:`pack_client_shards` — MANY clients padded into
  ``(n_shards, clients_per_shard, max_n, ...)`` with masks; the shape the
  accumulation engine (:mod:`repro_torch.federated.engine`) folds.  Packing
  is canonical (clients sorted by id), so the accumulation is bitwise
  invariant to the order clients were sampled in.

* :func:`pack_arrival_waves` — a TIMELINE of arrival waves padded into
  ``(n_waves, clients_per_wave, max_n, ...)`` with masks; the shape the
  streaming engine (:mod:`repro_torch.federated.streaming_engine`) folds
  wave by wave.  Clients are sorted by id WITHIN each wave (arrival order
  across waves is the semantics of the stream), so the packed arrays are
  bitwise invariant to the order a wave's concurrent arrivals came in.

* :func:`pack_personal_cohort` — one tenant COHORT padded into
  ``(cohort, max_n, ...)`` with masks and a per-client holdout split; the
  shape the personalization engine
  (:mod:`repro_torch.federated.personalization`) solves its heads over.

The reference's FL cohort-batch packer arrives with the engine that consumes
it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import FeatureDataset, make_feature_dataset
from repro_torch.federated.dist import resolve_device

ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclass
class ClientData:
    features: np.ndarray  # (n_k, d) or tokens (n_k, S)
    labels: np.ndarray  # (n_k,)

    @property
    def n(self) -> int:
        return len(self.labels)


@dataclass
class FederatedDataset:
    features: np.ndarray
    labels: np.ndarray
    client_indices: List[np.ndarray]
    n_classes: int

    @property
    def n_clients(self) -> int:
        return len(self.client_indices)

    def client(self, k: int) -> ClientData:
        idx = self.client_indices[k]
        return ClientData(self.features[idx], self.labels[idx])

    def client_sizes(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.client_indices])


class PackedClients(NamedTuple):
    """Clients packed into dense shard arrays for the engine's fold.

    ``inputs``/``labels``/``mask`` share the leading
    ``(n_shards, clients_per_shard, max_n)`` layout; ``mask`` is 1.0 on real
    samples, 0.0 on padding.  Empty client slots (shard-count padding) have
    ``client_ids == -1`` and an all-zero mask, so they contribute exactly
    nothing to any masked statistic.
    """

    inputs: np.ndarray  # (S, P, N, ...) features or tokens
    labels: np.ndarray  # (S, P, N) int32
    mask: np.ndarray  # (S, P, N) float32
    client_ids: np.ndarray  # (S, P) int32, -1 = empty slot

    @property
    def n_shards(self) -> int:
        return self.inputs.shape[0]

    @property
    def clients_per_shard(self) -> int:
        return self.inputs.shape[1]

    @property
    def n_slots(self) -> int:
        """Client slots the engine folds, empty ones included."""
        return self.n_shards * self.clients_per_shard

    @property
    def n_clients(self) -> int:
        return int((self.client_ids >= 0).sum())

    @property
    def n_samples(self) -> int:
        return int(self.mask.sum())


def pack_client_shards(
    clients: Sequence[Tuple[np.ndarray, np.ndarray]],
    clients_per_shard: int,
    *,
    client_ids: Optional[Sequence[int]] = None,
    max_n: Optional[int] = None,
    round_to: int = 8,
    canonical_order: bool = True,
    num_shards: Optional[int] = None,
) -> PackedClients:
    """Pack ``[(inputs_k, labels_k), ...]`` into :class:`PackedClients`.

    ``max_n`` (the per-client sample capacity) is rounded up to a multiple of
    ``round_to``.  With ``canonical_order`` the clients are sorted by id
    before packing, which makes the packed arrays — and therefore every
    deterministic accumulation over them — invariant to sampling order.

    ``num_shards`` pads the leading shard axis to a multiple of that way
    count with fully masked empty shards (exact no-ops), for a later
    distributed layer to split evenly.
    """
    if not clients:
        raise ValueError("pack_client_shards: empty client list")
    if clients_per_shard < 1:
        raise ValueError(f"clients_per_shard must be >= 1, got {clients_per_shard}")
    if num_shards is not None and num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    ids = np.arange(len(clients), dtype=np.int32) if client_ids is None else (
        np.asarray(client_ids, np.int32)
    )
    if len(ids) != len(clients):
        raise ValueError("client_ids length mismatch")
    order = np.argsort(ids, kind="stable") if canonical_order else np.arange(len(ids))

    sizes = [len(clients[i][1]) for i in order]
    need = max(max(sizes), 1) if max_n is None else max_n
    if max(sizes) > need:
        raise ValueError(f"client with {max(sizes)} samples exceeds max_n={need}")
    cap = -(-need // round_to) * round_to

    n_shards = -(-len(clients) // clients_per_shard)
    dp = 1 if num_shards is None else int(num_shards)
    n_shards = -(-n_shards // dp) * dp  # pad with fully-masked shards
    n_slots = n_shards * clients_per_shard
    x0 = np.asarray(clients[order[0]][0])
    inputs = np.zeros((n_slots, cap) + x0.shape[1:], x0.dtype)
    labels = np.zeros((n_slots, cap), np.int32)
    mask = np.zeros((n_slots, cap), np.float32)
    slot_ids = np.full((n_slots,), -1, np.int32)
    for slot, i in enumerate(order):
        x, y = clients[i]
        n_k = len(y)
        inputs[slot, :n_k] = x
        labels[slot, :n_k] = y
        mask[slot, :n_k] = 1.0
        slot_ids[slot] = ids[i]

    def shard(a: np.ndarray) -> np.ndarray:
        return a.reshape((n_shards, clients_per_shard) + a.shape[1:])

    return PackedClients(
        inputs=shard(inputs), labels=shard(labels), mask=shard(mask),
        client_ids=slot_ids.reshape(n_shards, clients_per_shard),
    )


class PackedArrivals(NamedTuple):
    """Arrival waves packed into dense timeline arrays for streaming.

    ``inputs``/``labels``/``mask`` share the leading
    ``(n_waves, clients_per_wave, max_n)`` layout; ``mask`` is 1.0 on real
    samples, 0.0 on padding.  Empty client slots — wave-width padding, or
    whole waves with zero arrivals — have ``client_ids == -1`` and an
    all-zero mask, so they contribute exactly nothing to any masked
    statistic (a zero-arrival wave is an exact no-op that still advances
    the wave clock).  The fields are host numpy arrays as packed, or
    tensors after :meth:`to`.
    """

    inputs: ArrayLike  # (T, P, N, ...) features or tokens
    labels: ArrayLike  # (T, P, N) int32
    mask: ArrayLike  # (T, P, N) float32
    client_ids: ArrayLike  # (T, P) int32, -1 = empty slot

    @property
    def n_waves(self) -> int:
        return self.inputs.shape[0]

    @property
    def clients_per_wave(self) -> int:
        return self.inputs.shape[1]

    @property
    def n_clients(self) -> int:
        return int((self.client_ids >= 0).sum())

    @property
    def n_samples(self) -> int:
        return int(self.mask.sum())

    def slice_waves(self, start: int, stop: int) -> "PackedArrivals":
        """A contiguous sub-stream (e.g. one serving segment) — zero-copy."""
        return PackedArrivals(*(a[start:stop] for a in self))

    def to(self, device: Union[str, torch.device]) -> "PackedArrivals":
        """The same timeline as tensors on ``device`` (one copy per field)."""
        dev = resolve_device(device)
        return PackedArrivals(*(torch.as_tensor(a, device=dev) for a in self))


def pack_arrival_waves(
    waves: Sequence[Sequence[Tuple[np.ndarray, np.ndarray]]],
    *,
    client_ids: Optional[Sequence[Sequence[int]]] = None,
    clients_per_wave: Optional[int] = None,
    max_n: Optional[int] = None,
    round_to: int = 8,
    canonical_order: bool = True,
    mesh: Optional[object] = None,
    num_shards: Optional[int] = None,
) -> PackedArrivals:
    """Pack a timeline ``[[(x_k, y_k), ...], ...]`` into :class:`PackedArrivals`.

    Wave ``t`` holds the clients that arrive at time-step ``t`` (possibly
    none).  All waves share one ``(clients_per_wave, max_n)`` grid — both
    default to the timeline maxima, ``max_n`` rounded up to a multiple of
    ``round_to``.  ``client_ids`` assigns global ids per wave (default:
    arrival-order enumeration across the timeline).  With
    ``canonical_order`` each wave's clients are sorted by id before
    packing, making the packed arrays bitwise invariant to the
    presentation order of concurrent arrivals.

    ``num_shards`` pads ``clients_per_wave`` (the axis a distributed layer
    would split; the wave axis is the arrival clock) to a multiple of that
    way count with fully masked slots.  ``mesh`` waits for the distributed
    layer and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "pack_arrival_waves(mesh=...): device meshes are the distributed "
            "layer, ROADMAP Queue 1 item 8; pass num_shards= for the padding"
        )
    if num_shards is not None and num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not waves:
        raise ValueError("pack_arrival_waves: empty timeline")
    if client_ids is None:
        ids_per_wave: List[np.ndarray] = []
        nxt = 0
        for wave in waves:
            ids_per_wave.append(np.arange(nxt, nxt + len(wave), dtype=np.int32))
            nxt += len(wave)
    else:
        if len(client_ids) != len(waves):
            raise ValueError("client_ids timeline length mismatch")
        ids_per_wave = [np.asarray(ids, np.int32) for ids in client_ids]
        for wave, ids in zip(waves, ids_per_wave):
            if len(ids) != len(wave):
                raise ValueError("client_ids wave length mismatch")

    widths = [len(wave) for wave in waves]
    P = max(max(widths), 1) if clients_per_wave is None else clients_per_wave
    if max(widths) > P:
        raise ValueError(
            f"wave with {max(widths)} arrivals exceeds clients_per_wave={P}"
        )
    dp = 1 if num_shards is None else int(num_shards)
    P = -(-P // dp) * dp  # pad the wave-width axis
    sizes = [len(y) for wave in waves for _, y in wave]
    need = max(sizes, default=1) if max_n is None else max_n
    if sizes and max(sizes) > need:
        raise ValueError(f"client with {max(sizes)} samples exceeds max_n={need}")
    cap = -(-max(need, 1) // round_to) * round_to

    x0 = next((np.asarray(wave[0][0]) for wave in waves if wave), None)
    if x0 is None:
        raise ValueError("pack_arrival_waves: no clients in any wave")

    T = len(waves)
    inputs = np.zeros((T, P, cap) + x0.shape[1:], x0.dtype)
    labels = np.zeros((T, P, cap), np.int32)
    mask = np.zeros((T, P, cap), np.float32)
    slot_ids = np.full((T, P), -1, np.int32)
    for t, (wave, ids) in enumerate(zip(waves, ids_per_wave)):
        order = (
            np.argsort(ids, kind="stable") if canonical_order
            else np.arange(len(ids))
        )
        for slot, i in enumerate(order):
            x, y = wave[i]
            n_k = len(y)
            inputs[t, slot, :n_k] = x
            labels[t, slot, :n_k] = y
            mask[t, slot, :n_k] = 1.0
            slot_ids[t, slot] = ids[i]
    return PackedArrivals(
        inputs=inputs, labels=labels, mask=mask, client_ids=slot_ids
    )


class PackedPersonalCohort(NamedTuple):
    """A tenant cohort packed for one batched personalized-head solve.

    ``inputs``/``labels``/``mask``/``holdout`` share the leading
    ``(cohort, max_n)`` layout; ``mask`` is 1.0 on real samples, 0.0 on
    padding, and ``holdout`` ⊆ ``mask`` marks the per-client validation
    samples the α sweep scores on (never the client's full data: index 0 of
    every client is always train).  Empty cohort slots (width padding) have
    ``client_ids == -1`` and all-zero masks, so their statistics vanish and
    their head degenerates to the global solution at any α.
    """

    inputs: np.ndarray  # (K, N, ...) features or tokens
    labels: np.ndarray  # (K, N) int32
    mask: np.ndarray  # (K, N) float32
    holdout: np.ndarray  # (K, N) float32, subset of mask (α-selection split)
    client_ids: np.ndarray  # (K,) int32, -1 = empty slot

    @property
    def cohort(self) -> int:
        return self.inputs.shape[0]

    @property
    def n_clients(self) -> int:
        return int((self.client_ids >= 0).sum())

    @property
    def n_samples(self) -> int:
        return int(self.mask.sum())

    @property
    def n_holdout(self) -> int:
        return int(self.holdout.sum())


def pack_personal_cohort(
    clients: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    client_ids: Optional[Sequence[int]] = None,
    cohort_size: Optional[int] = None,
    max_n: Optional[int] = None,
    round_to: int = 8,
    holdout_frac: float = 0.25,
    canonical_order: bool = True,
    mesh: Optional[object] = None,
    num_shards: Optional[int] = None,
) -> PackedPersonalCohort:
    """Pack ``[(x_k, y_k), ...]`` into a :class:`PackedPersonalCohort`.

    Reuses :func:`pack_client_shards`'s padding conventions by construction
    (one shard of width ``cohort_size``): canonical id sort, ``round_to``
    sample-capacity rounding, ``-1``/zero-mask empty slots.  On top, every
    client with ≥ 2 samples gets a deterministic non-empty HOLDOUT split —
    every ``round(1/frac)``-th of its samples (its last sample if it has
    fewer than that), never index 0, so at least one sample remains on
    each side — which the personalization engine's α sweep scores against.
    Single-sample clients get no holdout (their sweep degenerates to
    ``alpha_grid[0]``).  The split is a pure function of the client's own
    sample order, never of cohort position, preserving bit-invariance to
    request order.

    ``num_shards`` pads the cohort axis to a multiple of that way count with
    empty slots whose heads degenerate to the global solution, for a later
    distributed layer to split evenly.  ``mesh`` waits for the distributed
    layer and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "pack_personal_cohort(mesh=...): device meshes are the distributed "
            "layer, ROADMAP Queue 1 item 8; pass num_shards= for the padding"
        )
    if num_shards is not None and num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0.0 <= holdout_frac < 1.0:
        raise ValueError(f"holdout_frac must be in [0, 1), got {holdout_frac}")
    K = len(clients) if cohort_size is None else cohort_size
    if K < len(clients):
        raise ValueError(f"cohort_size={K} < {len(clients)} clients")
    dp = 1 if num_shards is None else int(num_shards)
    K = -(-K // dp) * dp  # pad the sharded cohort axis
    shards = pack_client_shards(
        clients,
        clients_per_shard=K,
        client_ids=client_ids,
        max_n=max_n,
        round_to=round_to,
        canonical_order=canonical_order,
    )
    inputs = shards.inputs[0]
    labels = shards.labels[0]
    mask = shards.mask[0]
    ids = shards.client_ids[0]

    holdout = np.zeros_like(mask)
    if holdout_frac > 0.0:
        stride = max(int(round(1.0 / holdout_frac)), 2)
        for k in range(K):
            n_k = int(mask[k].sum())
            if n_k >= 2:
                idx = np.arange(stride - 1, n_k, stride)
                if len(idx) == 0:  # n_k < stride: still hold out ONE sample
                    idx = np.array([n_k - 1])
                holdout[k, idx] = 1.0
    return PackedPersonalCohort(
        inputs=inputs, labels=labels, mask=mask, holdout=holdout, client_ids=ids
    )


def make_federated_features(
    seed: int,
    n: int,
    d: int,
    n_classes: int,
    n_clients: int,
    alpha: float,
    *,
    nonlinear: bool = False,
    noise: float = 1.0,
    test_frac: float = 0.2,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[FederatedDataset, FeatureDataset]:
    """Build a heterogeneous federated feature dataset + held-out test set.

    Features are drawn on ``device``; the federated store is host numpy (as
    in the reference) and the test set stays on ``device``.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ds = make_feature_dataset(gen, n, d, n_classes, nonlinear=nonlinear, noise=noise)
    n_test = int(n * test_frac)
    test = FeatureDataset(
        features=ds.features[:n_test], labels=ds.labels[:n_test], n_classes=n_classes
    )
    feats = ds.features[n_test:].cpu().numpy()
    labels = ds.labels[n_test:].cpu().numpy().astype(np.int32)
    rng = np.random.default_rng(seed + 1)
    parts = dirichlet_partition(rng, labels, n_clients, alpha)
    fed = FederatedDataset(feats, labels, parts, n_classes)
    return fed, test
