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

The reference's other packers (arrival waves, personal cohorts, FL cohort
batches) arrive with the engines that consume them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import FeatureDataset, make_feature_dataset
from repro_torch.federated.dist import resolve_device


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
