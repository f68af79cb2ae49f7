"""Slot-table state for the continuous-batching head-serving engine.

The port of the reference's ``federated/slots.py``.  The serving engine
(:mod:`repro_torch.launch.serving_engine`) keeps S FIXED device-resident
head slots — the decode-style working set a generate loop keeps KV-cache
pages in — and this module owns that state:

* the DEVICE side is one ``(S, d, C)`` fp32 tensor of solved heads, updated
  in place by every solve tick (where the reference donates its array to
  the jitted solve), so the table never round-trips the host;
* the HOST side is the control plane: which tenant occupies which slot, at
  which tenant/global version its head was solved, and the
  recency/popularity counters the eviction policy ranks.  It is plain
  numpy — admission control and victim selection cost no dispatches;
* slot 0 is PINNED to the global head (``factored_solution`` of the
  current stream state): every query whose tenant holds no server-side
  data — or whose head was shed by slot pressure — gathers slot 0, so the
  serve stage is always one dense gather + batched matmul with no
  fallback branch.

Eviction is coldest-first: free slots are taken before victims, and
victims rank by ``(last_used, hits)`` lexicographically — least-recently
served first, ties broken by lifetime popularity — so a Zipf-hot tenant
survives a sweep of one-shot cold tenants even when their recency is
newer.  :class:`TenantUniverse` maps a simulated millions-of-tenants id
space onto a base federation's client data for benchmark-scale traffic.
The host control plane is the reference's numpy, unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.federated.dist import resolve_device


class SlotTable:
    """S fixed head slots: a device ``(S, d, C)`` tensor + host metadata.

    ``heads`` is the only device-resident piece, on ``device``, and the
    engine writes solved heads into it in place (the reference donates the
    array through each jitted solve; an in-place update is the same memory
    discipline); everything else is the host control plane.  ``global_slot_version`` tracks the stream version
    the pinned slot-0 global head was solved at (``-1`` = never solved, so
    the first tick always refreshes it).
    """

    GLOBAL_SLOT = 0

    def __init__(
        self, n_slots: int, d: int, n_classes: int,
        device: Union[str, torch.device] = "cuda",
    ):
        if n_slots < 2:
            raise ValueError(
                f"n_slots must be >= 2 (slot 0 is the pinned global head), "
                f"got {n_slots}"
            )
        self.n_slots = n_slots
        self.heads = torch.zeros(
            (n_slots, d, n_classes), dtype=torch.float32, device=resolve_device(device)
        )
        self.tenant = np.full((n_slots,), -1, np.int64)  # -1 = empty slot
        self.tenant_version = np.zeros((n_slots,), np.int64)
        self.global_version = np.full((n_slots,), -1, np.int64)
        self.last_used = np.zeros((n_slots,), np.int64)
        self.hits = np.zeros((n_slots,), np.int64)
        self.global_slot_version = -1
        self.evictions = 0
        self._slot_of: Dict[int, int] = {}

    def __len__(self) -> int:
        """Number of occupied tenant slots (the pinned global slot excluded)."""
        return len(self._slot_of)

    def slot_of(self, tenant: int) -> Optional[int]:
        """The tenant's resident slot, or None."""
        return self._slot_of.get(int(tenant))

    def take_slots(self, n: int, protect: Sequence[int] = ()) -> List[int]:
        """Claim up to ``n`` slots for incoming heads: free slots first, then
        the coldest victims by ``(last_used, hits)``.

        ``protect`` lists slots that must not be evicted (tenants being
        served in the SAME tick — evicting them would downgrade an
        in-flight query to the global head).  May return fewer than ``n``
        when the table is protection-saturated; the engine serves the
        overflow tenants from the global slot and reports it.
        """
        keep = set(protect)
        keep.add(self.GLOBAL_SLOT)
        free = [s for s in range(self.n_slots)
                if self.tenant[s] < 0 and s not in keep]
        out = free[:n]
        need = n - len(out)
        if need > 0:
            occupied = [s for s in range(self.n_slots)
                        if self.tenant[s] >= 0 and s not in keep]
            occupied.sort(key=lambda s: (self.last_used[s], self.hits[s]))
            victims = occupied[:need]
            for s in victims:
                del self._slot_of[int(self.tenant[s])]
                self.tenant[s] = -1
                self.evictions += 1
            out.extend(victims)
        return out

    def assign(
        self,
        slots: Sequence[int],
        tenants: Sequence[int],
        tenant_versions: Sequence[int],
        global_version: int,
        tick: int,
    ) -> None:
        """Record freshly solved heads landing in ``slots`` (the device
        scatter already happened in the solve stage)."""
        for s, t, v in zip(slots, tenants, tenant_versions):
            old = int(self.tenant[s])
            if old >= 0 and old != int(t):
                del self._slot_of[old]
                self.evictions += 1
            self.tenant[s] = int(t)
            self.tenant_version[s] = int(v)
            self.global_version[s] = global_version
            self.last_used[s] = tick
            self.hits[s] = 0
            self._slot_of[int(t)] = int(s)
        self.global_slot_version = global_version

    def touch(self, slots: Sequence[int], counts: Sequence[int], tick: int) -> None:
        """Serve-stage recency/popularity update for the gathered slots."""
        for s, c in zip(slots, counts):
            self.last_used[s] = tick
            self.hits[s] += int(c)


class TenantUniverse:
    """A simulated huge tenant id space over a base federation's data.

    Tenant ``t`` is backed by base client ``t % base.n_clients`` — distinct
    tenant identities (distinct cache/slot entries, distinct versions)
    sharing a small pool of actual statistics, which is exactly what a
    serving benchmark needs to stress admission control and eviction at
    millions-of-tenants scale without millions of datasets.  Duck-types
    the :class:`repro_torch.data.pipeline.FederatedDataset` surface the serving
    layers consume (``n_clients``/``client``/``client_sizes``).
    """

    def __init__(self, base, n_tenants: int):
        if n_tenants < base.n_clients:
            raise ValueError(
                f"n_tenants={n_tenants} < base federation size {base.n_clients}"
            )
        self.base = base
        self.n_tenants = int(n_tenants)

    @property
    def n_clients(self) -> int:
        return self.n_tenants

    @property
    def n_classes(self) -> int:
        return self.base.n_classes

    def client(self, k: int):
        return self.base.client(int(k) % self.base.n_clients)

    def client_sizes(self) -> np.ndarray:
        """The BASE sizes — the per-tenant sample-capacity envelope.

        Every tenant's data is one of the base clients', so the base array
        carries the same max/percentiles without materializing an
        ``n_tenants``-long copy; consumers (the serving layers) use it only
        to size the packed-cohort capacity.
        """
        return self.base.client_sizes()
