"""Link bandwidths of the aggregation-tree tiers.

The port's copy of the pricing constants of the reference's
``launch/mesh.py``: the bandwidth each tier of an aggregation tree
(:class:`repro_torch.federated.tiers.TierSpec`) is priced at by
:meth:`repro_torch.federated.costs.CostModel.tiered_allreduce` — edge folds
over the fast intra-host interconnect, region crossings over the data-centre
network, cloud crossings over the WAN.  They are the reference's assumed
deployment links, inputs of the cost model, not measurements of any device.

The mesh constructors (``make_host_mesh``, ``make_tier_host_mesh``,
``data_axes``) come with the collective half of ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

ICI_BW = 50e9  # bytes/s per link (~per-chip effective for ring collectives)
DCN_BW = 12.5e9  # bytes/s per pod boundary (~100 Gbps cross-pod effective)
WAN_BW = 1.25e9  # bytes/s cross-region (~10 Gbps effective over WAN)

# Per-tier bandwidth lookup for aggregation trees: edge folds ride ICI,
# region crossings ride DCN, cloud crossings ride the WAN.
TIER_BANDWIDTHS = {"ici": ICI_BW, "dcn": DCN_BW, "wan": WAN_BW}
