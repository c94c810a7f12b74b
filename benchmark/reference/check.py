"""The checks of a placement against the guarantees the configuration
states, and its cost against the reference packer's.

A placement is plain data: `claims`, each {"pods": [pod key], "types":
[instance-type name], "zones": [zone] or None (no zone requirement)}, and
`unplaced`, the pod keys the program reported it could not place. Every
count below reads 0 on a sound placement:

- `lost`: pods of the input placed twice, or neither placed nor reported,
  and placed keys that are no pod of the input;
- `over_capacity`: claims with no instance type, or with a type that
  cannot hold the claim's pods (milli-cores, bytes, pods) or offers none of
  the claim's zones;
- `anti`: app=nginx pods sharing a claim with another;
- `host_spread`: hostname-spread pods that match their own selector,
  beyond one of a value on a claim (the second saw the first: skew 2);
- `spread_unpinned`: zone-spread pods on a claim that may launch in more
  than one zone (their domain undecided);
- `affinity`: zone-affinity pods on a claim not pinned to the zone that
  holds most of their group;
- `unplaced`: pods the program left unplaced beyond those the reference
  packer leaves unplaced (beyond none, without a reference packing).

With a reference packing, `cost_excess` is how far the program's cost
exceeds the reference packer's, as a share of it (0 where it costs no
more), each claim costing its cheapest type's cheapest offering in its
zones."""

from __future__ import annotations

import numpy as np

from .catalog import Catalog
from .pack import claim_price
from .pods import PodArrays


def check(cat: Catalog, pods: PodArrays, claims: list[dict], unplaced: list, ref: dict | None) -> dict:
    index = pods.index
    Z, V = cat.offers.shape[1], pods.n_values
    seen = np.zeros(len(pods.keys), dtype=np.int64)
    lost = over = anti = host_spread = spread_unpinned = 0
    group_zone = np.zeros((V, Z + 1), dtype=np.int64)  # the last column: not pinned
    cost = 0.0
    for c in claims:
        idx = []
        for k in c["pods"]:
            if k in index:
                idx.append(index[k])
            else:
                lost += 1
        idx = np.array(idx, dtype=np.int64)
        seen[idx] += 1
        zm = np.ones(Z, dtype=bool) if c["zones"] is None else np.array([z in c["zones"] for z in cat.zones])
        rows = [cat.index.get(t) for t in c["types"]]
        total = pods.req[idx].sum(0) if len(idx) else np.zeros(3, dtype=np.int64)
        if not rows or any(r is None for r in rows):
            over += 1
            launch = zm
        else:
            rows = np.array(rows)
            over += int(not ((cat.alloc[rows] >= total).all(-1) & (cat.offers[rows] & zm).any(-1)).all())
            cost += claim_price(cat, c["types"], zm)
            launch = zm & cat.offers[rows].any(0)
        if not len(idx):
            continue
        anti += max(0, int(pods.anti[idx].sum()) - 1)
        own = pods.host_sel[idx]
        own = own[(own >= 0) & (own == pods.label[idx])]
        host_spread += int(len(own) - len(np.unique(own)))
        if launch.sum() != 1:
            spread_unpinned += int((pods.zone_sel[idx] >= 0).sum())
        g = pods.group[idx]
        np.add.at(group_zone, (g[g >= 0], int(np.flatnonzero(launch)[0]) if launch.sum() == 1 else Z), 1)
    missing = [k for k in unplaced if k in index]
    seen[[index[k] for k in missing]] += 1
    lost += int((seen != 1).sum()) + (len(unplaced) - len(missing))
    affinity = int(sum(row.sum() - row[:Z].max() for row in group_zone))
    out = {"lost": lost, "over_capacity": over, "anti": anti, "host_spread": host_spread,
           "spread_unpinned": spread_unpinned, "affinity": affinity,
           "unplaced": len(missing) - (len(ref["unplaced"]) if ref is not None else 0)}
    if ref is not None:
        out["cost_excess"] = max(0.0, cost / ref["cost"] - 1.0) if ref["cost"] > 0 else float(cost > 0)
    return out
