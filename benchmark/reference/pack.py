"""A plain first-fit-decreasing packer with upstream's scheduling rules.

Pods in upstream's queue order (CPU, then memory, descending; ties by
uid); each tries the open claims fewest pods first (ties by age) and goes
on the first that keeps an instance type with room for it and passes the
pod's constraints, else opens a claim over every type that holds it:

- zone spread (maxSkew 1): a zone is valid where the count of pods the
  selector matches, plus one for a pod that matches its own selector, is at
  most one over the least zone's count; the claim is pinned to the valid
  zone with the least count among its zones (the first on a tie);
- hostname spread (maxSkew 1): a claim takes the pod while it holds no
  more than one matched pod, none for a pod that matches itself;
- zone pod affinity: the zones already holding a pod of the group, or, for
  the group's first pod, the claim's first zone;
- hostname anti-affinity: a claim holds one app=nginx pod.

A zone counts a pod when its claim is pinned to that zone as it lands;
a claim counts every pod it holds. A claim costs its cheapest remaining
type's cheapest offering in its zones.

`quantum` is the control's lower precision: requests are rounded down to
multiples of it (milli-cores, bytes, pods) before packing."""

from __future__ import annotations

import numpy as np

from .catalog import Catalog
from .pods import PodArrays


def order(pods: PodArrays) -> list:
    return sorted(range(len(pods.uids)), key=lambda i: (-int(pods.req[i, 0]), -int(pods.req[i, 1]), pods.uids[i]))


def _pin(zones: np.ndarray, counts: np.ndarray | None) -> np.ndarray:
    """One zone of `zones`: the least count's first, or the first."""
    on = np.flatnonzero(zones)
    z = on[0] if counts is None else on[np.argmin(counts[on])]
    out = np.zeros_like(zones)
    out[z] = True
    return out


def pack(cat: Catalog, pods: PodArrays, quantum=(1, 1, 1)) -> dict:
    """Returns {"claims": [[pod index, ...]], "types": [[type name, ...]],
    "zones": [bool [Z]], "unplaced": [pod index], "cost": float}."""
    q = np.array(quantum, dtype=np.int64)
    req = (pods.req // q) * q
    P, (T, Z), V = len(pods.uids), cat.offers.shape, pods.n_values
    used = np.zeros((P, 3), dtype=np.int64)
    room = np.zeros((P, 3), dtype=np.int64)  # per resource, the most a remaining type has left
    types = np.zeros((P, T), dtype=bool)
    zones = np.zeros((P, Z), dtype=bool)
    npods = np.zeros(P, dtype=np.int64)
    labels = np.zeros((P, V), dtype=np.int64)
    nginx = np.zeros(P, dtype=bool)
    zcount = np.zeros((V, Z), dtype=np.int64)
    gcount = np.zeros((V, Z), dtype=np.int64)
    members: list[list] = []
    unplaced = []
    for p in order(pods):
        r, lab, zs, hs, g = req[p], pods.label[p], pods.zone_sel[p], pods.host_sel[p], pods.group[p]
        spread_counts = None
        valid = np.ones(Z, dtype=bool)
        if zs >= 0:
            spread_counts = zcount[zs] + (lab == zs)
            valid = spread_counts - zcount[zs].min() <= 1
        elif g >= 0 and gcount[g].any():
            valid = gcount[g] > 0
        n = len(members)
        cand = (room[:n] >= r).all(-1) & (zones[:n] & valid).any(-1)
        if hs >= 0:
            cand &= labels[:n, hs] + (lab == hs) <= 1
        if pods.anti[p]:
            cand &= ~nginx[:n]
        b = None
        for c in np.flatnonzero(cand)[np.lexsort((np.flatnonzero(cand), npods[:n][cand]))]:
            zb = zones[c] & valid
            free = types[c] & (cat.alloc >= used[c] + r).all(-1) & (cat.offers & zb).any(-1)
            if free.any():
                b = int(c)
                break
        if b is None:
            zb = valid.copy()
            free = (cat.alloc >= r).all(-1) & (cat.offers & zb).any(-1)
            if not free.any():
                unplaced.append(p)
                continue
            b = n
            members.append([])
        if zs >= 0:
            zb = _pin(zb & cat.offers[free].any(0), spread_counts)
        elif g >= 0 and not gcount[g].any():
            zb = _pin(zb & cat.offers[free].any(0), None)
        free &= (cat.offers & zb).any(-1)
        used[b] += r
        types[b] = free
        zones[b] = zb & cat.offers[free].any(0)
        room[b] = cat.alloc[free].max(0) - used[b]
        npods[b] += 1
        members[b].append(p)
        nginx[b] |= pods.anti[p]
        pinned = np.flatnonzero(zones[b])
        if lab >= 0:
            labels[b, lab] += 1
            if len(pinned) == 1:
                zcount[lab, pinned[0]] += 1
        if g >= 0 and len(pinned) == 1:
            gcount[g, pinned[0]] += 1
    n = len(members)
    out_types = [[cat.names[t] for t in np.flatnonzero(types[b])] for b in range(n)]
    cost = float(sum(claim_price(cat, out_types[b], zones[b]) for b in range(n)))
    return {"claims": members, "types": out_types, "zones": [zones[b] for b in range(n)], "unplaced": unplaced,
            "cost": cost}


def claim_price(cat: Catalog, types: list, zones: np.ndarray) -> float:
    """The cheapest offering of the named types in the zones (inf when none)."""
    rows = [cat.index[t] for t in types]
    if not rows:
        return float("inf")
    return float(np.where(zones[None, :], cat.price[rows], np.inf).min())
