"""Upstream's fake instance types (`fake.InstanceTypes(n)` of
`pkg/cloudprovider/fake/instancetype.go`, the catalog upstream's scheduling
benchmark builds) as a plain table, from the rules the configuration's
`catalog` states:

- type i (0-based) is `fake-it-<i>` with i+1 vCPUs, 2(i+1) GiB of memory and
  room for 10(i+1) pods; amd64; linux, windows and darwin;
- offerings: spot in the `spot_zones`, on demand in every zone, each at the
  price 0.1 per vCPU plus 0.1 per 10^9 bytes of memory;
- kube-reserved 100m of CPU and 10Mi of memory come off the capacity."""

from __future__ import annotations

import numpy as np

MI = 1 << 20
GI = 1 << 30


def table(count: int, spec: dict) -> list[dict]:
    """`count` instance types, in the generator's order: name, vCPUs, memory
    in bytes, zones, the spot zones, the price and the allocatable
    (milli-cores, bytes, pods)."""
    out = []
    for i in range(count):
        cpu = i + 1
        mem = spec["memory_gib_per_cpu"] * cpu * GI
        pods = spec["pods_per_cpu"] * cpu
        price = spec["price_per_cpu"] * cpu + spec["price_per_gb"] * mem / 1e9
        alloc = (cpu * 1000 - spec["kube_reserved_cpu_m"], mem - spec["kube_reserved_memory_mi"] * MI, pods)
        out.append(dict(name=f"fake-it-{i}", cpu=cpu, mem_b=mem, pods=pods, zones=list(spec["zones"]),
                        spot_zones=list(spec["spot_zones"]), price=price, alloc=alloc))
    return out


class Catalog:
    """The table as arrays: `alloc` [T, 3] (milli-cores, bytes, pods),
    `price` [T, Z] (the cheapest offering of each zone, inf where none),
    `offers` [T, Z], and the names and zones."""

    def __init__(self, rows: list[dict], zones: list[str]):
        self.rows = rows
        self.zones = list(zones)
        self.names = [r["name"] for r in rows]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.alloc = np.array([r["alloc"] for r in rows], dtype=np.int64)
        self.price = np.full((len(rows), len(zones)), np.inf)
        for t, r in enumerate(rows):
            for z in r["zones"]:
                self.price[t, self.zones.index(z)] = r["price"]
        self.offers = np.isfinite(self.price)


def catalog(config: dict) -> Catalog:
    spec = config["catalog"]
    return Catalog(table(config["instance_types"], spec), spec["zones"])
