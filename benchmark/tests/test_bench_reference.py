"""The plain reference on small hand-made cases: upstream's fake catalog,
the diverse pods' shares, the packer's rules and each check's count."""

import json

import numpy as np
import pytest
from bench_support import ROOT

from benchmark.inputs import burst
from benchmark.reference import catalog, check, pack, pods

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "sched-bench-2k.json").read_text())
VALUES = CONFIG["mix"]["label_values"]


def test_fake_instance_types():
    rows = catalog.table(400, CONFIG["catalog"])
    assert [r["name"] for r in rows[:2]] == ["fake-it-0", "fake-it-1"]
    first, last = rows[0], rows[-1]
    assert first["alloc"] == (900, 2 * catalog.GI - 10 * catalog.MI, 10)
    assert last["alloc"] == (399_900, 800 * catalog.GI - 10 * catalog.MI, 4000)
    assert first["price"] == pytest.approx(0.1 + 0.1 * 2 * catalog.GI / 1e9)
    cat = catalog.catalog(CONFIG)
    assert cat.offers.all() and cat.zones == ["test-zone-1", "test-zone-2", "test-zone-3"]


def test_diverse_pods_split_evenly_and_the_seed_only_orders_them():
    cfg = dict(CONFIG, pods=1003)
    a, b = burst.pod_specs(cfg, 1), burst.pod_specs(cfg, 2)
    shares = {k: sum(s["kind"] == k for s in a) for k in cfg["mix"]["kinds"]}
    assert shares == {"generic": 203, "zone_spread": 200, "hostname_spread": 200, "zone_affinity": 200,
                      "hostname_anti_affinity": 200}
    strip = lambda specs: sorted(tuple(sorted((k, v) for k, v in s.items() if k not in ("name", "key", "uid")))  # noqa: E731
                                 for s in specs)
    assert strip(a) == strip(b) and [s["uid"] for s in a] != [s["uid"] for s in b]


def spec(i, kind, **kw):
    return dict(key=f"default/p{i}", uid=f"u{i:03d}", kind=kind, cpu_m=kw.pop("cpu_m", 500), mem_b=1 << 28, **kw)


def packed(specs):
    cat = catalog.catalog(CONFIG)
    p = pods.arrays(specs, VALUES)
    return cat, p, pack.pack(cat, p)


def test_anti_affinity_opens_a_claim_each():
    _, _, ref = packed([spec(i, "hostname_anti_affinity") for i in range(3)])
    assert sorted(map(sorted, ref["claims"])) == [[0], [1], [2]]


def test_hostname_spread_keeps_self_matching_pods_apart():
    specs = [spec(0, "hostname_spread", label="a", selects="a"), spec(1, "hostname_spread", label="a", selects="a"),
             spec(2, "hostname_spread", label="b", selects="a")]
    _, _, ref = packed(specs)
    where = {p: c for c, ps in enumerate(ref["claims"]) for p in ps}
    assert where[0] != where[1]
    assert len(ref["claims"]) == 2


def test_zone_spread_pins_the_least_zone_and_affinity_one_zone():
    specs = [spec(i, "zone_spread", label="a", selects="a", cpu_m=1000 - i) for i in range(3)]
    specs += [spec(3 + i, "zone_affinity", group="c", cpu_m=100) for i in range(4)]
    _, _, ref = packed(specs)
    zone_of = {p: int(np.flatnonzero(ref["zones"][c])[0]) for c, ps in enumerate(ref["claims"]) for p in ps
               if ref["zones"][c].sum() == 1}
    assert sorted(zone_of[i] for i in range(3)) == [0, 1, 2]
    assert len({zone_of[i] for i in range(3, 7)}) == 1


def claim(keys, types=("fake-it-9",), zones=None):
    return {"pods": list(keys), "types": list(types), "zones": zones}


@pytest.mark.parametrize("name,specs,claims,unplaced,want", [
    ("lost", [spec(0, "generic", label="a"), spec(1, "generic", label="a")], [claim(["default/p0"])], [], 1),
    ("lost", [spec(0, "generic", label="a")], [claim(["default/p0"]), claim(["default/p0"])], [], 1),
    ("over_capacity", [spec(0, "generic", label="a", cpu_m=1500)], [claim(["default/p0"], ["fake-it-0"])], [], 1),
    ("anti", [spec(0, "hostname_anti_affinity"), spec(1, "hostname_anti_affinity")],
     [claim(["default/p0", "default/p1"])], [], 1),
    ("host_spread", [spec(0, "hostname_spread", label="a", selects="a"),
                     spec(1, "hostname_spread", label="a", selects="a")], [claim(["default/p0", "default/p1"])], [], 1),
    ("host_spread", [spec(0, "hostname_spread", label="b", selects="a"),
                     spec(1, "hostname_spread", label="b", selects="a")], [claim(["default/p0", "default/p1"])], [], 0),
    ("spread_unpinned", [spec(0, "zone_spread", label="a", selects="b")], [claim(["default/p0"])], [], 1),
    ("spread_unpinned", [spec(0, "zone_spread", label="a", selects="b")],
     [claim(["default/p0"], zones=["test-zone-2"])], [], 0),
    ("affinity", [spec(0, "zone_affinity", group="a"), spec(1, "zone_affinity", group="a"),
                  spec(2, "zone_affinity", group="a")],
     [claim(["default/p0", "default/p1"], zones=["test-zone-1"]), claim(["default/p2"], zones=["test-zone-2"])], [], 1),
    ("unplaced", [spec(0, "generic", label="a")], [], ["default/p0"], 1),
])
def test_each_check_counts_its_fault(name, specs, claims, unplaced, want):
    cat = catalog.catalog(CONFIG)
    got = check.check(cat, pods.arrays(specs, VALUES), claims, unplaced, None)
    assert got[name] == want


def test_cost_excess_is_one_sided():
    specs = [spec(0, "generic", label="a", cpu_m=1500)]
    cat, p, ref = packed(specs)
    assert ref["types"][0][0] == "fake-it-1"
    dearer = check.check(cat, p, [claim(["default/p0"], ["fake-it-3"])], [], ref)["cost_excess"]
    assert dearer == pytest.approx(1.0)
    assert check.check(cat, p, [claim(["default/p0"], ["fake-it-1", "fake-it-2"])], [], ref)["cost_excess"] == 0.0
