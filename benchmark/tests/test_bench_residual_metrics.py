"""The readers of the host residual's split and of the collector's pauses:
each a mean per solve over the program's spans and totals, None where the
program records none; a traced CPU run's line carries them."""

import pytest
from bench_support import ROOT, run_cell

from benchmark import manifest

NEW = ("residual_prep_ms.burst", "residual_queue_ms.burst", "inflight_ms.burst", "new_claim_ms.burst",
       "gc_ms.burst")

STAGES = [
    {"residual": 100.0, "seam_records": 1.0, "ffd_adopt": 4.0, "ffd_prepare": 5.0, "ffd_queue": 88.0,
     "ffd.existing": 2.0, "ffd.inflight": 80.0, "ffd.new_claim": 3.0, "gc0": 1.0, "gc2": 9.0},
    {"residual": 60.0, "seam_records": 2.0, "ffd_adopt": 2.0, "ffd_prepare": 4.0, "ffd_queue": 50.0,
     "ffd.existing": 1.0, "ffd.inflight": 40.0, "ffd.new_claim": 5.0, "gc1": 2.0},
    {"encode": 5.0},
]


@pytest.mark.parametrize("name,want", [
    ("residual_prep_ms.burst", (10.0 + 8.0) / 2),
    ("residual_queue_ms.burst", (88.0 + 50.0) / 2),
    ("inflight_ms.burst", (80.0 + 40.0) / 2),
    ("new_claim_ms.burst", (3.0 + 5.0) / 2),
    # every solve counts, the one with no pause as 0
    ("gc_ms.burst", (10.0 + 2.0 + 0.0) / 3),
])
def test_reader_means_per_solve(name, want):
    read = manifest.reader(ROOT, name)
    assert read({"stages": STAGES}) == pytest.approx(want)
    # a program that records none of these reads nothing, and raises nothing
    assert read({"stages": [{"residual": 100.0, "encode": 5.0}]}) is None
    assert read({"stages": []}) is None and read({}) is None


def test_the_new_metrics_are_in_the_manifest_and_it_has_no_problems():
    m = manifest.load(ROOT)
    assert manifest.problems(m, ROOT) == []
    entries = {x["name"]: x for x in m["per_layer"]}
    for name in NEW:
        x = entries[name]
        assert (x["unit"], x["better"], x["moves"], x["workloads"]) == ("ms", "lower", "pods_per_s", ["sched2k.burst"])
        assert x["layer"] == ("collector" if name == "gc_ms.burst" else "hybrid residual")
    assert [x["name"] for x in m["per_layer"][-len(NEW):]] == list(NEW)


def test_traced_line_splits_the_residual():
    rc, line, _ = run_cell("sched2k.burst", trace=1)
    assert rc == 0 and line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["residual_prep_ms.burst"] + got["residual_queue_ms.burst"] <= got["residual_ms.burst"]
    assert got["inflight_ms.burst"] + got["new_claim_ms.burst"] <= got["residual_queue_ms.burst"]
