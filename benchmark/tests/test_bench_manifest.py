"""BENCHMARK.json against the contract's form, and the form checks
themselves."""

import copy
import json

import pytest
from bench_support import ROOT

from benchmark import manifest


def repo_manifest() -> dict:
    return manifest.load(ROOT)


def test_repo_manifest_has_no_problems():
    assert manifest.problems(repo_manifest(), ROOT) == []


@pytest.mark.parametrize("name,ok", [
    ("sched2k.burst", True), ("pods_per_s", True), ("_x-1.y", True), ("a" * 64, True),
    ("a" * 65, False), ("has space", False), ("a,b", False), ("a/b", False), (".lead", False), ("mü", False),
])
def test_name_characters(name, ok):
    assert bool(manifest.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("pods/s", True), ("%", True), ("ms", True), ("events/s", True), ("tokens per second", False),
    ("µs", False), ("", False), ("a" * 17, False),
])
def test_unit_characters(unit, ok):
    assert bool(manifest.UNIT.fullmatch(unit)) is ok


def broken(edit) -> list:
    m = copy.deepcopy(repo_manifest())
    edit(m)
    return manifest.problems(m, ROOT)


@pytest.mark.parametrize("what,edit", [
    ("space in a metric name", lambda m: m["end_to_end"][0].update(name="pods per s")),
    ("unit with a space", lambda m: m["end_to_end"][0].update(unit="pods per s")),
    ("no setup_s", lambda m: m["end_to_end"].pop()),
    ("bound over 0.25", lambda m: m["end_to_end"][0].update(bound=0.3)),
    ("run_seconds over 51", lambda m: m.update(run_seconds=52)),
    ("an extra key on a metric", lambda m: m["per_layer"][0].update(why="x")),
    ("a cell naming no configuration", lambda m: m["workloads"][0].update(config="nope")),
    ("a traffic mix without its file", lambda m: m["workloads"][0].update(traffic="nope")),
    ("a per-layer metric without its reader", lambda m: m["per_layer"][0].update(name="nope.nope")),
    ("moves an unknown metric", lambda m: m["per_layer"][0].update(moves="nope")),
    ("a duplicate cell", lambda m: m["workloads"].append(dict(m["workloads"][0]))),
    ("three chips", lambda m: m["workloads"][0].update(chips=3)),
    ("a config file outside paths", lambda m: m["configs"][0].update(file="BENCHMARK.json")),
    ("a why with a newline", lambda m: m["workloads"][0].update(why="a\nb")),
])
def test_problems_are_found(what, edit):
    assert broken(edit), what


def test_every_cell_reports_setup_and_another_and_a_layer():
    m = repo_manifest()
    for w in m["workloads"]:
        names = [x["name"] for x in manifest.reported(m, w["name"])]
        assert "setup_s" in names and len(names) >= 2
        assert manifest.layer_metrics(m, w["name"])
        assert w["chips"] == 1


def test_configs_name_their_source_and_cuts():
    m = repo_manifest()
    for c in m["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert data["source"] and data["assumed"]
