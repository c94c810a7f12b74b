"""`BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by its name:

- a configuration: the `file` its entry names (`configs/<name>.json`);
- a traffic mix: `traffic/<traffic>.json`, a data file naming its kind
  (`kinds/<kind>.py`, the code that reads it), the kind's parameters and, under
  `env`, any of the program's switches the mix sets;
- a cell's correctness limits: `limits/<cell>.json`;
- a per-layer metric: `metrics/<name>.py`, whose `read(ctx)` returns the
  value or None when the cell gives it nothing to read.

So a later change adds a configuration, a mix, a cell or a metric with new
files and new entries, and edits no file that is there."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def problems(m: dict, root: Path) -> list[str]:
    """What in the manifest breaks the contract's form (empty when none)."""
    out = []
    home = root / "benchmark"

    def need(cond, what):
        if not cond:
            out.append(what)

    need(set(m) == TOP_KEYS, f"top-level keys {sorted(m)}")
    need(isinstance(m.get("command"), list) and 1 <= len(m["command"]) <= 32
         and all(_line(w) for w in m["command"]), "command")
    paths = m.get("paths", [])
    need(1 <= len(paths) <= 16 and all(PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
                                       for p in paths), "paths")
    need(isinstance(m.get("run_seconds"), int) and 1 <= m["run_seconds"] <= 51, "run_seconds")
    names: set = set()
    configs = {c.get("name"): c for c in m.get("configs", [])}
    need(1 <= len(configs) == len(m.get("configs", [])) <= 24, "configs count or duplicate names")
    for c in m.get("configs", []):
        need(set(c) == CONFIG_KEYS, f"config keys {sorted(c)}")
        need(bool(NAME.fullmatch(str(c.get("name")))), f"config name {c.get('name')!r}")
        need(_line(c.get("source")) and _line(c.get("why")), f"config {c.get('name')}: source or why")
        need(len(c.get("reduced", [])) <= 16 and all(NAME.fullmatch(k) for k in c.get("reduced", [])),
             f"config {c.get('name')}: reduced")
        f = c.get("file", "")
        need(any(f.startswith(p.rstrip("/") + "/") for p in paths) and (root / f).is_file(),
             f"config {c.get('name')}: file {f!r}")
        names.add(c.get("name"))
    cells = m.get("workloads", [])
    need(1 <= len(cells) <= 24, "workloads count")
    pairs = set()
    for w in cells:
        need(set(w) == CELL_KEYS, f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            need(bool(NAME.fullmatch(str(w.get(k)))), f"workload {k} {w.get(k)!r}")
        need(w.get("config") in configs, f"workload {w.get('name')}: config {w.get('config')!r}")
        need(w.get("chips") in (1, 4), f"workload {w.get('name')}: chips")
        need(_line(w.get("why")), f"workload {w.get('name')}: why")
        need((home / "traffic" / f"{w.get('traffic')}.json").is_file(), f"workload {w.get('name')}: traffic file")
        need((home / "limits" / f"{w.get('name')}.json").is_file(), f"workload {w.get('name')}: limits file")
        pairs.add((w.get("config"), w.get("traffic")))
    need(len(pairs) == len(cells), "a pair of configuration and traffic appears twice")
    need(sum(w.get("chips") == 4 for w in cells) <= max(1, len(cells) // 4), "too many four-chip cells")
    need({w.get("config") for w in cells} == set(configs), "a configuration no cell uses")
    cell_names = [w.get("name") for w in cells]
    need(len(set(cell_names)) == len(cell_names), "duplicate workload names")
    metric_names = []
    e2e = m.get("end_to_end", [])
    need(1 <= len(e2e) <= 16 and any(x.get("name") == "setup_s" for x in e2e), "end_to_end")
    for x in e2e:
        need(set(x) - {"workloads"} == E2E_KEYS, f"end_to_end keys {sorted(x)}")
        need(x.get("source") in ("host_clock", "device_trace"), f"{x.get('name')}: source")
        need(isinstance(x.get("bound"), (int, float)) and 0 < x["bound"] <= 0.25, f"{x.get('name')}: bound")
    layers = m.get("per_layer", [])
    need(1 <= len(layers) <= 128, "per_layer count")
    e2e_names = {x.get("name") for x in e2e}
    for x in layers:
        need(set(x) - {"workloads"} == LAYER_KEYS, f"per_layer keys {sorted(x)}")
        need(x.get("source") in SOURCES, f"{x.get('name')}: source")
        need(_line(x.get("layer")), f"{x.get('name')}: layer")
        need(x.get("moves") in e2e_names, f"{x.get('name')}: moves {x.get('moves')!r}")
        need((home / "metrics" / f"{x.get('name')}.py").is_file(), f"{x.get('name')}: no reader file")
        for w in x.get("workloads", []):
            need(w in cell_names and x.get("moves") in {e.get("name") for e in reported(m, w)},
                 f"{x.get('name')}: cell {w} does not report {x.get('moves')}")
    for x in e2e + layers:
        metric_names.append(x.get("name"))
        need(bool(NAME.fullmatch(str(x.get("name")))), f"metric name {x.get('name')!r}")
        need(bool(UNIT.fullmatch(str(x.get("unit")))), f"{x.get('name')}: unit {x.get('unit')!r}")
        need(x.get("better") in ("lower", "higher"), f"{x.get('name')}: better")
        for w in x.get("workloads", []):
            need(w in cell_names, f"{x.get('name')}: workload {w!r}")
    need(len(set(metric_names)) == len(metric_names), "duplicate metric names")
    for w in cell_names:
        rep = [e.get("name") for e in reported(m, w)]
        need("setup_s" in rep and len(rep) >= 2, f"{w}: end-to-end metrics {rep}")
        need(bool(layer_metrics(m, w)), f"{w}: no per-layer metric")
    need(len(json.dumps(m)) <= 64 * 1024, "manifest size")
    return out


def _in(x: dict, cell: str) -> bool:
    return "workloads" not in x or cell in x["workloads"]


def reported(m: dict, cell: str) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    return [x for x in m["end_to_end"] if _in(x, cell)]


def layer_metrics(m: dict, cell: str) -> list[dict]:
    """The per-layer metrics a cell's traced run reports: those listing it,
    and those without a list whose end-to-end metric the cell reports."""
    e2e = {x["name"] for x in reported(m, cell)}
    return [x for x in m["per_layer"] if cell in x.get("workloads", ()) or ("workloads" not in x and x["moves"] in e2e)]


def cell(m: dict, root: Path, name: str) -> dict:
    """A cell with everything its run needs: its configuration (the file's
    contents), its traffic mix, its limits, and its metrics."""
    w = next(x for x in m["workloads"] if x["name"] == name)
    c = next(x for x in m["configs"] if x["name"] == w["config"])
    return {
        "config": json.loads((root / c["file"]).read_text()),
        "traffic": json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text()),
        "end_to_end": reported(m, name),
        "per_layer": layer_metrics(m, name),
    }


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """The `read(ctx)` of the per-layer metric `name`."""
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", "benchmark_metric_" + re.sub(r"\W", "_", name)).read


def kind(name: str):
    """The module of a kind of traffic, `kinds/<name>.py`."""
    return importlib.import_module(f"benchmark.kinds.{name}")
