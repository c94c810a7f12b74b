"""One run of a cell on the CPU, end to end: the last line's form, the
compared numbers on stderr, the cell found from new files alone, the
refusal without a card, and the modules the run may not load."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys

import pytest
from bench_support import ROOT, run_cell

from benchmark import harness, manifest

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line():
    workload = "sched2k.burst"
    rc, line, err = run_cell(workload)
    assert rc == 0
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    m = manifest.load(ROOT)
    assert set(line["metrics"]) == {x["name"] for x in manifest.reported(m, workload)}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert [t.split()[1] for t in tail] == list(line["compared"])
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


def test_traced_line_has_layer_metrics():
    rc, line, _ = run_cell("sched2k.burst", trace=1)
    assert rc == 0 and line["correct"] is True
    m = manifest.load(ROOT)
    allowed = {x["name"] for x in manifest.layer_metrics(m, "sched2k.burst")}
    assert set(line["metrics"]) <= allowed
    # the spans exist on the CPU; the device's numbers come from a card only
    assert {"encode_ms.burst", "pack_ms.burst", "decode_ms.burst", "residual_ms.burst"} <= set(line["metrics"])
    assert not {"pack_scan_roofline", "idle_pct.burst"} & set(line["metrics"])


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_need_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root)
    home = root / "benchmark"
    cfg = json.loads((home / "configs" / "sched-bench-2k.json").read_text())
    cfg.update(name="sched-small", pods=300)
    (home / "configs" / "sched-small.json").write_text(json.dumps(cfg))
    (home / "traffic" / "burst_one.json").write_text(json.dumps({"kind": "burst", "warm_solves": 1}))
    (home / "limits" / "small.burst.json").write_text((home / "limits" / "sched2k.burst.json").read_text())
    (home / "metrics" / "solves.small.py").write_text("def read(ctx):\n    return ctx.get('solves')\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "sched-small", "source": "a test", "file": "benchmark/configs/sched-small.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "small.burst", "config": "sched-small", "traffic": "burst_one", "chips": 1,
                           "why": "a test"})
    next(x for x in m["end_to_end"] if x["name"] == "pods_per_s")["workloads"].append("small.burst")
    m["per_layer"].append({"name": "solves.small", "unit": "solves", "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "pods_per_s", "workloads": ["small.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.problems(m, root) == []
    after = digest(root)
    assert all(after[k] == v for k, v in before.items() if k.name != "BENCHMARK.json")
    rc, line, _ = run_cell("small.burst", trace=1, root=root, overrides={})
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["solves.small"]["value"] >= 1


def test_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "sched2k.burst", "--seed", "3", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_refuses_in_a_tree_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sched2k.burst", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("names,found", [
    (["karpenter_tpu_torch", "karpenter_tpu_torch.solver.gpu", "jaxtyping", "flaxen"], []),
    (["jax.numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["karpenter_tpu.solver.tpu", "karpenter_tpu_torch"], ["karpenter_tpu"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert harness.forbidden_modules(names) == found


def test_the_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "from benchmark.kinds import burst\n"
            "import karpenter_tpu_torch.solver.gpu, karpenter_tpu_torch.kernels.pack_scan\n"
            "print(harness.forbidden_modules())\n") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "numpy"}
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= allowed, path
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] in allowed, path


def test_a_run_pins_itself_to_one_core():
    code = ("import os, sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "allowed = os.sched_getaffinity(0)\n"
            "core = harness.pin_to_one_core()\n"
            "print(core == max(allowed), os.sched_getaffinity(0) == {core})\n") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["True", "True"]
