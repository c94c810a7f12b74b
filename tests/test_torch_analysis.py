"""The port's linter (`karpenter_tpu_torch.analysis`: solverlint and detlint,
15 rules) against the reference's (`karpenter_tpu.analysis`), on the CPU.

- On each of the reference's seeded fixtures (`tests/solverlint_fixtures/`),
  each rule of the port reports the reference rule's findings: the same
  lines, rule names and messages (the port's messages name its own
  pyproject table, `[tool.solverlint-torch]`, and its own modules, where
  the reference's name `[tool.solverlint]` and the JAX package's). The
  port registers the reference's knobs, so on `env_branch.py` too its
  findings are the reference's exactly.
- The rules that name JAX in the reference have torch counterparts, held to
  fixtures of the port's own (`tests/torch_solverlint_fixtures/`), with the
  lines each must report stated below: the host copies `.cpu()`,
  `.numpy()`, `.tolist()` and the kernel wrappers' outputs
  (host-sync-in-hot-path), torch's global generator
  (wallclock-and-rng-in-solve-path), the knobs the port reads
  (env-dependent-branch) and torch's device syncs under a lock
  (lock-order).
- `python -m karpenter_tpu_torch.analysis` exits 0 over the port (json
  output, no finding), `--self-test` exits 0 with 15 rules, a shrunken
  registry exits 2, and the configuration names the port's modules and
  reads `[tool.solverlint-torch]`, never `[tool.solverlint]`.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from karpenter_tpu.analysis import run_analysis as ref_run_analysis
from karpenter_tpu_torch.analysis import RULES, run_analysis
from karpenter_tpu_torch.analysis import rules as port_rules
from karpenter_tpu_torch.analysis.__main__ import main as lint_main
from karpenter_tpu_torch.analysis.config import Config, ConfigError, load_config
from karpenter_tpu_torch.analysis.core import _match_globs, repo_root

ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = Path(__file__).parent / "solverlint_fixtures"
TORCH_FIXTURES = Path(__file__).parent / "torch_solverlint_fixtures"

# each rule and the reference fixture that seeds it
FIXTURE_OF = {
    "shared-array-mutation": "shared_mutation.py",
    "host-sync-in-hot-path": "host_sync.py",
    "python-loop-over-pod-axis": "pod_loop.py",
    "reason-family-tiers": "fallback_registry.py",
    "metric-label-cardinality": "metric_labels.py",
    "guarded-field-access": "guarded_field.py",
    "lock-order": "lock_order.py",
    "thread-escape": "thread_escape.py",
    "bare-thread-primitive": "bare_primitive.py",
    "swallowed-exception": "swallowed_exception.py",
    "unordered-iteration-escape": "unordered_iter.py",
    "wallclock-and-rng-in-solve-path": "wallclock_rng.py",
    "float-reduction-order": "float_order.py",
    "env-dependent-branch": "env_branch.py",
    "stale-pragma": "stale_pragma.py",
}

# the findings the port's own fixtures must give: (line, words of the message)
TORCH_EXPECTED = {
    ("host-sync-in-hot-path", "host_sync.py"): [
        (16, ".item() host-syncs"),
        (21, ".cpu() copies"),
        (26, ".tolist() copies"),
        (31, ".numpy() copies"),
        (36, "int() coerces"),
        (41, "np.asarray() lands"),
    ],
    ("wallclock-and-rng-in-solve-path", "wallclock_rng.py"): [
        (21, "torch.rand() draws from torch's global RNG"),
        (25, "th.randint() draws from torch's global RNG"),
        (29, "sneaky_randperm() draws from torch's global RNG"),
        (33, "time.perf_counter() reads the wallclock"),
    ],
    ("env-dependent-branch", "env_branch.py"): [
        (16, "'KARPENTER_SOLVER_SECRET'"),
        (21, "'SOLVER_EXPERIMENT'"),
        (25, "'SOLVER_FORK_BEHAVIOR'"),
        (29, "'SOLVER_TUNING'"),
        (33, "'UNREVIEWED_KNOB'"),
        (37, "'SOLVER_FAST_PATH'"),
        (41, "non-literal key"),
        (45, "bulk os.environ read"),
    ],
    ("lock-order", "lock_order.py"): [
        (21, "blocking call torch.cuda.synchronize() while holding FixtureSync._lock"),
        (25, "blocking call event.synchronize() while holding FixtureSync._lock"),
    ],
}


def view(findings) -> list[tuple]:
    """Findings as (line, rule, message), the port's table and package names
    read as the reference's."""
    return sorted((f.line, f.rule, f.message.replace("[tool.solverlint-torch]", "[tool.solverlint]")
                   .replace("karpenter_tpu_torch/", "karpenter_tpu/")) for f in findings)


def test_every_rule_has_a_reference_fixture():
    assert sorted(FIXTURE_OF) == sorted(RULES) and len(RULES) == 15
    assert sorted(FIXTURE_OF.values()) == sorted(p.name for p in REF_FIXTURES.glob("*.py"))


@pytest.mark.parametrize("rule", sorted(FIXTURE_OF))
def test_rule_reproduces_reference_findings(rule):
    fixture = REF_FIXTURES / FIXTURE_OF[rule]
    want = view(ref_run_analysis(rules=[rule], paths=[fixture]))
    got = view(run_analysis(rules=[rule], paths=[fixture]))
    assert want, f"{rule}: the reference reports nothing on its own fixture"
    assert got == want


@pytest.mark.parametrize("rule,fixture", sorted(TORCH_EXPECTED))
def test_torch_fixture(rule, fixture):
    path = TORCH_FIXTURES / fixture
    found = sorted((f.line, f.message) for f in run_analysis(rules=[rule], paths=[path]))
    want = TORCH_EXPECTED[(rule, fixture)]
    assert [ln for ln, _m in found] == [ln for ln, _w in want], found
    for (ln, msg), (_ln, words) in zip(found, want):
        assert words in msg, (ln, msg)
    src = path.read_text().splitlines()
    for ln, _msg in found:
        assert "solverlint: ok" not in src[ln - 1]
    # every function named ok_ stays clean, every bad_ one has a finding
    fns = [(i, text.split("(")[0].split()[-1]) for i, text in enumerate(src, 1) if text.lstrip().startswith("def ")]
    ends = [i for i, _ in fns[1:]] + [len(src) + 1]
    for (start, name), end in zip(fns, ends):
        hits = [ln for ln, _ in found if start <= ln < end]
        if name.startswith("ok_"):
            assert not hits, (name, hits)
        elif name.startswith("bad_"):
            assert hits, name


def test_torch_fixture_suppressions_are_used():
    """Each pragma of the port's fixtures suppresses a live finding of its
    rule (no stale pragma among them)."""
    for path in sorted(TORCH_FIXTURES.glob("*.py")):
        assert run_analysis(rules=["stale-pragma"], paths=[path]) == [], path.name


def test_cli_is_clean_over_the_port():
    proc = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.analysis", "--format", "json", "--jobs", "4"],
                          capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = json.loads(proc.stdout)
    assert payload["count"] == 0 and payload["findings"] == []
    assert payload["rules"] == sorted(RULES) and len(payload["rules"]) == 15


def test_cli_self_test():
    proc = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.analysis", "--self-test"], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "15 rules healthy" in proc.stdout


def test_shrunken_registry_exits_two(monkeypatch):
    monkeypatch.delitem(port_rules.RULES, "stale-pragma")
    assert lint_main(["--self-test"]) == 2
    assert lint_main([str(ROOT / "karpenter_tpu_torch" / "solver" / "ffd.py")]) == 2


def test_config_names_the_port():
    cfg = load_config(repo_root())
    assert repo_root() == ROOT
    assert "karpenter_tpu_torch/solver/gpu.py" in cfg.tensor_modules
    assert cfg.shared_field_registry.startswith("karpenter_tpu_torch/solver/encode.py:")
    globbed = [g for f in (cfg.tensor_modules, cfg.metrics_modules, cfg.thread_modules, cfg.exception_modules,
                           cfg.det_modules, cfg.solve_path_modules, cfg.float_order_modules) for g in f]
    globbed += [cfg.fallback_module, cfg.racecheck_module, cfg.thread_inventory_doc]
    assert all(g.startswith("karpenter_tpu_torch/") for g in globbed)
    for name, cls in RULES.items():
        assert _match_globs(ROOT, cls().globs(cfg)), f"{name} scans nothing"
    assert not any(p.startswith(("jax", "jnp", "lax")) for p in cfg.device_producers)
    assert "synchronize" in cfg.lock_blocking_calls
    # the reference's registered knobs, in its order
    from karpenter_tpu.analysis.config import Config as RefConfig

    assert cfg.env_knobs == RefConfig().env_knobs


def test_config_reads_its_own_table(tmp_path):
    """`[tool.solverlint]` (the reference's, naming its paths) is never
    read; `[tool.solverlint-torch]` overrides key by key, and a wrong key or
    type is a configuration error (exit 2)."""
    (tmp_path / "pyproject.toml").write_text(
        '[tool.solverlint]\ntensor-modules = ["karpenter_tpu/solver/tpu.py"]\nmax-label-values = 3\n'
        '[tool.solverlint-torch]\nmax-label-values = 4\n')
    cfg = load_config(tmp_path)
    assert cfg.tensor_modules == Config().tensor_modules and cfg.max_label_values == 4
    (tmp_path / "pyproject.toml").write_text('[tool.solverlint-torch]\nno-such-key = 1\n')
    with pytest.raises(ConfigError, match="no-such-key"):
        load_config(tmp_path)
    assert lint_main(["--root", str(tmp_path)]) == 2
    (tmp_path / "pyproject.toml").write_text('[tool.solverlint-torch]\nmax-label-values = "4"\n')
    with pytest.raises(ConfigError, match="max-label-values"):
        load_config(tmp_path)
