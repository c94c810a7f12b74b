"""The reference's solverlint suite (`tests/test_solverlint.py`) as twins on
the port (`torch_twins`): the port's analyzer (`karpenter_tpu_torch.analysis`)
over the port's own tree and over the reference's seeded fixtures
(`tests/solverlint_fixtures/`), the CLI's exit codes, the pragma and
stale-pragma machinery, the seeded regressions of the port's store,
encoder and prestager, and the runtime shape contracts and shared-array
freeze of the port's encoder. Tolerance: exact. The port registers the
reference's env knobs, so `TestRuleFixtures.test_env_dependent_branch` runs
as it is; `tests/test_torch_analysis.py` also holds that rule to the port's
own fixture (`tests/torch_solverlint_fixtures/env_branch.py`).

One case cannot run as it is, and a test of the same claim stands in for
it here:

- `TestRuleFixtures.test_unordered_iter_catches_seeded_encode_reverts`
  reverts a sort in `solver/tpu.py`, which the port names `solver/gpu.py`.
  `test_unordered_iter_catches_seeded_reverts` reverts the same sorts in the
  port's `solver/encode.py` and `solver/gpu.py`.
"""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, params_of, reference_cases

MODULES = ("test_solverlint",)
NOT_AS_IS = ("TestRuleFixtures.test_unordered_iter_catches_seeded_encode_reverts",)
CASES = [(m, c) for m in MODULES for c in reference_cases(m) if c not in NOT_AS_IS]


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
    assert set(NOT_AS_IS) <= set(reference_cases("test_solverlint"))


def test_unordered_iter_catches_seeded_reverts(tmp_path):
    from karpenter_tpu_torch.analysis import run_analysis
    from karpenter_tpu_torch.analysis.core import repo_root

    src = (repo_root() / "karpenter_tpu_torch" / "solver" / "encode.py").read_text()
    unsorted_keys = src.replace("for s, k in sorted(matched_keys):", "for s, k in matched_keys:")
    assert unsorted_keys != src
    p = tmp_path / "encode_unsorted_keys.py"
    p.write_text(unsorted_keys)
    findings = run_analysis(rules=["unordered-iteration-escape"], paths=[p])
    # the sentinel pass appears in both the row and column encoders
    assert sum("for-loop iterates a set" in f.message for f in findings) == 2, findings

    unsorted_universe = src.replace("for d in sorted(universe_ids):", "for d in universe_ids:")
    assert unsorted_universe != src
    p2 = tmp_path / "encode_unsorted_universe.py"
    p2.write_text(unsorted_universe)
    findings = run_analysis(rules=["unordered-iteration-escape"], paths=[p2])
    assert len(findings) == 1 and "hash order" in findings[0].message, findings

    gsrc = (repo_root() / "karpenter_tpu_torch" / "solver" / "gpu.py").read_text()
    unsorted_sigs = gsrc.replace("keep[sorted(repair_sigs)] = False", "keep[list(repair_sigs)] = False")
    assert unsorted_sigs != gsrc
    p3 = tmp_path / "gpu_unsorted_sigs.py"
    p3.write_text(unsorted_sigs)
    findings = run_analysis(rules=["unordered-iteration-escape"], paths=[p3])
    assert len(findings) == 1 and "list() materializes" in findings[0].message, findings
