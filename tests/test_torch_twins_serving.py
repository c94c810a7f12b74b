"""The reference's serving suites as twins on the port (`torch_twins`):
`tests/test_churn_loop.py`, and the serving cases of the suites whose other
cases earlier port files cover: `test_podtrace.py`'s threaded fleet,
`test_racecheck.py`'s race fixes and threaded churn stress,
`test_detcheck.py`'s global-repack dual run, `test_delta_compose.py`'s row
refresh under churn and `test_globalpack.py`'s second customers (the fleet's
rebalance probe with `KARPENTER_SOLVER_GLOBALPACK` off and on, and the
churn harness's repack after a revocation). The fleet, the shard router and
faultline have files of their own (`test_torch_twins_fleet.py`,
`test_torch_twins_shardfleet.py`, `test_torch_twins_faultline.py`).
Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, params_of, reference_cases

MODULES = ("test_churn_loop",)
# the serving classes of suites whose other classes earlier files cover
SERVING_CLASSES = {
    "test_podtrace": ("TestThreadedFleetPodtrace",),
    "test_racecheck": ("TestRaceFixes", "TestThreadedChurnStress"),
    "test_detcheck": ("TestGlobalpackDual",),
    "test_delta_compose": ("TestRowRefresh",),
    "test_globalpack": ("TestSecondCustomers",),
}
CASES = [(m, c) for m in MODULES for c in reference_cases(m)]
CASES += [(m, c) for m, classes in SERVING_CLASSES.items() for c in reference_cases(m, only_classes=classes)]


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)


@pytest.mark.parametrize("module", sorted(SERVING_CLASSES))
def test_every_serving_class_is_covered(module):
    """Each named serving class exists in its suite and has cases."""
    classes = SERVING_CLASSES[module]
    got = {c.split(".")[0] for c in reference_cases(module, only_classes=classes)}
    assert got == set(classes)
