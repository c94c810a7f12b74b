"""The reference's serving suites as twins on the port (`torch_twins`): faultline
(`tests/test_faultline.py`: the circuit breaker, fault specs, the recovery
ladder, prestager supervision, watch-stream faults, the fleet's failure
domains, record/replay with faults, the chaos soak). Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of, params_of

MODULES = ("test_faultline",)
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
