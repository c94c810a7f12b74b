"""The reference's serving suites as twins on the port (`torch_twins`): the fleet
front-end (`tests/test_fleet.py`: tenant labels, the batcher's eta and wake
hook, push wake, coalescing through the fleet, push/poll parity, shared kernel
shapes and the isolation audit, fairness, record/replay into tenants, the
threaded serve loop under the race sanitizer). Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of, params_of

MODULES = ("test_fleet",)
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
