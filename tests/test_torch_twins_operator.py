"""The reference's operator suites as twins on the port (`torch_twins`):
`tests/test_operator.py` (leader election, the server, the run loop, the
options), `test_e2e_provisioning.py` and `test_provisioning_depth.py`.
Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of

MODULES = ("test_operator", "test_e2e_provisioning", "test_provisioning_depth")
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m}::{c}" for m, c in CASES])
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
