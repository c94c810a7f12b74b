"""The reference's capacity suites (`tests/test_nodeoverlay.py`, `test_cost.py`,
`test_static.py`, `test_registration_hooks.py`) as twins on the port (`torch_twins`): the
reference's own assertions hold in the twin, and every tick's canonical
store, events and registry equal the reference's. Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of

MODULES = ("test_nodeoverlay", "test_cost", "test_static", "test_registration_hooks")
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m}::{c}" for m, c in CASES])
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
