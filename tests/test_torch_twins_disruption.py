"""The reference's disruption and metrics suites through the operator
(`tests/test_disruption.py`, `test_metrics_events.py`) as twins on the port (`torch_twins`): the
reference's own assertions hold in the twin, and every tick's canonical
store, events and registry equal the reference's. Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of

MODULES = ("test_disruption", "test_metrics_events")
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m}::{c}" for m, c in CASES])
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
