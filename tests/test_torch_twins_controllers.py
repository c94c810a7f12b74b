"""The reference's NodePool, NodeClaim and Node controller suites (`tests/test_nodepool_controllers.py`,
`test_nodeclaim_aux.py`, `test_termination.py`, `test_node_health.py`) as twins on the port (`torch_twins`): the
reference's own assertions hold in the twin, and every tick's canonical
store, events and registry equal the reference's. Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of

MODULES = ("test_nodepool_controllers", "test_nodeclaim_aux", "test_termination", "test_node_health")
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m}::{c}" for m, c in CASES])
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
