"""The reference's serving suites as twins on the port (`torch_twins`): the shard
router (`tests/test_shardfleet.py`: the ring, shard labels, tenant-filtered
replay, two processes racing the kernel build directory's claim, the router's
spawn/replay/aggregation/re-homing across worker processes), the test harness
(`test_testing_harness.py`: the metrics poller, the exposition scrape, the
object churn watcher) and `test_chaos.py` (node kills, provider error storms,
registration storms, leader failover). Tolerance: exact."""

from __future__ import annotations

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, cases_of, params_of

MODULES = ("test_shardfleet", "test_testing_harness", "test_chaos")
CASES = cases_of(MODULES)


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
