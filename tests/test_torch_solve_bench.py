"""`GPUSolver.solve` against the reference's `TPUSolver.solve` on the
benchmark snapshots, on the CPU: `bench.build_snapshot(300, 20)` plain, with
its affinity, PVC, fallback and minValues options, and over a catalog with
one reserved unit per instance type. The comparison is
`tests/test_torch_solve.py`'s (a cold solve and an identical resubmit;
canonical `Results`, mode, backend, fallback and delta-reject reasons,
exact); this file only splits the work across test processes.
"""

from __future__ import annotations

import pytest
import torch

from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import BENCH_SCENARIOS, _bench_reserved, check_scenario, pinned_reserved

torch.set_num_threads(1)


@pytest.mark.parametrize("name", BENCH_SCENARIOS)
def test_bench_solve_matches_reference(name):
    check_scenario(name)


def test_bench_reserved_caps_reservations():
    """The reserved-capacity scenario reaches the decode's reservation cap:
    claims are pinned to reserved capacity, each to reservations no other
    claim holds."""
    from karpenter_tpu_torch.apis import labels as wk

    gpu = GPUSolver(device="cpu", force=True)
    results = gpu.solve(snapshot_from_reference(_bench_reserved()))
    assert gpu.last_backend == "gpu"
    pinned = [nc for nc in results.new_node_claims if pinned_reserved(nc)]
    assert pinned
    # one unit per reservation: no reservation is held by two claims
    rids = [nc.requirements.get(wk.RESERVATION_ID_LABEL_KEY).values_list() for nc in pinned]
    assert all(rids) and len({r for ids in rids for r in ids}) == sum(len(ids) for ids in rids)
