"""The headline churn chain (`tests/test_torch_fixtures.py`,
`churn_headline_5000x100`: the 5000-pod, 100-type headline, then two churn
steps of 120 removals and 320 arrivals, the second with unseen pod shapes,
then an identical resubmit) through `GPUSolver.solve` against the
reference's `TPUSolver`, on the CPU, with `tests/test_torch_solve_chains.py`'s
comparison (encode and solve modes, delta-reject reason, canonical
`Results`, exact). A file of its own, so the work splits across test
processes.
"""

from __future__ import annotations

import torch

from test_torch_solve_chains import check_chain

torch.set_num_threads(1)


def test_churn_headline_solve_matches_reference(monkeypatch):
    check_chain("churn_headline_5000x100", monkeypatch)
