"""The comparison that decides `correct` fails when the timed path is
broken underneath: the cell run on the CPU at a small size with one fault
planted in the program (the harness's look for a card skipped), for each
fault the cell can have. One card holds the cell, so it has no exchange
between chips to leave out."""

import pytest
from bench_support import ROOT, SMALL, run_cell

from benchmark import manifest

from karpenter_tpu_torch.controllers.provisioning.scheduling.scheduler import Results
from karpenter_tpu_torch.solver import gpu

CELL = "sched2k.burst"


def solve_with(monkeypatch, fault):
    real = gpu.GPUSolver.solve

    def solve(self, snap):
        return fault(real, self, snap)

    monkeypatch.setattr(gpu.GPUSolver, "solve", solve)


def unchanged(real, self, snap):
    """A solve that returns without moving anything."""
    return Results()


def half(real, self, snap):
    """Half of the pending pods left out of the solve."""
    import copy

    snap = copy.copy(snap)
    snap.pods = snap.pods[::2]
    return real(self, snap)


def _only(real, self, snap, pick):
    res = real(self, snap)
    one = pick((it for its in snap.instance_types.values() for it in its), key=lambda it: it.capacity["cpu"].milli)
    for nc in res.new_node_claims:
        nc.instance_type_options = [one]
    return res


def smallest(real, self, snap):
    """The answer altered where it is made: each new claim may launch only
    the catalog's smallest instance type."""
    return _only(real, self, snap, min)


def largest(real, self, snap):
    """The answer altered where it is made: each new claim may launch only
    the catalog's largest instance type (room enough, at a waste)."""
    return _only(real, self, snap, max)


@pytest.mark.parametrize("fault", [unchanged, half, smallest, largest],
                         ids=["unchanged", "half", "smallest", "largest"])
def test_a_broken_solve_is_not_correct(monkeypatch, fault):
    solve_with(monkeypatch, fault)
    rc, line, _ = run_cell(CELL, seconds=0.5)
    assert rc == 0 and line["correct"] is False, line["compared"]


def control(seed):
    cell = manifest.cell(manifest.load(ROOT), ROOT, CELL)
    cell["config"].update(SMALL[CELL]["config"])
    got = manifest.kind(cell["traffic"]["kind"]).control(cell["config"], cell["traffic"], seed)
    return {k: got[k] for k, limit in cell["limits"].items() if got[k] > limit}


@pytest.mark.parametrize("seed", [7, 8])
def test_the_control_is_not_correct(seed):
    """The reference in the program's place, in the precision below the
    configuration's, fails at least one of the cell's numbers."""
    assert control(seed)
