"""The JAX-made chains (`tests/test_torch_fixtures.py`, `CHAINS`), driven from
their snapshots through `GPUSolver.solve`, against the reference's
`TPUSolver(force=True, hybrid=False, recover=False)`, on the CPU.

Each chain's generator runs twice from the same pod-name counter: once for
the reference's solver, and once step by step carried over for the port's
(`testing.carry_over.SnapshotMirror`: one port store and cluster following
the reference's, every object carried once, so the port's encoder sees the
same pods by identity and takes its delta path where the reference's does).
Where the chain binds pods, each side's generator gets that side's own
`Results` (the port's pods mapped back to the reference objects they were
carried from). At every step both sides must show the same encode mode,
solve mode and delta-reject reason, and equal canonical `Results`
(`testing.canonical`). Tolerance: exact.

The headline churn chain (5000 pods x 100 instance types, about 20 s for
both runs) is checked the same way in `tests/test_torch_solve_churn.py`.
"""

from __future__ import annotations

import itertools
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import helpers
from karpenter_tpu.controllers.provisioning.scheduling import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.canonical import canonical_results
from karpenter_tpu_torch.testing.carry_over import SnapshotMirror
from test_torch_fixtures import CHAIN_DIR, CHAIN_ENV, CHAINS
from test_torch_solve import BACKEND, clear_globals

torch.set_num_threads(1)

SMALL_CHAINS = sorted(n for n in CHAINS if n.startswith("chain_small_"))
NAME_START = 900_000  # both runs of a chain name their pods from here


def _step_state(step: int) -> None:
    random.seed(step)
    ref_nodeclaim._hostname_seq = itertools.count(100_000 * (step + 1))
    port_nodeclaim._hostname_seq = itertools.count(100_000 * (step + 1))


def run_chain(name: str, port: bool) -> list[dict]:
    """One run of the chain's generator against one side's solver: per
    step the encode mode, solve mode, reject reason and canonical Results."""
    clear_globals()
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    helpers._seq = itertools.count(NAME_START)
    mirror = SnapshotMirror() if port else None
    solver = GPUSolver(device="cpu", force=True) if port else TPUSolver(force=True, hybrid=False, recover=False)
    steps = CHAINS[name]()
    out: list[dict] = []
    feedback = None
    for i in itertools.count():
        try:
            ref_snap = steps.send(feedback)
        except StopIteration:
            break
        _step_state(i)
        if port:
            results = solver.solve(mirror.snapshot(ref_snap))
            reject, backend = solver.last_delta_reject, solver.last_backend
            # the generator reads where pods landed by the identity of its own pods
            feedback = SimpleNamespace(existing_nodes=[
                SimpleNamespace(state_node=en.state_node, pods=[mirror.reference(q) for q in en.pods])
                for en in results.existing_nodes])
        else:
            results = solver.solve(ref_snap)
            reject, backend = solver._trace.attribution.get("delta_reject"), BACKEND[solver.last_backend]
            feedback = results
        out.append(dict(
            encode=getattr(solver.encode_cache.last_enc, "encode_mode", "full"),
            mode=solver.last_solve_mode,
            reject=reject,
            backend=backend,
            results=canonical_results(results),
        ))
    return out


def check_chain(name: str, monkeypatch) -> None:
    for key, value in CHAIN_ENV.get(name, {}).items():
        monkeypatch.setenv(key, value)
    want = run_chain(name, port=False)
    got = run_chain(name, port=True)
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("encode", "mode", "reject", "backend"):
            assert g[key] == w[key], f"{name} step {i}: {key} {g[key]!r}, reference {w[key]!r}"
        assert g["results"] == w["results"], f"{name} step {i}: Results differ"
    # the modes and reasons the chain's fixture recorded for the reference
    with np.load(CHAIN_DIR / f"{name}.npz", allow_pickle=False) as z:
        recorded = [(str(z[f"s{i}.ref_mode"]), str(z[f"s{i}.ref_reject"]) or None) for i in range(int(z["n_steps"]))]
    assert [(s["mode"], s["reject"]) for s in got] == recorded, name


@pytest.mark.parametrize("name", SMALL_CHAINS)
def test_chain_solve_matches_reference(name, monkeypatch):
    check_chain(name, monkeypatch)
