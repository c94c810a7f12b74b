"""The DRA headline: a provisioning solve with claim-bearing pods,
`GPUSolver.solve` and one `Provisioner` pass, against the reference's
default `TPUSolver`, on the CPU.

The snapshot is the seeded headline (`chip_smoke.seeded_snapshot`,
`build_snapshot(5000, 100)` with `SNAPSHOT_SEED`) made into its DRA variant
by `testing.scenarios.add_dra` (`dra_snapshot`; the reference's twin passes
the reference's builders and object model): 256 of its plain pods hold a
device claim made from a `ResourceClaimTemplate` (192 one GPU, 64 two GPUs
of one NVLink island, a matchAttribute constraint), one `DeviceClass`
selects the GPUs by a CEL expression, and 16 of the 100 instance types
carry 8 template GPUs (one of them drawing on a partitionable counter set).
A claim-bearing pod has the pod-local fallback reason "dynamic resource
claims", so the solve is hybrid: the other pods are packed on the device
path (K1 -> K2 -> K3), the claim-bearing ones by the residual host FFD,
whose scheduler allocates their devices with the DRA allocator.

Its steps (`chip_smoke.DRA_STEPS`): D0 a cold solve, D1 the same snapshot
with one plain pod appended, D2 one `Provisioner.reconcile(force=True)`
with the DynamicResources gate on over a store holding its pods pending.
Each is held to `karpenter_tpu_torch/fixtures/snapshot/
headline_5000x100_dra_results.json`: the canonical `Results`, the mode, the
backend (the port's "gpu" is the reference's "tpu"), the fallback reasons,
every allocator the step built in its committed state
(`testing.canonical.canonical_allocation`: claim targets, template-
allocation metadata, the loop tracker) and, for D2, the NodeClaims created
in the store. Exact.

The JAX `TPUSolver(force=False, recover=False)` writes the fixture (about
40 s on the CPU):

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_dra_hybrid.py --write
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from chip_smoke import (  # noqa: E402
    DRA_FIXTURE,
    DRA_STEPS,
    SNAPSHOT_SEED,
    dra_provisioner,
    dra_snapshot,
    kept_allocators,
)
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu.solver.tpu import TPUSolver  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.solver.gpu import GPUSolver  # noqa: E402
from karpenter_tpu_torch.testing.canonical import canonical_allocation, canonical_node_claims, json_form  # noqa: E402
from test_torch_solve import BACKEND, clear_globals, outcome, same_state  # noqa: E402

torch.set_num_threads(1)

REF_BACKEND = {v: k for k, v in BACKEND.items()}


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


def _pkg(port: bool) -> str:
    return "karpenter_tpu_torch" if port else "karpenter_tpu"


def dra_headline(port: bool):
    """The DRA headline and the one pod D1 appends, built by either
    package's builders and object model (the reference's twin of
    `chip_smoke.dra_snapshot`)."""
    if port:
        return dra_snapshot()
    import helpers

    pkg = _pkg(port)
    return dra_snapshot(bench.build_snapshot, helpers, importlib.import_module(f"{pkg}.kube"),
                        importlib.import_module(f"{pkg}.utils.resources"))


def _step(name: str, solver, port: bool, solve, store=None) -> dict:
    """One step from the same module state on either side: its outcome, the
    allocators it built and (for a pass) the NodeClaims in the store."""
    same_state(1)
    with kept_allocators(importlib.import_module(f"{_pkg(port)}.scheduling.dynamicresources.allocator")) as allocs:
        results = solve()
    out = outcome(solver, results, port=port)
    out["backend"] = REF_BACKEND[out["backend"]]
    del out["reject"]
    out["allocations"] = [canonical_allocation(a) for a in allocs]
    if store is not None:
        out["claims"] = canonical_node_claims(store)
    return json_form(dict(step=name, **out))


def dra_steps(solver, port: bool) -> list[dict]:
    """D0 and D1 over the DRA headline with `solver`, then D2 with a fresh
    solver of the same kind behind a `Provisioner`."""
    pkg = _pkg(port)
    clear_globals()
    snap, one = dra_headline(port)
    steps = [_step(DRA_STEPS[0], solver, port, lambda: solver.solve(snap))]
    snap.pods = snap.pods + [one]
    steps.append(_step(DRA_STEPS[1], solver, port, lambda: solver.solve(snap)))
    clear_globals()
    psnap, _one = dra_headline(port)
    fresh = GPUSolver(device="cpu") if port else TPUSolver(force=False, recover=False)
    mods = [importlib.import_module(f"{pkg}.{m}") for m in ("kube", "utils.resources",
                                                              "controllers.provisioning.provisioner",
                                                              "cloudprovider.fake")]
    prov = dra_provisioner(psnap, fresh, *mods)
    steps.append(_step(DRA_STEPS[2], fresh, port, lambda: prov.reconcile(force=True), store=psnap.store))
    return steps


def reference_dra() -> dict:
    """The JAX default solver over the DRA steps (the fixture's content)."""
    return dict(seed=SNAPSHOT_SEED, steps=dra_steps(TPUSolver(force=False, recover=False), port=False))


def load_dra_fixture() -> dict:
    return json.loads(DRA_FIXTURE.read_text())


def test_port_dra_steps_as_fixture():
    """The port on the CPU, built and solved by itself: each step's outcome
    and allocations equal the fixture's. The reference serves D0 and D2
    hybrid, D1 hybrid-delta, none of them by the whole-snapshot FFD; each
    step built one allocator (the residual's), which committed the 256
    claims on template devices."""
    stored = load_dra_fixture()
    assert stored["seed"] == SNAPSHOT_SEED
    got = dra_steps(GPUSolver(device="cpu"), port=True)
    assert [s["step"] for s in got] == list(DRA_STEPS)
    for g, w in zip(got, stored["steps"]):
        for key in w:
            assert g[key] == w[key], (g["step"], key)
        assert g == w
    assert [(s["mode"], s["backend"]) for s in got] == [("hybrid", "hybrid"), ("hybrid-delta", "hybrid"),
                                                        ("hybrid", "hybrid")]
    for s in got:
        assert len(s["allocations"]) == 1 and len(s["allocations"][0][1]) == 256, s["step"]
        assert all(r.endswith("dynamic resource claims") for r in s["reasons"])
        assert not s["results"][2], s["step"]  # no pod errors
    assert len(got[2]["claims"]) == len(got[2]["results"][0])


def test_dra_fixture_matches_reference():
    """The committed fixture equals a fresh run of the JAX solver and
    provisioner over the same steps."""
    assert reference_dra() == load_dra_fixture()


def write_dra_fixture() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    out = reference_dra()
    for s in out["steps"]:
        print(s["step"], s["mode"], s["backend"], len(s["results"][0]), "claims", len(s["reasons"]), "reasons",
              len(s["allocations"]), "allocators", file=sys.stderr)
    DRA_FIXTURE.write_text(json.dumps(out, separators=(",", ":")) + "\n")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_dra_fixture()
    else:
        print(__doc__)
