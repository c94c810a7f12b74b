"""The hybrid headline: `GPUSolver.solve` and one `Provisioner` pass over an
out-of-window snapshot, against the reference's default `TPUSolver`, on the
CPU.

The snapshot is `bench.py`'s `bench_hybrid_path` shape at the headline,
`build_snapshot(5000, 100, fallback_frac=0.05)` (5% of the pods carry a
preferred pod affinity, a pod-local fallback reason), made by
`chip_smoke.seeded_snapshot`'s recipe with `SNAPSHOT_SEED`. Its steps
(`chip_smoke.HYBRID_STEPS`: a cold hybrid solve, an identical resubmit, one
pod appended, 600 pods removed, every flagged pod removed) and one
provisioning pass over a store holding its pods pending
(`Provisioner.reconcile(force=True)`) are held to
`karpenter_tpu_torch/fixtures/snapshot/headline_5000x100_hybrid_results.json`:
per step the canonical `Results`, mode, backend (the port's "gpu" is the
reference's "tpu"), fallback and delta-reject reasons; for the pass the
`Results`, mode, backend and the NodeClaims created in the store
(`testing.canonical.canonical_node_claims`). Exact.

The JAX `TPUSolver(force=False, recover=False)` writes the fixture (about
25 s on the CPU):

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_hybrid.py --write
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from chip_smoke import (  # noqa: E402
    HYBRID_FALLBACK_FRAC,
    HYBRID_FIXTURE,
    HYBRID_STEPS,
    SNAPSHOT_SEED,
    SNAPSHOT_SHAPE,
    hybrid_step_pods,
    pending_store,
    seeded_snapshot,
)
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu.solver.tpu import TPUSolver  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.solver.gpu import GPUSolver  # noqa: E402
from karpenter_tpu_torch.testing.canonical import canonical_node_claims, json_form  # noqa: E402
from test_torch_solve import BACKEND, clear_globals, outcome, same_state  # noqa: E402

torch.set_num_threads(1)

REF_BACKEND = {v: k for k, v in BACKEND.items()}


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


def hybrid_snapshot(port: bool):
    """The seeded hybrid headline, its pods and the one pod H2 appends, built
    by either package's builder."""
    if port:
        snap, _added, one = seeded_snapshot(SNAPSHOT_SEED, fallback_frac=HYBRID_FALLBACK_FRAC)
    else:
        import helpers

        snap, _added, one = seeded_snapshot(SNAPSHOT_SEED, bench.build_snapshot, helpers,
                                            fallback_frac=HYBRID_FALLBACK_FRAC)
    return snap, one


def hybrid_steps(solver, port: bool) -> list[dict]:
    """`HYBRID_STEPS` over the seeded hybrid headline: each step's outcome
    in JSON form (the reference's backend names kept)."""
    clear_globals()
    snap, one = hybrid_snapshot(port)
    pods = list(snap.pods)
    steps = []
    for i, name in enumerate(HYBRID_STEPS):
        pods = hybrid_step_pods(i, pods, one, solver.encode_cache.last_enc)
        snap.pods = pods
        same_state(1)
        out = outcome(solver, solver.solve(snap), port=port)
        out["backend"] = REF_BACKEND[out["backend"]]
        steps.append(json_form(dict(step=name, **out)))
    return steps


def provision_pass(port: bool) -> dict:
    """One `Provisioner.reconcile(force=True)` over a store holding the
    seeded hybrid headline's pods pending, wired as a user wires it."""
    if port:
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types_assorted
        from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner

        solver = GPUSolver(device="cpu")
    else:
        from karpenter_tpu.cloudprovider.fake import FakeCloudProvider, instance_types_assorted
        from karpenter_tpu.controllers.provisioning.provisioner import Provisioner

        solver = TPUSolver(recover=False)
    clear_globals()
    snap, _one = hybrid_snapshot(port)
    pending_store(snap)
    prov = Provisioner(snap.store, snap.cluster, FakeCloudProvider(instance_types_assorted(SNAPSHOT_SHAPE[1])),
                       snap.clock, solver=solver)
    same_state(1)
    results = prov.reconcile(force=True)
    out = outcome(solver, results, port=port)
    return json_form(dict(results=out["results"], mode=out["mode"], backend=REF_BACKEND[out["backend"]],
                          claims=canonical_node_claims(snap.store)))


def reference_hybrid() -> dict:
    """The JAX default solver over the hybrid steps and the provisioning pass
    (the fixture's content)."""
    solver = TPUSolver(force=False, recover=False)
    return dict(seed=SNAPSHOT_SEED, steps=hybrid_steps(solver, port=False), provision=provision_pass(port=False))


def load_hybrid_fixture() -> dict:
    return json.loads(HYBRID_FIXTURE.read_text())


def test_port_hybrid_steps_as_fixture():
    """The port on the CPU, built and solved by itself, over the hybrid
    steps: each step's outcome equals the fixture's. The modes are the
    reference's: H3's masked delta fails validation after its removals
    (reject "validate") and the cold hybrid runs; on H4 no flagged pod is
    left and the masked carry serves a pure delta."""
    stored = load_hybrid_fixture()
    assert stored["seed"] == SNAPSHOT_SEED
    got = hybrid_steps(GPUSolver(device="cpu"), port=True)
    assert [s["step"] for s in got] == list(HYBRID_STEPS)
    for g, w in zip(got, stored["steps"]):
        assert g == w, g["step"]
    assert [(s["mode"], s["backend"], s["reject"]) for s in got] == [
        ("hybrid", "hybrid", None), ("hybrid-delta", "hybrid", None), ("hybrid-delta", "hybrid", None),
        ("hybrid", "hybrid", "validate"), ("delta", "tpu", None)]


def test_port_provision_pass_as_fixture():
    """The port's `Provisioner` with `GPUSolver(device="cpu")` over the store:
    the pass's Results, mode, backend and NodeClaims equal the fixture's."""
    got = provision_pass(port=True)
    want = load_hybrid_fixture()["provision"]
    assert (got["mode"], got["backend"]) == (want["mode"], want["backend"]) == ("hybrid", "hybrid")
    assert got["results"] == want["results"]
    assert got["claims"] == want["claims"] and len(got["claims"]) == len(got["results"][0])


def test_hybrid_fixture_matches_reference():
    """The committed fixture equals a fresh run of the JAX solver and
    provisioner over the same steps."""
    assert reference_hybrid() == load_hybrid_fixture()


def write_hybrid_fixture() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    out = reference_hybrid()
    for s in out["steps"]:
        print(s["step"], s["mode"], s["backend"], s["reject"], len(s["results"][0]), "claims", file=sys.stderr)
    print("provision", out["provision"]["mode"], len(out["provision"]["claims"]), "NodeClaims", file=sys.stderr)
    HYBRID_FIXTURE.write_text(json.dumps(out, separators=(",", ":")) + "\n")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_hybrid_fixture()
    else:
        print(__doc__)
