"""`GPUSolver.solve(snapshot)` against the reference's `TPUSolver.solve`, on
the CPU.

Each scenario builds a reference `SolverSnapshot` with the reference's own
builders, carries it over into the port's classes
(`testing.carry_over.snapshot_from_reference`, every name, uid and
timestamp kept) and solves it with the reference's default JAX
`TPUSolver(recover=False)` and with `GPUSolver(device="cpu")`, twice: a
cold solve, then the same snapshot again (an identical resubmit, served from
the resident carry and the decode memo). A snapshot with pod-local fallback
reasons takes the hybrid partitioned solve on both sides (the hybrid cases
themselves are in `tests/test_torch_hybrid_solve.py`).

What must be equal, exactly: the canonical `Results`
(`testing.canonical.canonical_results`: per new claim its nodepool, sorted
pod keys, sorted instance-type names and requirements without the hostname;
per existing node its sorted pod keys; every pod error, key and message),
`last_solve_mode`, `last_fallback_reasons`, the delta-reject reason and the
backend (the port's "gpu" is the reference's "tpu"; nothing else is mapped).

The scenarios: `tests/test_torch_scheduler.py`'s seventeen
(`bench.build_snapshot(300, 20)` plain and with its affinity, PVC, fallback
and minValues options, the topology, host-port, existing-node, daemonset and
reserved shapes, the small provisioning corpus), and the benchmark snapshot
over a catalog holding reserved offerings; the benchmark ones run in
`tests/test_torch_solve_bench.py`. `tests/test_torch_solve_shapes.py` holds
the decode's own shapes (minValues, reservations, volumes, decode reuse, the
resident carry), `tests/test_torch_solve_chains.py` the chains.

The seeded headline's four solve steps (`chip_smoke.SOLVE_STEPS`: a full
solve, an identical resubmit, the -600 +800 delta, one more pod) are held
to `karpenter_tpu_torch/fixtures/snapshot/headline_5000x100_seeded_results.json`,
which the JAX solver writes (about 30 s on the CPU):

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_solve.py --write
"""

from __future__ import annotations

import itertools
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from chip_smoke import SNAPSHOT_SEED, SOLVE_FIXTURE, SOLVE_STEPS, seeded_snapshot, solve_step_pods  # noqa: E402
from karpenter_tpu.cloudprovider import catalog  # noqa: E402
from karpenter_tpu.controllers.provisioning.scheduling import nodeclaim as ref_nodeclaim  # noqa: E402
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu.solver import encode as ref_encode_mod  # noqa: E402
from karpenter_tpu.solver.tpu import TPUSolver  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim as port_nodeclaim  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.solver import encode as port_encode_mod  # noqa: E402
from karpenter_tpu_torch.solver.gpu import GPUSolver  # noqa: E402
from karpenter_tpu_torch.testing.canonical import canonical_results, json_form  # noqa: E402
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference  # noqa: E402
from test_torch_scheduler import SCENARIOS  # noqa: E402

torch.set_num_threads(1)

# the reference's backend name for the tensor path, as the port names it
BACKEND = {"tpu": "gpu", "hybrid": "hybrid", "ffd-fallback": "ffd-fallback"}


def _bench_reserved():
    """The benchmark snapshot over a catalog that also offers reserved
    capacity, one unit per instance type (decode's reservation cap)."""
    snap = bench.build_snapshot(300, 20)
    # one reserved unit per type: the claims of one type contend for it
    types = [catalog.make_instance_type(f, cpu, arch, os_, include_reserved=True, reserved_capacity=1)
             for f in catalog.FAMILIES for cpu in catalog.SIZES for arch in catalog.ARCHS for os_ in catalog.OSES]
    snap.instance_types = {name: types for name in snap.instance_types}
    return snap


SOLVE_SCENARIOS = {**SCENARIOS, "bench_reserved": _bench_reserved}


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


def clear_globals() -> None:
    """Both encoders' module caches emptied."""
    ref_encode_mod.clear_encode_globals()
    port_encode_mod.clear_encode_globals()


def same_state(start: int) -> None:
    """The `random` stream both packages share (`Requirement.any`) started
    again, and both packages' claim hostname counters started at `start`."""
    random.seed(0)
    ref_nodeclaim._hostname_seq = itertools.count(start)
    port_nodeclaim._hostname_seq = itertools.count(start)


def next_start() -> int:
    """A counter value past every placeholder either package handed out."""
    return max(next(ref_nodeclaim._hostname_seq), next(port_nodeclaim._hostname_seq)) + 10_000


def outcome(solver, results, port: bool) -> dict:
    """What a solve produced, in the form both sides are compared in."""
    if port:
        backend, reject = solver.last_backend, solver.last_delta_reject
    else:
        backend, reject = BACKEND[solver.last_backend], solver._trace.attribution.get("delta_reject")
    return dict(results=canonical_results(results), mode=solver.last_solve_mode, backend=backend,
                reasons=list(solver.last_fallback_reasons), reject=reject)


def solve_pair(ref_solver, gpu, ref_snap, port_snap) -> tuple[dict, dict]:
    """One solve on each side from the same module state."""
    start = next_start()
    same_state(start)
    want = outcome(ref_solver, ref_solver.solve(ref_snap), port=False)
    same_state(start)
    got = outcome(gpu, gpu.solve(port_snap), port=True)
    return want, got


def assert_same(want: dict, got: dict, what: str) -> None:
    for key in ("mode", "backend", "reasons", "reject"):
        assert got[key] == want[key], f"{what}: {key} {got[key]!r}, reference {want[key]!r}"
    assert got["results"] == want["results"], f"{what}: Results differ"


def run_scenario(build, what: str, force: bool = False, resubmit: bool = True) -> list[dict]:
    ref_snap = build()
    port_snap = snapshot_from_reference(ref_snap)
    ref_solver = TPUSolver(force=force, recover=False)
    gpu = GPUSolver(device="cpu", force=force)
    clear_globals()
    steps = []
    for step in range(2 if resubmit else 1):
        want, got = solve_pair(ref_solver, gpu, ref_snap, port_snap)
        assert_same(want, got, f"{what} step {step}")
        steps.append(got)
    return steps


def check_scenario(name: str) -> None:
    steps = run_scenario(SOLVE_SCENARIOS[name], name)
    first, again = steps
    assert first["results"][0] or first["results"][1], "the scenario placed nothing"
    if first["mode"] == "full":
        # the identical resubmit is served from the carry, unless a minValues
        # repair dropped it
        assert again["mode"] == "delta" or again["reject"] == "no-carry"
        assert again["results"] == first["results"]


# the benchmark snapshots run in tests/test_torch_solve_bench.py
BENCH_SCENARIOS = sorted(n for n in SOLVE_SCENARIOS if n.startswith("bench_"))


@pytest.mark.parametrize("name", sorted(set(SOLVE_SCENARIOS) - set(BENCH_SCENARIOS)))
def test_solve_matches_reference(name):
    check_scenario(name)


def pinned_reserved(claim) -> bool:
    """The claim's capacity type is pinned to reserved capacity."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.scheduling.requirements import Operator

    r = claim.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY)
    return r.operator() == Operator.IN and r.values_list() == [wk.CAPACITY_TYPE_RESERVED]


def test_force_raises_where_the_reference_raises():
    """`force=True`: a snapshot with fallback reasons raises on both sides
    instead of falling back."""
    ref_snap = SOLVE_SCENARIOS["bench_fallback"]()
    port_snap = snapshot_from_reference(ref_snap)
    with pytest.raises(RuntimeError, match="tensor path unsupported"):
        TPUSolver(force=True, recover=False).solve(ref_snap)
    with pytest.raises(RuntimeError, match="tensor path unsupported"):
        GPUSolver(device="cpu", force=True).solve(port_snap)


def test_empty_snapshot_falls_back_like_reference():
    ref_snap = bench.build_snapshot(10, 5)
    ref_snap.pods = []
    port_snap = snapshot_from_reference(ref_snap)
    ref_solver, gpu = TPUSolver(recover=False), GPUSolver(device="cpu")
    clear_globals()
    want, got = solve_pair(ref_solver, gpu, ref_snap, port_snap)
    assert_same(want, got, "empty")
    assert got["mode"] == "fallback" and got["reasons"] == ["empty snapshot"] and gpu.last_fallback_family == "empty"


def test_solve_after_solve_encoded_takes_no_carry():
    """`solve_encoded` keeps a carry keyed by its problem only: a `solve`
    on the same solver finds no resident encoding and packs in full."""
    from karpenter_tpu_torch.solver.encode import encode
    from karpenter_tpu_torch.solver.encoded import from_reference

    port_snap = snapshot_from_reference(bench.build_snapshot(60, 10))
    gpu = GPUSolver(device="cpu")
    res = gpu.solve_encoded(from_reference(encode(port_snap)))
    assert res.errors == [] and gpu._resident is not None
    gpu.solve(port_snap)
    assert (gpu.last_solve_mode, gpu.last_delta_reject, gpu.last_backend) == ("full", "no-carry", "gpu")
    assert gpu._resident["enc"] is not None
    np.testing.assert_array_equal(gpu._resident["assignment"], res.assignment)


# -- the seeded headline's solve steps (`chip_smoke.py`'s solve phase) -------------

def solve_steps(solver, snap, added, one, port: bool) -> list[dict]:
    """`chip_smoke.SOLVE_STEPS` over the seeded headline: each step's
    outcome in JSON form (the reference's backend names kept)."""
    steps = []
    for name, pods in zip(SOLVE_STEPS, solve_step_pods(list(snap.pods), added, one)):
        snap.pods = pods
        same_state(1)
        out = outcome(solver, solver.solve(snap), port=port)
        out["backend"] = {v: k for k, v in BACKEND.items()}[out["backend"]]
        steps.append(json_form(dict(step=name, **out)))
    return steps


def reference_solve_steps() -> dict:
    """The JAX `TPUSolver(force=True, recover=False)` over the seeded
    headline's solve steps (the fixture's content)."""
    import helpers

    clear_globals()
    jsm.reset_bucket_highwater()
    snap, added, one = seeded_snapshot(SNAPSHOT_SEED, bench.build_snapshot, helpers)
    solver = TPUSolver(force=True, recover=False)
    return dict(seed=SNAPSHOT_SEED, steps=solve_steps(solver, snap, added, one, port=False))


def load_solve_fixture() -> dict:
    return json.loads(SOLVE_FIXTURE.read_text())


def test_port_solves_seeded_headline_as_fixture():
    """The port on the CPU, built and solved by itself (no reference
    object), over the seeded headline's four solve steps: each step's
    canonical Results, mode, backend and reject reason equal the fixture's."""
    stored = load_solve_fixture()
    assert stored["seed"] == SNAPSHOT_SEED
    clear_globals()
    snap, added, one = seeded_snapshot(SNAPSHOT_SEED)
    got = solve_steps(GPUSolver(device="cpu", force=True), snap, added, one, port=True)
    assert [s["step"] for s in got] == list(SOLVE_STEPS)
    for g, w in zip(got, stored["steps"]):
        assert g == w, g["step"]
    assert [s["mode"] for s in got] == ["full", "delta", "delta", "delta"]


def test_solve_fixture_matches_reference():
    """The committed fixture equals a fresh run of the JAX solver over the
    same steps."""
    assert reference_solve_steps() == load_solve_fixture()


def write_solve_fixture() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    out = reference_solve_steps()
    for s in out["steps"]:
        print(s["step"], s["mode"], s["backend"], s["reject"], len(s["results"][0]), "claims", file=sys.stderr)
    SOLVE_FIXTURE.write_text(json.dumps(out, separators=(",", ":")) + "\n")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_solve_fixture()
    else:
        print(__doc__)
