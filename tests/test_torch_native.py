"""The port's C++ requirement table (`karpenter_tpu_torch.native`) against the
reference's, and the residual FFD that answers through it, on the CPU.

- `ReqTable.filter` of the port equals the reference's `ReqTable.filter` and
  the port's own `Requirements.intersects` on a fuzz (200 rows x 100
  queries, three `random.Random` seeds), on the KWOK catalog, on query
  values the table never interned, on two negative requirements, and at the
  int64 edge (`UnsupportedRequirements` for a value of 2**63 and for a bound
  past int64, in both packages; 2**63 - 1 is answered).
- A compiler that does not exist, or one that fails, raises
  `NativeBuildError` (a `kernels.build.KernelError`) wherever the table is
  needed, also out of `FFDSolver` and the hybrid `GPUSolver` at 250
  compatible types; processes that start together build once.
- `FFDSolver` and `GPUSolver(device="cpu")` over the seeded hybrid shape at
  300 pods x 1000 instance types (250 compatible, past
  `NATIVE_MIN_TABLE_ROWS` = 200) give the reference's `Results` with the
  table's filter count above 0; with the threshold patched above 1000 rows
  the same `Results`, the count at 0.
- The wide hybrid headline (`chip_smoke.WIDE_SHAPE`: 5000 pods x 1000
  types, `chip_smoke.WIDE_STEPS`: a cold hybrid solve, the resubmit, one pod
  appended) of the port on the CPU equals
  `karpenter_tpu_torch/fixtures/snapshot/headline_5000x1000_hybrid_results.json`
  step by step (canonical `Results`, mode, backend, reasons), the table
  used on W0; the fixture equals a fresh run of the JAX solver.

Tolerance: exact. The JAX `TPUSolver(force=False, recover=False)` writes the
fixture (about 40 s on the CPU):

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_native.py --write
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from chip_smoke import SNAPSHOT_SEED, WIDE_FIXTURE, WIDE_SHAPE, WIDE_STEPS, hybrid_step_pods, wide_snapshot  # noqa: E402
from karpenter_tpu import native as ref_native  # noqa: E402
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu.scheduling.requirements import Requirement as RefRequirement  # noqa: E402
from karpenter_tpu.scheduling.requirements import Requirements as RefRequirements  # noqa: E402
from karpenter_tpu.solver.ffd import FFDSolver as RefFFDSolver  # noqa: E402
from karpenter_tpu.solver.tpu import TPUSolver  # noqa: E402
from karpenter_tpu_torch import native  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim as port_nodeclaim  # noqa: E402
from karpenter_tpu_torch.kernels import build as kbuild  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.scheduling.requirements import Requirement, Requirements  # noqa: E402
from karpenter_tpu_torch.solver.ffd import FFDSolver  # noqa: E402
from karpenter_tpu_torch.solver.gpu import GPUSolver  # noqa: E402
from karpenter_tpu_torch.testing.canonical import canonical_results, json_form  # noqa: E402
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference  # noqa: E402
from test_torch_solve import BACKEND, clear_globals, next_start, outcome, same_state  # noqa: E402

torch.set_num_threads(1)

REF_BACKEND = {v: k for k, v in BACKEND.items()}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KEYS = ["zone", "arch", "size", "cpu", "custom/a", "custom/b"]
VALUES = ["a", "b", "c", "1", "2", "16", "999", "x"]
OPS = ["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt", "Gte", "Lte"]
FUZZ_SEEDS = (1234, 7, 2026)
SMALL_SHAPE = (300, 1000)  # pods x instance types: 250 compatible types, 15 flagged pods


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    native.reset_counts()
    yield


def random_spec(rng: random.Random, max_reqs: int = 4) -> list[tuple]:
    """One random requirement set as (key, operator, values) triples (the
    reference's `tests/test_native.py` draw)."""
    spec = []
    for key in rng.sample(KEYS, rng.randrange(1, max_reqs + 1)):
        op = rng.choice(OPS)
        if op in ("Gt", "Lt", "Gte", "Lte"):
            vals = [str(rng.randrange(0, 50))]
        elif op in ("Exists", "DoesNotExist"):
            vals = []
        else:
            vals = rng.sample(VALUES, rng.randrange(1, 4))
        spec.append((key, op, vals))
    return spec


def both(spec: list[tuple]):
    """The spec as the port's and as the reference's Requirements."""
    port, ref = Requirements(), RefRequirements()
    for key, op, vals in spec:
        port.add(Requirement(key, op, list(vals)))
        ref.add(RefRequirement(key, op, list(vals)))
    return port, ref


def tables(specs: list[list[tuple]]):
    rows = [both(s) for s in specs]
    return native.ReqTable([p for p, _ in rows]), ref_native.ReqTable([r for _, r in rows]), [p for p, _ in rows]


def algebra(rows, query) -> bytes:
    return bytes(int(row.intersects(query) is None) for row in rows)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_matches_reference_and_algebra(seed):
    rng = random.Random(seed)
    specs = [random_spec(rng) for _ in range(200)]
    port, ref, rows = tables(specs)
    for q in range(100):
        qp, qr = both(random_spec(rng))
        got = port.filter(qp)
        assert got == ref.filter(qr), f"seed {seed} query {q}: the port's table differs from the reference's"
        assert got == algebra(rows, qp), f"seed {seed} query {q}: the table differs from Requirements.intersects"
    assert native.COUNTS == {"tables": 1, "filters": 100}


def test_catalog_vs_pod_requirements():
    from karpenter_tpu.apis import labels as ref_wk
    from karpenter_tpu.cloudprovider import catalog as ref_catalog
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cloudprovider import catalog

    its, ref_its = catalog.construct_instance_types(), ref_catalog.construct_instance_types()
    assert [it.name for it in its] == [it.name for it in ref_its]
    port, ref = native.ReqTable([it.requirements for it in its]), ref_native.ReqTable([it.requirements for it in ref_its])
    for cpu in ("2", "8", "64"):
        qp, qr = Requirements(), RefRequirements()
        for q, R, labels, cat in ((qp, Requirement, wk, catalog), (qr, RefRequirement, ref_wk, ref_catalog)):
            q.add(R(labels.ARCH_LABEL_KEY, "In", ["amd64"]))
            q.add(R(labels.OS_LABEL_KEY, "In", ["linux"]))
            q.add(R(cat.INSTANCE_CPU_LABEL_KEY, "Gt", [cpu]))
        got = port.filter(qp)
        assert got == ref.filter(qr) == algebra([it.requirements for it in its], qp)
        assert 0 < sum(got) < len(its)


def test_unseen_query_values():
    port, ref, _rows = tables([[("zone", "In", ["a", "b"])]])
    for op, want in (("In", b"\x00"), ("NotIn", b"\x01")):
        qp, qr = both([("zone", op, ["never-interned"])])
        assert port.filter(qp) == ref.filter(qr) == want


def test_two_negatives_never_conflict():
    port, ref, rows = tables([[("k", "NotIn", ["x"])]])
    qp, qr = both([("k", "DoesNotExist", [])])
    assert port.filter(qp) == ref.filter(qr) == algebra(rows, qp) == b"\x01"


def test_int64_edge():
    """A value of 2**63 (past int64) keeps a table and a query on the Python
    algebra in both packages, as does a bound past int64; 2**63 - 1 is the
    largest value the table answers."""
    big, top = str(2**63), str(2**63 - 1)
    for pkg, R, Rs in ((native, Requirement, Requirements), (ref_native, RefRequirement, RefRequirements)):
        row = Rs()
        row.add(R("n", "In", [big]))
        with pytest.raises(pkg.UnsupportedRequirements):
            pkg.ReqTable([row])
        bound = Rs()
        bound.add(R("n", "Gte", [big]))  # gte = 2**63 (Gt 2**63 - 1 is an empty In)
        with pytest.raises(pkg.UnsupportedRequirements):
            pkg.ReqTable([bound])
        ok = Rs()
        ok.add(R("n", "In", [top, "5"]))
        table = pkg.ReqTable([ok])
        query = Rs()
        query.add(R("n", "In", [big]))
        with pytest.raises(pkg.UnsupportedRequirements):
            table.filter(query)
        for op, vals in (("In", [top]), ("Gt", ["4"]), ("Lt", ["5"]), ("NotIn", [top, "5"])):
            q = Rs()
            q.add(R("n", op, vals))
            assert table.filter(q) == bytes([int(ok.intersects(q) is None)]), (pkg.__name__, op, vals)


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """The table's library neither loaded nor built: the next use builds it
    into an empty directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("compiler,words", [("karpenter-no-such-compiler", "not found"), ("false", "failed")])
def test_broken_compiler_raises(no_library, monkeypatch, compiler, words):
    monkeypatch.setattr(native, "CXX", compiler)
    port, _ref = both([("zone", "In", ["a"])])
    with pytest.raises(native.NativeBuildError, match=words) as err:
        native.ReqTable([port])
    assert isinstance(err.value, kbuild.KernelError) and err.value.unrecoverable
    # the failure is kept: no second build, the same error again
    with pytest.raises(native.NativeBuildError, match=words):
        native.ReqTable([port])
    assert not native.available() and words in native.load_error()
    assert not (native.lib_dir() / native.LIB_NAME).exists()


def small_snapshot():
    return bench.build_snapshot(*SMALL_SHAPE, fallback_frac=0.05)


@pytest.mark.parametrize("solver", ["ffd", "hybrid"])
def test_broken_compiler_raises_out_of_the_solve(no_library, monkeypatch, solver):
    """Past 200 compatible types the residual FFD needs the table: a failed
    build is raised out of the solve, never answered by the algebra."""
    monkeypatch.setattr(native, "CXX", "karpenter-no-such-compiler")
    snap = snapshot_from_reference(small_snapshot())
    clear_globals()
    with pytest.raises(native.NativeBuildError):
        (FFDSolver() if solver == "ffd" else GPUSolver(device="cpu")).solve(snap)


def test_processes_that_start_together_build_once(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[2]); from karpenter_tpu_torch.kernels import build; "
            "from karpenter_tpu_torch import native; build.set_build_dir(sys.argv[1]); "
            "assert native.available(), native.load_error(); print(native.lib_dir())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), ROOT], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    dirs = {o.strip() for o, _e in outs}
    assert len(dirs) == 1 and dirs.pop().startswith(str(tmp_path / "native"))
    logs = list((tmp_path / "native").glob("*/builds.log"))
    assert len(logs) == 1 and len(logs[0].read_text().splitlines()) == 1


def solve_small(solver: str, patched: bool, monkeypatch) -> tuple[dict, dict, dict]:
    """The seeded hybrid shape at 300 pods x 1000 types solved by the
    reference and by the port (`ffd`: both packages' FFDSolver; `hybrid`:
    the reference's default TPUSolver and GPUSolver on the CPU), from the
    same module state; with `patched`, the port's table threshold sits
    above 1000 rows. Returns both outcomes and the port's table counts."""
    ref_snap = small_snapshot()
    port_snap = snapshot_from_reference(ref_snap)
    if patched:
        monkeypatch.setattr(port_nodeclaim, "NATIVE_MIN_TABLE_ROWS", WIDE_SHAPE[1] + 1)
    clear_globals()
    start = next_start()
    same_state(start)
    if solver == "ffd":
        want = json_form(canonical_results(RefFFDSolver().solve(ref_snap)))
        same_state(start)
        native.reset_counts()
        got = json_form(canonical_results(FFDSolver().solve(port_snap)))
    else:
        ref_solver, gpu = TPUSolver(recover=False), GPUSolver(device="cpu")
        want = json_form(outcome(ref_solver, ref_solver.solve(ref_snap), port=False))
        same_state(start)
        native.reset_counts()
        got = json_form(outcome(gpu, gpu.solve(port_snap), port=True))
        assert got["mode"] == "hybrid"
    return want, got, dict(native.COUNTS)


@pytest.mark.parametrize("solver", ["ffd", "hybrid"])
def test_solve_uses_table_and_matches_reference(solver, monkeypatch):
    want, got, counts = solve_small(solver, False, monkeypatch)
    assert got == want
    assert counts["tables"] > 0 and counts["filters"] > 0, counts


@pytest.mark.parametrize("solver", ["ffd", "hybrid"])
def test_solve_without_table_matches_reference(solver, monkeypatch):
    want, got, counts = solve_small(solver, True, monkeypatch)
    assert got == want
    assert counts == {"tables": 0, "filters": 0}


def wide_steps(solver, port: bool) -> tuple[list[dict], list[dict]]:
    """`WIDE_STEPS` over the seeded wide headline: each step's outcome in
    JSON form (the reference's backend names kept) and, on the port, the
    table's counts per step."""
    import helpers

    clear_globals()
    snap, _added, one = wide_snapshot() if port else wide_snapshot(bench.build_snapshot, helpers)
    pods = list(snap.pods)
    steps, counts = [], []
    for i, name in enumerate(WIDE_STEPS):
        pods = hybrid_step_pods(i, pods, one, solver.encode_cache.last_enc)
        snap.pods = pods
        same_state(1)
        native.reset_counts()
        out = outcome(solver, solver.solve(snap), port=port)
        counts.append(dict(native.COUNTS))
        out["backend"] = REF_BACKEND[out["backend"]]
        steps.append(json_form(dict(step=name, **out)))
    return steps, counts


def reference_wide() -> dict:
    steps, _counts = wide_steps(TPUSolver(force=False, recover=False), port=False)
    return dict(seed=SNAPSHOT_SEED, shape=list(WIDE_SHAPE), steps=steps)


def test_port_wide_steps_as_fixture():
    """The port on the CPU, built and solved by itself, over the wide steps:
    each step's outcome equals the fixture's, and the cold solve's residual
    FFD answered through the table."""
    stored = json.loads(WIDE_FIXTURE.read_text())
    assert stored["seed"] == SNAPSHOT_SEED and stored["shape"] == list(WIDE_SHAPE)
    got, counts = wide_steps(GPUSolver(device="cpu"), port=True)
    assert [s["step"] for s in got] == list(WIDE_STEPS)
    for g, w in zip(got, stored["steps"]):
        assert g == w, g["step"]
    assert [(s["mode"], s["backend"]) for s in got] == [
        ("hybrid", "hybrid"), ("hybrid-delta", "hybrid"), ("hybrid-delta", "hybrid")]
    assert counts[0]["tables"] > 0 and counts[0]["filters"] > 0, counts


def test_wide_fixture_matches_reference():
    """The committed fixture equals a fresh run of the JAX solver."""
    assert reference_wide() == json.loads(WIDE_FIXTURE.read_text())


def write_wide_fixture() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    out = reference_wide()
    for s in out["steps"]:
        print(s["step"], s["mode"], s["backend"], s["reject"], len(s["results"][0]), "claims", file=sys.stderr)
    WIDE_FIXTURE.write_text(json.dumps(out, separators=(",", ":")) + "\n")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_wide_fixture()
    else:
        print(__doc__)
