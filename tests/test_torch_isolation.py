"""The port stands alone: it imports neither jax nor the JAX package, every
relative import of its modules names a module of the port, and its default
device is CUDA (no silent CPU fallback). With both blocked it builds a
snapshot with its own builder, encodes it and solves it on the CPU, from the
encoding (`solve_encoded`) and from the snapshot into node claims
(`solve`), solves an out-of-window snapshot on the hybrid path, runs one
provisioning pass over a store (`Provisioner.reconcile`) and one disruption
pass over its own consolidation fleet (`DisruptionController.reconcile`:
the LP proposer, a masked probe, the Validator, a replacement created) —
the solves, the pass and the round with a metrics registry, an enabled
trace recorder and an event recorder —, solves the encoding again on a
mesh of three CPU shards (`parallel/sharded.py`), and solves a snapshot
with device claims on the hybrid path (the DRA allocator in the residual)
and runs the KWOK DRA driver and the device-allocation controller."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "karpenter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "karpenter_tpu")

_CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["karpenter_tpu"] = None
    sys.path.insert(0, {root!r})
    import karpenter_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, "karpenter_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    p, ref = load_npz({fixture!r})
    res = GPUSolver(device="cpu").solve_encoded(p)
    assert res.errors == [], res.errors
    assert (res.assignment == ref["ref_assignment"]).all()
    from karpenter_tpu_torch.parallel.sharded import ShardedState, make_mesh
    meshed = GPUSolver(device="cpu", mesh=make_mesh(["cpu"] * 3))
    res = meshed.solve_encoded(p)
    assert res.errors == [] and (res.assignment == ref["ref_assignment"]).all(), res.errors
    assert isinstance(meshed._resident["state"], ShardedState)
    from karpenter_tpu_torch.solver.encode import encode
    from karpenter_tpu_torch.solver.encoded import from_reference
    from karpenter_tpu_torch.solver.ffd import FFDSolver
    from karpenter_tpu_torch.testing.scenarios import build_snapshot
    snap = build_snapshot(120, 40, affinity_frac=0.1)
    enc = encode(snap)
    assert enc.n_pods == 120 and not enc.fallback_reasons, enc.fallback_reasons
    res = GPUSolver(device="cpu").solve_encoded(from_reference(enc))
    assert res.errors == [] and res.n_placed == 120, res.errors
    host = FFDSolver().solve(snap)
    assert not host.pod_errors and sum(len(c.pods) for c in host.new_node_claims) == 120
    from karpenter_tpu_torch.events import Recorder
    from karpenter_tpu_torch.metrics import make_registry
    from karpenter_tpu_torch.obs.trace import TraceRecorder
    reg = make_registry()
    solver = GPUSolver(device="cpu", registry=reg, recorder=TraceRecorder(enabled=True))
    results = solver.solve(snap)
    assert solver.last_backend == "gpu" and not results.pod_errors, results.pod_errors
    assert sum(len(c.pods) for c in results.new_node_claims) == 120
    assert solver.recorder.last().mode == "full" and "decode" in solver.last_stages
    assert reg.counter("karpenter_solver_solve_total").value(backend="gpu") == 1
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types_assorted
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
    snap = build_snapshot(120, 40, fallback_frac=0.1)
    solver = GPUSolver(device="cpu")
    results = solver.solve(snap)
    assert (solver.last_solve_mode, solver.last_backend) == ("hybrid", "hybrid") and not results.pod_errors
    for p in snap.pods:
        snap.store.create(p)
    solver = GPUSolver(device="cpu", registry=reg, recorder=TraceRecorder(enabled=True))
    prov = Provisioner(snap.store, snap.cluster, FakeCloudProvider(instance_types_assorted(40)), snap.clock, solver=solver,
                       metrics=reg, recorder=Recorder(snap.clock))
    results = prov.reconcile(force=True)
    assert solver.last_solve_mode == "hybrid" and not results.pod_errors, results.pod_errors
    assert solver.recorder.last().mode == "hybrid" and reg.counter("karpenter_nodeclaims_created_total").total() > 0
    assert len(snap.store.list("NodeClaim")) == len(results.new_node_claims) > 0
    from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.testing.scenarios import build_consolidation_fleet
    fleet = build_consolidation_fleet(6)
    reg = make_registry()
    events = Recorder(fleet.clock)
    gpu = GPUSolver(device="cpu", registry=reg, recorder=TraceRecorder(enabled=True))
    prov = Provisioner(fleet.store, fleet.cluster, fleet.cloud_provider, fleet.clock, solver=gpu, metrics=reg,
                       recorder=events)
    dc = DisruptionController(fleet.store, fleet.cluster, prov, fleet.cloud_provider, fleet.clock, Options(),
                              recorder=events, metrics=reg)
    dc.reconcile(force=True)
    assert reg.counter("karpenter_solver_consolidation_proposals_total").value(proposer="lp") >= 1
    assert [t.mode for t in gpu.recorder.traces()].count("consolidate") == 1
    assert len(dc.queue._items) == 1 and len(dc.queue._items[0].command.candidates) >= 2
    assert dc.methods[3].last_round["sim_masked"] >= 1
    assert len(fleet.store.list("NodeClaim")) == 6 + len(dc.queue._items[0].command.replacements)
    from karpenter_tpu_torch.controllers.dynamicresources import DeviceAllocationController, DRAConfig, DRAKwokDriver
    from karpenter_tpu_torch.kube import Node, ObjectMeta
    from karpenter_tpu_torch.testing.scenarios import add_dra
    snap = build_snapshot(600, 40)
    claimed = add_dra(snap)
    solver = GPUSolver(device="cpu")
    results = solver.solve(snap)
    assert (solver.last_solve_mode, solver.last_backend) == ("hybrid", "hybrid") and not results.pod_errors
    placed = {{p.metadata.uid for c in results.new_node_claims for p in c.pods}}
    assert all(p.metadata.uid in placed for p in claimed)
    snap.store.create(DRAConfig(metadata=ObjectMeta(name="cfg"), driver="gpu.example.com",
                                devices=snap.instance_types["default-pool"][8].dynamic_resources))
    snap.store.create(Node(metadata=ObjectMeta(name="n1", labels=dict([("karpenter.sh/registered", "true")]))))
    DRAKwokDriver(snap.store).reconcile()
    claimed[0].spec.node_name = "n1"
    snap.store.create(claimed[0])
    DeviceAllocationController(snap.store, snap.cluster, snap.clock).reconcile()
    assert snap.store.list("ResourceClaim")[0].status.allocation["nodeName"] == "n1"
    import torch
    torch.cuda.is_available = lambda: False
    try:
        GPUSolver()
    except RuntimeError:
        pass
    else:
        raise SystemExit("GPUSolver() ran without CUDA")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu") and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ISOLATED", len(names))
    """
)


def test_port_runs_without_jax_or_reference():
    code = _CHILD.format(root=str(ROOT), fixture=str(PORT / "fixtures" / "small_existing_affinity.npz"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_no_port_file_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_dra_imports_nothing_of_jax_or_reference():
    """DRA (`scheduling/dynamicresources/`, `controllers/dynamicresources/`)
    stands alone like the rest of the port: no import of jax or of the JAX
    package, lazy ones included."""
    files = sorted((PORT / "scheduling" / "dynamicresources").glob("*.py"))
    files += sorted((PORT / "controllers" / "dynamicresources").glob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "allocator.py", "cel.py", "__init__.py", "deviceallocation.py",
                                       "kwokdriver.py"]
    assert [(f.name, m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN] == []


def test_parallel_imports_nothing_of_jax_or_reference():
    """The meshed pack (`parallel/`) stands alone like the rest of the port:
    no import of jax or of the JAX package, lazy ones included."""
    files = sorted((PORT / "parallel").glob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "sharded.py"]
    assert [(f.name, m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN] == []


def test_relative_imports_name_port_modules():
    """Every relative import (lazy ones inside functions too) resolves to a
    module of the port, or a name in one: a reference module left out of the
    port (the native tables, the operator, serving) is never reached."""
    import importlib
    import importlib.util

    def resolves(module: str, name: str | None) -> bool:
        try:
            if importlib.util.find_spec(module) is None:
                return False
        except ModuleNotFoundError:
            return False
        return name is None or hasattr(importlib.import_module(module), name) or \
            importlib.util.find_spec(f"{module}.{name}") is not None

    bad = []
    for f in sorted(PORT.rglob("*.py")):
        pkg = list(f.relative_to(ROOT).with_suffix("").parts)[:-1]
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = ".".join(pkg[: len(pkg) - (node.level - 1)])
                if node.module:
                    ok = resolves(f"{base}.{node.module}", None)
                else:
                    ok = all(resolves(base, a.name) for a in node.names)
                if not ok:
                    bad.append((str(f.relative_to(ROOT)), node.lineno))
    assert bad == []


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a CUDA device it exits non-zero and prints no result; alone in
    a directory it does the same."""
    no_cuda = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT), env=no_cuda)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                          env=no_cuda)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
