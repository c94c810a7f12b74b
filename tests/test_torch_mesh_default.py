"""`GPUSolver(mesh=...)` against the reference's meshed `TPUSolver`, on the
CPU: `tests/test_mesh_default.py` carried through the port.

- The default: `default_mesh()` is a mesh over the distinct CUDA cards
  when there are more than one, else None; so on the CPU, and on one card,
  `GPUSolver()` takes the single-device path, as `TPUSolver()` does on one
  device. A mesh over two distinct cards has no exchange yet (ROADMAP
  Queue 1 item 9): `mesh="auto"` then also takes the single-device path,
  and every meshed entry given such a mesh raises `NotImplementedError`.
  An explicit None overrides "auto"; a one-shard mesh degenerates to the
  single-device path. `KARPENTER_SOLVER_MESH` is read as the reference
  reads it (`tests/test_mesh_default.py:46-59`): "auto", the default,
  engages the mesh over several devices; 0, off, false, none, disable and
  disabled give None (the test suite's conftest sets it to 0, so the cases
  that want the default set "auto").
- Parity: the port on `make_mesh(["cpu"] * S)` (the plain multi-shard arm)
  and the reference on `make_mesh(jax.devices()[:S])` solve the same
  snapshots step by step, full, delta (an addition and a removal), hybrid
  and hybrid-delta: the canonical Results, mode, backend, reasons, the
  resident carry (the port's gathered) and, flight-recorded, the traces and
  counters are equal. Padding edges: (3 shards, 7 pods), (5, 9).
- The trace surface: the watchlist's `pack_sharded` and `shard_feas`, a
  library load made under the meshed pack counted under `shard_feas`, and
  the `shard_exchange` span (attribute `n_dev`) inside `pack`.
"""

from __future__ import annotations

import jax
import pytest
import torch

from helpers import make_pod
from test_solvetrace import _odd_pod
from test_solver import make_snapshot
from test_torch_hybrid_solve import Chain
from test_torch_solvetrace import TracedChain, span_tree
import test_torch_hybrid_solve as hybrid_chain
import test_torch_solvetrace as traced_chain
from karpenter_tpu.obs.trace import TraceRecorder as RefRecorder
from karpenter_tpu.parallel import sharded as jsh
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.obs.trace import TraceRecorder, sentinel
from karpenter_tpu_torch.parallel import sharded as sh
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference

torch.set_num_threads(1)


def _mixed_pods(n_small=13, n_big=5):
    """A pod set whose item count is not a multiple of 8 (padding)."""
    pods = [make_pod(cpu="500m", memory="512Mi", name=f"p{i}") for i in range(n_small)]
    pods += [make_pod(cpu="2", memory="3Gi", name=f"big{i}") for i in range(n_big)]
    return pods


@pytest.fixture
def gathered_carry(monkeypatch):
    """The chains' carry check reads a meshed port carry gathered, as the
    delta path reads it."""

    def wrap(real):
        def check(gpu, ref, what):
            res = gpu._resident
            if res is not None and isinstance(res["state"], sh.ShardedState):
                gpu._resident = dict(res, state=res["state"].gather_state())
                try:
                    return real(gpu, ref, what)
                finally:
                    gpu._resident = res
            return real(gpu, ref, what)

        return check

    monkeypatch.setattr(hybrid_chain, "assert_same_carry", wrap(hybrid_chain.assert_same_carry))
    monkeypatch.setattr(traced_chain, "assert_same_carry", wrap(traced_chain.assert_same_carry))


def mesh_chain(snap, n_dev: int = 8, force: bool = False) -> Chain:
    chain = Chain(snap, force=force)
    chain.ref_solver = TPUSolver(force=force, recover=False, mesh=jsh.make_mesh(jax.devices()[:n_dev]))
    chain.gpu = GPUSolver(device="cpu", force=force, mesh=sh.make_mesh(["cpu"] * n_dev))
    return chain


# -- the default's engage/disengage rules ---------------------------------------------


def test_default_mesh_is_none_on_the_cpu():
    assert torch.cuda.device_count() == 0
    assert sh.default_mesh() is None
    assert GPUSolver(device="cpu").mesh is None


def test_one_card_returns_none(monkeypatch):
    monkeypatch.setenv("KARPENTER_SOLVER_MESH", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sh.default_mesh() is None
    assert GPUSolver(device="cpu").mesh is None


def test_distinct_cards_mesh_raises_not_implemented(monkeypatch):
    """Two cards: the default mesh is over both, and every meshed entry
    given it refuses it, naming ROADMAP's multi-card item; nothing runs.
    `GPUSolver()` and `Provisioner()` still build, on the single-device
    path, as on one card."""
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner

    monkeypatch.setenv("KARPENTER_SOLVER_MESH", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = sh.default_mesh()
    assert mesh is not None and mesh.size == 2 and mesh.axis_name == "batch"
    assert mesh.devices == (torch.device("cuda:0"), torch.device("cuda:1"))
    explicit = sh.make_mesh(["cuda:0", "cuda:1"])
    for m in (mesh, explicit):
        for call in (lambda: sh.mesh_device(m), lambda: sh.sharded_feasibility(None, None, m),
                     lambda: sh.pack_scan_sharded(None, None, None, None, m),
                     lambda: sh.anneal_sharded(None, None, m), lambda: sh.sharded_compat_matrix(None, None, m),
                     lambda: GPUSolver(device="cpu", mesh=m)):
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
                call()
    assert GPUSolver(device="cpu").mesh is None
    assert GPUSolver(device="cpu", mesh="auto").mesh is None
    # the default device and the provisioner's default solver, as on a host
    # with two cards (building them touches no card)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert GPUSolver().mesh is None
    assert Provisioner(None, None, None, None).solver.mesh is None
    # an explicit None overrides "auto"
    assert GPUSolver(device="cpu", mesh=None).mesh is None


def test_engages_on_multi_device(monkeypatch):
    """The reference's `test_engages_on_multi_device`: with the switch at
    "auto" and several devices the default is a mesh over all of them."""
    monkeypatch.setenv("KARPENTER_SOLVER_MESH", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = sh.default_mesh()
    assert mesh is not None and mesh.size == 3
    assert jsh.default_mesh() is not None and jsh.default_mesh().size == len(jax.devices())


@pytest.mark.parametrize("value", ["0", "off", "false", "none", "disable", "disabled", " OFF ", "Disabled"])
def test_env_kill_switch(monkeypatch, value):
    """The reference's `test_env_kill_switch`, in each of its off
    spellings (stripped, any case): None where "auto" gives a mesh, in both
    packages."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("KARPENTER_SOLVER_MESH", value)
    assert sh.default_mesh() is None
    assert jsh.default_mesh() is None
    assert GPUSolver(device="cpu").mesh is None and TPUSolver().mesh is None
    monkeypatch.setenv("KARPENTER_SOLVER_MESH", "auto")
    assert sh.default_mesh() is not None and jsh.default_mesh() is not None


def test_explicit_none_overrides_auto(monkeypatch):
    monkeypatch.setenv("KARPENTER_SOLVER_MESH", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert GPUSolver(device="cpu", mesh=None).mesh is None
    assert TPUSolver(mesh=None).mesh is None


def test_mesh_on_another_device_is_refused():
    with pytest.raises(ValueError, match="not the solver's"):
        GPUSolver(device="cpu", mesh=sh.make_mesh([torch.device("meta")] * 2))


def test_make_mesh_repeats_a_device():
    mesh = sh.make_mesh(["cpu"] * 8)
    assert mesh.size == 8 and mesh.devices == (torch.device("cpu"),) * 8
    assert sh.mesh_device(mesh) == torch.device("cpu")


def test_one_shard_mesh_degenerates_to_unsharded():
    """A one-shard mesh takes the single-device path (mesh.size > 1 gates
    the meshed pack) and still keeps a resident carry for deltas."""
    s = GPUSolver(device="cpu", force=True, mesh=sh.make_mesh(["cpu"]), recorder=TraceRecorder(enabled=True))
    snap = snapshot_from_reference(make_snapshot(_mixed_pods(5, 0)))
    s.solve(snap)
    assert s.last_solve_mode == "full"
    assert s._resident is not None and not isinstance(s._resident["state"], sh.ShardedState)
    assert "shard_exchange" not in s._trace.phase_totals
    snap.pods.append(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", memory="512Mi", name="x")])).pods[0])
    r = s.solve(snap)
    assert s.last_solve_mode == "delta"
    assert not r.pod_errors


# -- parity with the reference's meshed solver, every mode ----------------------------


def test_full_parity(gathered_carry):
    chain = mesh_chain(make_snapshot(_mixed_pods()), force=True)
    assert chain.step()["mode"] == "full"
    assert isinstance(chain.gpu._resident["state"], sh.ShardedState)


def test_delta_parity_add_and_remove(gathered_carry):
    """The delta path serves an addition and a removal from the gathered
    meshed carry, as the reference's delta runs over its sharded carry."""
    snap = make_snapshot(_mixed_pods())
    chain = mesh_chain(snap, force=True)
    chain.step("full")
    snap.pods.append(make_pod(cpu="500m", memory="512Mi", name="extra"))
    chain.step("add")
    snap.pods.pop()
    snap.pods.pop(0)
    chain.step("remove")
    assert chain.modes() == ["full", "delta", "delta"]


def test_hybrid_and_hybrid_delta_parity(gathered_carry):
    snap = make_snapshot(_mixed_pods(12, 0) + [_odd_pod()])
    chain = mesh_chain(snap)
    assert chain.step("hybrid")["backend"] == "hybrid"
    snap.pods.append(make_pod(cpu="500m", memory="512Mi", name="late"))
    chain.step("hybrid-delta")
    assert chain.modes() == ["hybrid", "hybrid-delta"]


@pytest.mark.parametrize("n_dev,n_pods", [(3, 7), (5, 9)])
def test_padding_edges_non_divisible(gathered_carry, n_dev, n_pods):
    """Pod, item and slot counts not divisible by the shard count, on
    non-power-of-two meshes."""
    chain = mesh_chain(make_snapshot(_mixed_pods(n_pods, 2)), n_dev=n_dev, force=True)
    got = chain.step()
    assert got["mode"] == "full" and not got["results"][2]
    t = chain.gpu._resident["t"]
    assert t.n_slots % n_dev == 0


def test_every_mode_traces_and_counts_as_the_reference(gathered_carry):
    """full -> delta -> hybrid -> hybrid-delta -> delta, flight-recorded on
    both meshed solvers: Results, carries, traces and counters equal."""
    snap = make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(5)])
    chain = TracedChain(snap)
    chain.ref_solver = TPUSolver(registry=chain.ref_reg, recorder=RefRecorder(enabled=True), mesh=jsh.make_mesh())
    chain.gpu = GPUSolver(device="cpu", registry=chain.port_reg, recorder=TraceRecorder(enabled=True),
                          mesh=sh.make_mesh(["cpu"] * 8))
    steps = [
        ("full", lambda: None),
        ("delta", lambda: snap.pods.append(make_pod(cpu="500m", name="p5"))),
        ("hybrid", lambda: snap.pods.append(_odd_pod())),
        ("hybrid-delta", lambda: snap.pods.append(make_pod(cpu="500m", name="p6"))),
        ("delta", lambda: snap.pods.remove(next(p for p in snap.pods if p.metadata.name == "odd"))),
    ]
    for expected, mutate in steps:
        mutate()
        assert chain.step(expected)["mode"] == expected


# -- the trace surface ------------------------------------------------------------------


def test_watchlist_covers_sharded_kernels(monkeypatch):
    """The sentinel watches `pack_sharded` and `shard_feas`; a library load
    made under the meshed pack (the first K1 launch, inside
    `sharded_feasibility`) counts once under `shard_feas`, and a warm meshed
    solve records none."""
    from karpenter_tpu_torch.kernels import feasibility

    monkeypatch.setattr(build, "LOADS", {})
    real = feasibility.compat_and_key
    loaded = []

    def compat_and_key(*a, **k):
        if not loaded:  # the load a first CUDA launch pays
            loaded.append(1)
            build.count_load()
        return real(*a, **k)

    monkeypatch.setattr(feasibility, "compat_and_key", compat_and_key)
    s = GPUSolver(device="cpu", force=True, recorder=TraceRecorder(enabled=True), mesh=sh.make_mesh(["cpu"] * 8))
    snap = snapshot_from_reference(make_snapshot(_mixed_pods(6, 0)))
    s.solve(snap)
    labels = sentinel().snapshot()
    assert "pack_sharded" in labels and "shard_feas" in labels
    assert build.LOADS == {"shard_feas": 1} and s._trace.recompiles == {"shard_feas": 1}
    s.solve(snap)  # warm: the identical resubmit
    assert s._trace.recompiles == {}


def test_shard_exchange_span_recorded():
    """The meshed pack runs under a `shard_exchange` span (n_dev the mesh
    size) inside `pack`, as the reference's: the two span trees, the port's
    own stages left out, are equal."""
    pods = _mixed_pods(6, 0)
    ref = TPUSolver(force=True, recover=False, recorder=RefRecorder(enabled=True), mesh=jsh.make_mesh())
    ref.solve(make_snapshot(pods))
    rec = TraceRecorder(enabled=True)
    s = GPUSolver(device="cpu", force=True, recorder=rec, mesh=sh.make_mesh(["cpu"] * 8))
    s.solve(snapshot_from_reference(make_snapshot(pods)))
    tr = rec.last()
    pack = next(sp for sp in tr.spans if sp.name == "pack")
    exch = [c for c in pack.children if c.name == "shard_exchange"]
    assert exch and exch[0].attrs.get("n_dev") == 8
    assert tr.phase_totals.get("shard_exchange", 0) > 0
    assert span_tree(tr.spans, port=True) == span_tree(ref._trace.spans, port=False)
