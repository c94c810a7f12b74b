"""GPUSolver's recovery ladder against the reference's, on the CPU.

`tests/test_faultline.py:150-208` on both solvers: each package's own
`serving.faults.FaultInjector` hook, built from the same rules, drives
`TPUSolver()` and `GPUSolver(device="cpu")` through the same faults, and
each side recovers
as the reference does — a single fault through the quarantined full
re-encode, a double fault through the host FFD, an unrecoverable fault and
force mode propagating, the poisoned carry quarantined and the delta path
re-warmed after one full solve — with equal Results, backend ("gpu" for the
reference's "tpu"), recovery notes and recovery counters. Exact.

Then the port's own departure from the reference: a kernel's failure (a
failed build or load, a launch's error code, a wrapper's refusal of its
arguments: each a `kernels.build.KernelError`) and a CUDA error raised by
torch on a CUDA solve are never absorbed: they propagate, and the host FFD
never answers for them.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from helpers import make_pod
from karpenter_tpu import metrics as ref_metrics
from karpenter_tpu.serving import faults as ref_faults
from karpenter_tpu.serving.faults import FaultRule
from karpenter_tpu.solver.tpu import RECOVERY_STAGES as REF_STAGES
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch import metrics as m
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.obs.trace import TraceRecorder
from karpenter_tpu_torch.serving import faults as port_faults
from karpenter_tpu_torch.serving.faults import FaultInjected
from karpenter_tpu_torch.solver import gpu as gpu_mod
from karpenter_tpu_torch.solver.gpu import RECOVERY_STAGES, GPUSolver
from karpenter_tpu_torch.testing.carry_over import SnapshotMirror, snapshot_from_reference
from test_solver import make_snapshot
from test_torch_metrics import assert_same_registry
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import clear_globals, next_start, outcome, same_state

torch.set_num_threads(1)


def _pair(rules, force: bool = False):
    """A reference solver and a port solver, each with its own registry and
    enabled recorder and its own package's injector of the same rules."""
    from karpenter_tpu.obs.trace import TraceRecorder as RefRecorder

    ref = TPUSolver(force=force, registry=ref_metrics.make_registry(), recorder=RefRecorder(enabled=True))
    port = GPUSolver(device="cpu", force=force, registry=m.make_registry(), recorder=TraceRecorder(enabled=True))
    ref.fault_hook = ref_faults.FaultInjector(ref_faults.FaultSpec(rules=tuple(rules))).solver_hook
    port.fault_hook = port_injector(rules).solver_hook
    return ref, port


def port_injector(rules):
    """The port's injector of the reference's rules."""
    return port_faults.FaultInjector(port_faults.FaultSpec(
        rules=tuple(port_faults.FaultRule(**dataclasses.asdict(r)) for r in rules)))


def _solve_both(ref, port, ref_snap, port_snap, what: str) -> dict:
    start = next_start()
    same_state(start)
    want = outcome(ref, ref.solve(ref_snap), port=False)
    same_state(start)
    got = outcome(port, port.solve(port_snap), port=True)
    for key in ("results", "mode", "backend", "reasons"):
        assert got[key] == want[key], f"{what}: {key} {got[key]!r}, reference {want[key]!r}"
    notes = ("recovery", "recovery_error", "recovery_error2", "encode_mode", "row_cache", "delta_reject")
    assert {k: port._trace.attribution.get(k) for k in notes} == {k: ref._trace.attribution.get(k) for k in notes}
    assert_same_registry(port.registry, ref.registry, what)
    return got


def test_recovery_stages_are_the_reference_enum():
    assert tuple(RECOVERY_STAGES) == tuple(REF_STAGES) == ("full-reencode", "host-ffd")


def test_solve_exception_recovers_via_full_reencode():
    pods = [make_pod(cpu="1", name=f"r-{i}") for i in range(8)]
    clear_globals()
    ref, port = _pair([FaultRule("solve-exception", at=0, ladder=1)])
    snap = make_snapshot(pods)
    got = _solve_both(ref, port, snap, snapshot_from_reference(snap), "full-reencode")
    assert got["backend"] == "gpu" and got["mode"] == "full"
    assert port.registry.counter(m.SOLVER_RECOVERY_TOTAL).value(stage="full-reencode") == 1
    assert port.registry.counter(m.SOLVER_RECOVERY_TOTAL).value(stage="host-ffd") == 0
    tr = port.recorder.last()
    assert tr.attribution["recovery"] == "full-reencode" and "FaultInjected" in tr.attribution["recovery_error"]


def test_double_fault_degrades_to_host_ffd():
    pods = [make_pod(cpu="1", name=f"h-{i}") for i in range(8)]
    clear_globals()
    ref, port = _pair([FaultRule("decode-failure", at=0, ladder=2)])
    snap = make_snapshot(pods)
    got = _solve_both(ref, port, snap, snapshot_from_reference(snap), "host-ffd")
    assert got["backend"] == "ffd-fallback" and not got["results"][2]
    assert port.registry.counter(m.SOLVER_RECOVERY_TOTAL).value(stage="host-ffd") == 1
    assert port.recorder.last().attribution["recovery"] == "host-ffd"
    assert port.last_fallback_family == "recovery"


@pytest.mark.parametrize("force", [False, True], ids=["unrecoverable", "force"])
def test_unrecoverable_fault_and_force_escape_the_ladder(force):
    ladder = 1 if force else 0
    ref, port = _pair([FaultRule("solve-exception", at=0, ladder=ladder)], force=force)
    snap = make_snapshot([make_pod(cpu="1")])
    with pytest.raises(ref_faults.FaultInjected):
        ref.solve(snap)
    with pytest.raises(FaultInjected):
        port.solve(snapshot_from_reference(snap))
    assert port.recorder.last().mode == "" and port.registry.counter(m.SOLVER_RECOVERY_TOTAL).total() == 0


def test_recover_false_propagates():
    port = GPUSolver(device="cpu", recover=False)
    port.fault_hook = port_injector([FaultRule("solve-exception", at=0, ladder=1)]).solver_hook
    with pytest.raises(FaultInjected):
        port.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="1")])))


def test_poisoned_carry_never_serves_again_and_delta_rewarms():
    pods = [make_pod(cpu="500m", name=f"w-{i}") for i in range(12)]
    clear_globals()
    ref, port = _pair([FaultRule("solve-exception", at=1, ladder=1)])
    snap = make_snapshot(list(pods))
    mirror = SnapshotMirror()
    assert _solve_both(ref, port, snap, mirror.snapshot(snap), "warm")["mode"] == "full"
    base_cache = port.encode_cache
    snap.pods.append(make_pod(cpu="500m", name="w-extra"))
    got = _solve_both(ref, port, snap, mirror.snapshot(snap), "fault")
    assert port.encode_cache is not base_cache and got["mode"] == "full"
    assert port.recorder.last().attribution["recovery"] == "full-reencode"
    snap.pods.append(make_pod(cpu="500m", name="w-extra2"))
    got = _solve_both(ref, port, snap, mirror.snapshot(snap), "rewarm")
    assert got["mode"] == "delta" and not got["results"][2]


def test_slow_solve_injects_latency_only():
    pods = [make_pod(cpu="1", name=f"s-{i}") for i in range(4)]
    clear_globals()
    ref, port = _pair([FaultRule("slow-solve", at=0, arg=0.05)])
    snap = make_snapshot(pods)
    got = _solve_both(ref, port, snap, snapshot_from_reference(snap), "slow")
    assert got["backend"] == "gpu" and port.registry.counter(m.SOLVER_RECOVERY_TOTAL).total() == 0


# -- the port's own: kernel faults escape the ladder ---------------------------------

def _kernel_fault(*_a, **_k):
    build.check(700, "pack_scan")  # a launch's CUDA error code


@pytest.mark.parametrize("where", ["pack", "recredit", "reencode"])
def test_a_kernel_error_escapes_the_ladder(where, monkeypatch):
    """A kernel's launch error during the pack (full or delta), or during
    the ladder's own re-encode retry, propagates: the host FFD never answers
    for it, and the recovery counters stay where the reference's ladder
    would have left them before its first step."""
    reg = m.make_registry()
    solver = GPUSolver(device="cpu", registry=reg, recorder=TraceRecorder(enabled=True))
    ref = make_snapshot([make_pod(cpu="500m", name=f"k-{i}") for i in range(6)])
    mirror = SnapshotMirror()
    clear_globals()
    if where == "pack":
        monkeypatch.setattr(gpu_mod, "greedy_pack_grouped_compressed", _kernel_fault)
    elif where == "recredit":
        solver.solve(mirror.snapshot(ref))
        ref.pods.pop()
        monkeypatch.setattr(gpu_mod, "recredit_removals", _kernel_fault)
    else:
        calls = []

        def hook(stage):
            calls.append(stage)
            if stage == "solve":
                raise RuntimeError("a transient fault")
            _kernel_fault()

        solver.fault_hook = hook
    with pytest.raises(build.KernelError, match="CUDA error 700") as e:
        solver.solve(mirror.snapshot(ref))
    assert e.value.unrecoverable
    assert solver.last_backend != "ffd-fallback"
    assert reg.counter(m.SOLVER_RECOVERY_TOTAL).value(stage="host-ffd") == 0
    assert reg.counter(m.SOLVER_FALLBACK_TOTAL).total() == 0
    if where == "reencode":
        assert calls == ["solve", "reencode"]
        assert reg.counter(m.SOLVER_RECOVERY_TOTAL).value(stage="full-reencode") == 1


def test_build_and_load_failures_are_kernel_errors(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _n: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelError, match="nvcc not found") as e:
        build._nvcc()
    assert e.value.unrecoverable and isinstance(e.value, RuntimeError)
    build.check(0, "ok")
    with pytest.raises(build.KernelError):
        build.check(1, "feasibility")


def test_cuda_errors_on_a_cuda_solve_are_device_faults():
    """Which exceptions a CUDA solve never hands to the ladder: the kernel
    errors (a wrapper's argument refusal among them), torch's CUDA errors,
    a device mismatch and out-of-memory; an ordinary host exception still
    recovers. A CPU solve treats only `unrecoverable` faults so."""
    solver = GPUSolver(device="cpu")
    assert solver._device_fault(build.KernelError("x"))
    assert solver._device_fault(build.KernelArgError("masks: not contiguous"))
    assert not solver._device_fault(RuntimeError("CUDA error: an illegal memory access was encountered"))
    solver.device = torch.device("cuda")
    assert solver._device_fault(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert solver._device_fault(RuntimeError("Expected all tensors to be on the same device, but found at least "
                                             "two devices, cuda:0 and cpu!"))
    assert solver._device_fault(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert solver._device_fault(build.KernelTypeError("req: dtype torch.float64, expected torch.float32"))
    assert solver._device_fault(build.KernelArgError("pack_scan: carry does not match n_slots"))
    assert not solver._device_fault(RuntimeError("a transient fault"))
    assert not solver._device_fault(ValueError("bad input"))


_CUDA = torch.device("cuda")


@pytest.mark.parametrize("refusal", ["device", "dtype", "layout", "not-a-tensor"])
def test_a_kernel_argument_refusal_escapes_the_ladder(refusal, monkeypatch):
    """`build.require` refusing a tensor on the card's path (wrong device,
    dtype, layout, or no tensor) raises a `KernelError` that is also the
    ValueError / TypeError it was, and the solve propagates it: no
    full re-encode, no host FFD."""
    x = torch.zeros((2, 3), dtype=torch.int32)
    args = {"device": (x, _CUDA, torch.int32), "dtype": (x, x.device, torch.float32),
            "layout": (x.t(), x.device, torch.int32), "not-a-tensor": ([0, 1], _CUDA, torch.int32)}[refusal]
    base = TypeError if refusal in ("dtype", "not-a-tensor") else ValueError
    with pytest.raises(base) as e:
        build.require(*args, "masks")
    assert isinstance(e.value, build.KernelError) and e.value.unrecoverable

    def refused(*_a, **_k):
        build.require(*args, "masks")

    reg = m.make_registry()
    solver = GPUSolver(device="cpu", registry=reg, recorder=TraceRecorder(enabled=True))
    monkeypatch.setattr(gpu_mod, "greedy_pack_grouped_compressed", refused)
    ref = make_snapshot([make_pod(cpu="500m", name=f"r-{i}") for i in range(4)])
    clear_globals()
    with pytest.raises(build.KernelError, match="masks"):
        solver.solve(snapshot_from_reference(ref))
    assert solver.last_backend != "ffd-fallback"
    assert reg.counter(m.SOLVER_RECOVERY_TOTAL).total() == 0 and reg.counter(m.SOLVER_FALLBACK_TOTAL).total() == 0
    assert solver.recorder.last().attribution.get("recovery") is None


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _wrapper_calls():
    """Each kernel wrapper called on tensors of a device it has no launch
    for (the meta device): the refusal its CUDA path makes first."""
    from types import SimpleNamespace as NS

    from karpenter_tpu_torch.kernels import anneal, feasibility, globalpack, pack_scan, perpod_pack, recredit
    from karpenter_tpu_torch.kernels import score_subsets, sparsify

    x = _meta(2, 2)
    return {
        "feasibility": lambda: feasibility.compat_and_key(None, None, None, x),
        "pack_scan": lambda: pack_scan.pack_scan(None, NS(item_req=x), None, None, n_slots=2),
        "pack_scan_sharded": lambda: pack_scan.pack_scan_sharded(None, NS(item_req=x), None, None, n_slots=2,
                                                                 n_shards=2),
        "pack_scan_cluster": lambda: pack_scan.pack_scan_sharded_cluster(None, NS(item_req=x), None, None,
                                                                         n_slots=2, n_shards=2),
        "sparsify": lambda: sparsify.flat_outputs(x, None, None, None, None, 4),
        "recredit": lambda: recredit.recredit(None, None, x, None, None, None),
        "globalpack": lambda: globalpack.globalpack(None, None, None, None, None, x, None, 1),
        "score_subsets": lambda: score_subsets.score_subsets_packed(None, None, None, None, 0.0, None, x),
        "anneal_pack": lambda: anneal.anneal_prepass(NS(pod_compat=x), None),
        "anneal": lambda: anneal.anneal(None, x, None, None),
        "perpod_pack": lambda: perpod_pack.perpod_pack(None, NS(pod_req=x), None, None),
    }


@pytest.mark.parametrize("kernel", sorted(build.LAUNCHES))
def test_every_wrapper_refuses_with_a_kernel_error(kernel):
    """Every wrapper's refusal before a launch is a `KernelError` (here: a
    device with no launch), so no solve or round can absorb it."""
    with pytest.raises(build.KernelArgError, match="unsupported device meta"):
        _wrapper_calls()[kernel]()
