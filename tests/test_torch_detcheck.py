"""The port's determinism check (`obs/detcheck.py`, `GPUSolver.check_determinism`)
on the CPU: `tests/test_detcheck.py`'s cases with no serving in them.

One solver (`GPUSolver(device="cpu")`) is driven through every exit path
(full / delta / hybrid / hybrid-delta / grouped full / fallback) with
``KARPENTER_SOLVER_DETCHECK=1``; `check_determinism()` replays the recorded
sequence in a child process on the parent's device (here the CPU) under a
different PYTHONHASHSEED with every dict and set re-inserted in reversed
order, and must reproduce every mode and every placement digest. A
tampered digest raises `DetCheckError`. `perturb` and `results_digest`
behave as the reference's, and `results_digest` of the port's Results is
the reference's digest of its own Results for the same snapshot. Exact.
"""

from __future__ import annotations

import os

import pytest
import torch

from helpers import make_pod
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.obs import detcheck as ref_detcheck
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.obs import detcheck
from karpenter_tpu_torch.obs.detcheck import DetCheckError, perturb, results_digest
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.carry_over import SnapshotMirror, snapshot_from_reference
from test_detcheck import _Claim, _grouped_pods, _Node, _Res
from test_solve_modes import _global_pod, _odd_pod
from test_solver import make_snapshot
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import clear_globals, next_start, same_state

torch.set_num_threads(1)

ZONE = wk.ZONE_LABEL_KEY
EXPECTED_MODES = ["full", "delta", "hybrid", "hybrid-delta", "full", "fallback"]


@pytest.fixture
def detcheck_on(monkeypatch):
    monkeypatch.setenv("KARPENTER_SOLVER_DETCHECK", "1")
    detcheck._refresh()
    yield
    monkeypatch.delenv("KARPENTER_SOLVER_DETCHECK", raising=False)
    detcheck._refresh()


def _matrix_walk(solver):
    """Drive one port solver through every exit path (the reference test's
    walk, over carried snapshots); returns the modes taken."""
    clear_globals()
    modes = []
    ref = make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(5)])
    mirror = SnapshotMirror()

    def solve(snap):
        solver.solve(snap)
        modes.append(solver.last_solve_mode)

    solve(mirror.snapshot(ref))
    ref.pods.append(make_pod(cpu="500m", name="p5"))
    solve(mirror.snapshot(ref))
    ref.pods.append(_odd_pod())
    solve(mirror.snapshot(ref))
    ref.pods.append(make_pod(cpu="500m", name="p6"))
    solve(mirror.snapshot(ref))
    solve(snapshot_from_reference(make_snapshot(_grouped_pods())))
    solve(snapshot_from_reference(make_snapshot(
        [_global_pod()] + [make_pod(cpu="1", labels={"app": "other"}, name=f"o{i}") for i in range(2)])))
    return modes


class TestDualRunMatrix:
    def test_mode_matrix_dual_run(self, detcheck_on):
        solver = GPUSolver(device="cpu")
        modes = _matrix_walk(solver)
        assert modes == EXPECTED_MODES
        assert len(detcheck.solve_log(solver).entries) == len(EXPECTED_MODES)
        out = solver.check_determinism()
        assert out["solves"] == len(EXPECTED_MODES)
        assert out["parent_modes"] == EXPECTED_MODES
        # the replay retraces the same paths, on the parent's device
        assert out["child_modes"] == EXPECTED_MODES
        assert out["device"] == "cpu" and out["hash_seed"] != "" and out["child_seconds"] > 0
        with pytest.raises(DetCheckError, match="no recorded solves"):
            solver.check_determinism()

    def test_tampered_digest_raises(self, detcheck_on):
        solver = GPUSolver(device="cpu")
        solver.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name="t0")])))
        log = detcheck.solve_log(solver)
        assert len(log.entries) == 1
        log.entries[0]["digest"] = "0" * 64
        with pytest.raises(DetCheckError, match="diverged"):
            solver.check_determinism()

    def test_not_enabled_raises(self):
        assert not detcheck.detcheck_enabled()
        with pytest.raises(DetCheckError, match="not enabled"):
            GPUSolver(device="cpu").check_determinism()


class TestSnapshotDump:
    def test_dump_and_load_solve_alike(self):
        """A dumped snapshot rebuilt (and perturbed) in this process solves
        to the same digest and mode."""
        clear_globals()
        snap = snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"d{i}") for i in range(6)]))
        log = detcheck._SolveLog()
        blob = detcheck.dump_snapshot(snap, log.token_of)
        start = next_start()
        same_state(start)
        want = results_digest(GPUSolver(device="cpu").solve(snap))
        rebuilt = detcheck.load_snapshot(blob, {}, {})
        assert [p.metadata.name for p in rebuilt.pods] == [p.metadata.name for p in snap.pods]
        clear_globals()
        same_state(start)
        assert results_digest(GPUSolver(device="cpu").solve(rebuilt)) == want

    def test_stamped_pods_replay_with_their_signature_groups(self):
        """Pods dumped after an encode carry the encoder's signature stamps;
        rebuilt from the dump they keep one signature per shape (the stamps'
        signatures interned again), not one per pod. The reference's replay
        does not intern them and reports a false divergence on large
        snapshots solved before the recording (ROADMAP Queue 3)."""
        from karpenter_tpu_torch.solver import encode as encode_mod

        clear_globals()
        snap = snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"s{i}") for i in range(8)]
                                                     + [make_pod(cpu="1", name=f"b{i}") for i in range(4)]))
        GPUSolver(device="cpu").solve(snap)  # stamps the pods
        blob = detcheck.dump_snapshot(snap, detcheck._SolveLog().token_of)
        rebuilt = detcheck.load_snapshot(blob, {}, {})
        assert all(getattr(p, "_sig_stamp", None) is not None for p in rebuilt.pods)
        # the encoder's signature grouping goes by the stamped signature object
        grouped, _arts = encode_mod._columnar_group(rebuilt.pods)
        assert grouped[0].tolist() == [0] * 8 + [1] * 4 and len(grouped[2]) == 2
        assert encode_mod.encode(rebuilt).n_sigs == encode_mod.encode(snap).n_sigs == 2

    def test_dual_run_after_earlier_solves(self, detcheck_on, monkeypatch):
        """Solves made before the recording leave stamps on the pods: the
        replay still reproduces the recorded digests."""
        monkeypatch.delenv("KARPENTER_SOLVER_DETCHECK")
        detcheck._refresh()
        clear_globals()
        snap = snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"e{i}") for i in range(20)]))
        GPUSolver(device="cpu").solve(snap)
        monkeypatch.setenv("KARPENTER_SOLVER_DETCHECK", "1")
        detcheck._refresh()
        solver = GPUSolver(device="cpu")
        solver.solve(snap)
        assert solver.check_determinism()["child_modes"] == ["full"]


class TestDigestAcrossPackages:
    @pytest.mark.parametrize("build", ["plain", "hybrid", "fallback", "grouped"])
    def test_port_digest_equals_reference_digest(self, build):
        pods = {
            "plain": lambda: [make_pod(cpu="500m", name=f"p{i}") for i in range(5)],
            "hybrid": lambda: [make_pod(cpu="500m", name=f"p{i}") for i in range(4)] + [_odd_pod()],
            "fallback": lambda: [_global_pod()] + [make_pod(cpu="1", labels={"app": "other"}, name=f"o{i}")
                                                    for i in range(2)],
            "grouped": _grouped_pods,
        }[build]
        ref = make_snapshot(pods())
        port = snapshot_from_reference(ref)
        clear_globals()
        start = next_start()
        same_state(start)
        want = ref_detcheck.results_digest(TPUSolver(recover=False).solve(ref))
        same_state(start)
        assert results_digest(GPUSolver(device="cpu").solve(port)) == want


class TestPerturb:
    def test_dict_reversed_content_equal(self):
        d = {"a": 1, "b": 2, "c": 3}
        out = perturb(d)
        assert out == d and list(out) == ["c", "b", "a"]

    def test_set_rebuilt_content_equal(self):
        s = {10, 20, 30}
        out = perturb(s)
        assert out == s and out is not s
        fz = perturb(frozenset({"a", "b"}))
        assert fz == frozenset({"a", "b"}) and isinstance(fz, frozenset)

    def test_sequences_keep_order(self):
        v = [{"x": 1, "y": 2}, ({"p": 3, "q": 4},)]
        out = perturb(v)
        assert out == v and list(out[0]) == ["y", "x"] and list(out[1][0]) == ["q", "p"]

    def test_shared_identity_preserved(self):
        shared = {"k": 1, "j": 2}
        out = perturb([shared, shared])
        assert out[0] is out[1]

    def test_object_dict_rotated_in_place(self):
        class Box:
            pass

        b = Box()
        b.first, b.second, b.third = 1, 2, 3
        out = perturb(b)
        assert out is b and list(vars(b)) == ["third", "second", "first"]
        assert (b.first, b.second, b.third) == (1, 2, 3)


class TestResultsDigest:
    def test_order_insensitive_and_equal_to_the_reference(self):
        a = _Res(claims=[_Claim("np", ["t1", "t2"], ["a", "b"]), _Claim("np", ["t3"], ["c"])],
                 nodes=[_Node("n1", ["d"])], errors={"e1": ValueError("x"), "e2": ValueError("y")})
        b = _Res(claims=[_Claim("np", ["t3"], ["c"]), _Claim("np", ["t2", "t1"], ["b", "a"])],
                 nodes=[_Node("n1", ["d"])], errors={"e2": ValueError("y"), "e1": ValueError("x")})
        assert results_digest(a) == results_digest(b) == ref_detcheck.results_digest(a)

    def test_node_claim_names_do_not_matter_but_placement_does(self):
        base = _Res(claims=[_Claim("np", ["t1"], ["a", "b"])])
        moved = _Res(claims=[_Claim("np", ["t1"], ["a", "c"])])
        assert results_digest(base) != results_digest(moved)
        with_empty = _Res(claims=[_Claim("np", ["t1"], ["a", "b"])], nodes=[_Node("idle", [])])
        assert results_digest(base) == results_digest(with_empty)

    def test_timeout_and_errors_are_part_of_the_contract(self):
        assert results_digest(_Res()) != results_digest(_Res(timed_out=True))
        assert results_digest(_Res()) != results_digest(_Res(errors={"p": RuntimeError("no fit")}))


class TestOffSwitch:
    def test_disabled_records_nothing(self):
        assert not detcheck.detcheck_enabled()
        solver = GPUSolver(device="cpu")
        solver.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name="q0")])))
        assert getattr(solver, "_detcheck_log", None) is None

    def test_recording_never_changes_placement(self, detcheck_on):
        def pods():
            return [make_pod(cpu="500m", name=f"r{i}") for i in range(4)]

        start = next_start()
        same_state(start)
        on = GPUSolver(device="cpu")
        r_on = on.solve(snapshot_from_reference(make_snapshot(pods())))
        assert len(detcheck.solve_log(on).entries) == 1
        os.environ.pop("KARPENTER_SOLVER_DETCHECK", None)
        detcheck._refresh()
        try:
            same_state(start)
            off = GPUSolver(device="cpu")
            r_off = off.solve(snapshot_from_reference(make_snapshot(pods())))
        finally:
            os.environ["KARPENTER_SOLVER_DETCHECK"] = "1"
            detcheck._refresh()
        assert results_digest(r_on) == results_digest(r_off)
        assert getattr(off, "_detcheck_log", None) is None
