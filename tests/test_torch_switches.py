"""The reference's switches on the port, on the CPU: that the port reads the
reference's `KARPENTER_*` names, and that each non-default arm runs and
gives the reference's result.

- One scan of the source of both packages: the `KARPENTER_*` names (every
  string constant that is a whole such name) under `karpenter_tpu/` are
  those under `karpenter_tpu_torch/`, which adds one of its own,
  `KARPENTER_SOLVER_SHARD_DEVICE` (the device the shard router hands its
  workers).
- `propose_subsets` (the annealed proposer, K7's plain version here) on the
  bench's consolidation fleet at 2, 24 and 100 nodes returns the
  reference's subsets in the reference's order, exactly.
- Multi-node consolidation's arms (`KARPENTER_CONSOLIDATE_LP` "1", "0",
  "anneal"): one `DisruptionController.reconcile(force=True)` over the
  bench's fleet starts the reference's commands and leaves the reference's
  disrupted taints and NodeClaims, live against the reference at 8 nodes
  ("0" and "anneal"; `tests/test_torch_consolidation_fleet.py` holds "1"
  there), and at `chip_smoke.ARMS_NODES` (128, the anneal arm's window full)
  against `karpenter_tpu_torch/fixtures/consolidation/fleet_128_arms.json`,
  which `chip_smoke.py` holds the card to; the "1" arm with the host
  switches at the reference's exact arms (`chip_smoke.EXACT_ARMS`) gives the
  same. "0" calls neither device proposer; a K7 that raises a
  RuntimeError fails the anneal round (the binary search never answers for
  it), while an encoder refusal falls back to the binary search.
- `ffd_batch=False` (and `KARPENTER_FFD_BATCH=0`) gives the reference's
  placements on `tests/test_torch_scheduler.py`'s scenarios.
- Each non-default arm really runs: `KARPENTER_ENCODE_COLUMNAR=0` calls
  `EncodeCache._legacy_signature` and stamps no pod, `KARPENTER_FFD_BATCH=0`
  leaves the fit memo empty, `KARPENTER_SOLVER_FASTDECODE=0` leaves the
  decode memo None, `KARPENTER_SIM_SHARED_SCHED=0` gives a simulator with no
  scheduler seed. `tests/test_torch_mesh_default.py` holds the
  `KARPENTER_SOLVER_MESH` arms (the kill switch's spellings, in both
  packages).

Tolerance: exact. Write the fixture (about 2 minutes, the reference's
three passes) with

    JAX_PLATFORMS=cpu python tests/test_torch_switches.py --write
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__":
    import conftest  # noqa: F401  (the test suite's JAX settings, before JAX loads)

import chip_smoke  # noqa: E402
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from test_torch_consolidation_fleet import reference_side  # noqa: E402
from test_torch_scheduler import SCENARIOS, solve_both  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"KARPENTER_[A-Z0-9_]+")
PORT_ONLY = {"KARPENTER_SOLVER_SHARD_DEVICE"}
SUBSET_SIZES = (2, 24, 100)
LIVE_NODES = 8


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


def karpenter_names(package: str) -> set[str]:
    """Every string constant under `package` that is a whole `KARPENTER_*`
    name."""
    out = set()
    for path in (ROOT / package).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and NAME.fullmatch(node.value):
                out.add(node.value)
    return out


def test_port_reads_the_reference_names():
    ref, port = karpenter_names("karpenter_tpu"), karpenter_names("karpenter_tpu_torch")
    assert ref - port == set()
    assert port - ref == PORT_ONLY
    assert {"KARPENTER_CONSOLIDATE_LP", "KARPENTER_SOLVER_MESH", "KARPENTER_FFD_BATCH", "KARPENTER_SIM_SHARED_SCHED",
            "KARPENTER_ENCODE_COLUMNAR", "KARPENTER_SOLVER_FASTDECODE", "KARPENTER_DISABLE_NATIVE",
            "KARPENTER_NATIVE_CACHE"} <= port


# -- the annealed proposer -------------------------------------------------------------


def _candidates(side):
    """The round's candidates in the controller's order and their instance
    types, as `MultiNodeConsolidation` gathers them."""
    cands = side.dc.get_candidates()
    pools = {c.node_pool.metadata.name: c.node_pool for c in cands}
    its = [it for name in pools for it in side.prov.cloud_provider.get_instance_types(pools[name])]
    return cands, its


@pytest.mark.parametrize("n", SUBSET_SIZES)
def test_propose_subsets_matches_reference(n):
    from karpenter_tpu.solver.consolidation import propose_subsets as ref_propose
    from karpenter_tpu_torch.solver.consolidation import propose_subsets

    ref_cands, ref_its = _candidates(reference_side(n))
    cands, its = _candidates(chip_smoke.arms_side("cpu", n))
    assert [c.name() for c in cands] == [c.name() for c in ref_cands]
    want = ref_propose(ref_cands, ref_its)
    got = propose_subsets(cands, its, device="cpu")
    assert got == want
    assert propose_subsets(cands[:1], its, device="cpu") == []
    if n > 2:
        assert got and list(range(n)) in got


# -- the consolidation arms ------------------------------------------------------------


def _ref_reset():
    from karpenter_tpu.solver.encode import clear_encode_globals

    clear_encode_globals()
    jsm.reset_bucket_highwater()


@pytest.mark.parametrize("arm", ["0", "anneal"])  # "1": test_torch_consolidation_fleet.test_round_matches_reference_small
def test_arm_matches_reference_small(arm):
    want = chip_smoke.arm_pass(reference_side(LIVE_NODES), arm, reset=_ref_reset)
    got = chip_smoke.arm_pass(chip_smoke.arms_side("cpu", LIVE_NODES), arm)
    assert got == want
    assert want["commands"], f"the reference consolidates nothing under {arm}"


@pytest.mark.parametrize("arm", chip_smoke.ARMS)
def test_arm_matches_fixture(arm):
    want = json.loads(chip_smoke.ARMS_FIXTURE.read_text())
    assert want["nodes"] == chip_smoke.ARMS_NODES and want["seed"] == chip_smoke.CONS_ROUND_SEED
    got = chip_smoke.arm_pass(chip_smoke.arms_side("cpu"), arm)
    assert got == want["arms"][arm]


def test_exact_arms_give_the_default_command():
    want = json.loads(chip_smoke.ARMS_FIXTURE.read_text())["arms"]["1"]
    assert chip_smoke.arm_pass(chip_smoke.arms_side("cpu"), "1", chip_smoke.EXACT_ARMS) == want


def _spied(monkeypatch):
    """Which of the multi-node method's arms a round called."""
    from karpenter_tpu_torch.controllers.disruption.methods import MultiNodeConsolidation

    called = []
    for name in ("_first_n_consolidation_option", "_annealed_option", "_lp_option_iter", "_globalpack_option_iter"):
        real = getattr(MultiNodeConsolidation, name)

        def spy(self, *args, _real=real, _name=name, **kwargs):
            called.append(_name)
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(MultiNodeConsolidation, name, spy)
    return called


@pytest.mark.parametrize("value", ["0", "false", " OFF "])
def test_lp_off_runs_only_the_binary_search(monkeypatch, value):
    called = _spied(monkeypatch)
    got = chip_smoke.arm_pass(chip_smoke.arms_side("cpu", LIVE_NODES), value)
    assert set(called) == {"_first_n_consolidation_option"} and got["commands"]


def test_anneal_arm_tries_the_global_repack_first(monkeypatch):
    called = _spied(monkeypatch)
    chip_smoke.arm_pass(chip_smoke.arms_side("cpu", LIVE_NODES), "anneal", {"KARPENTER_SOLVER_GLOBALPACK": "1"})
    assert called[0] == "_globalpack_option_iter" and "_lp_option_iter" not in called


def test_k7_failure_fails_the_round(monkeypatch):
    import karpenter_tpu_torch.kernels.anneal as k7

    def broken(*args):
        raise RuntimeError("CUDA error: unspecified launch failure")

    called = _spied(monkeypatch)
    monkeypatch.setattr(k7, "anneal", broken)
    with pytest.raises(RuntimeError, match="launch failure"):
        chip_smoke.arm_pass(chip_smoke.arms_side("cpu", LIVE_NODES), "anneal")
    assert called == ["_annealed_option"]


def test_encoder_refusal_falls_back_to_the_binary_search(monkeypatch):
    import karpenter_tpu_torch.solver.consolidation as cons

    def refuse(*args, **kwargs):
        raise ValueError("bad candidate")

    called = _spied(monkeypatch)
    monkeypatch.setattr(cons, "encode_problem", refuse)
    got = chip_smoke.arm_pass(chip_smoke.arms_side("cpu", LIVE_NODES), "anneal")
    assert called == ["_annealed_option", "_first_n_consolidation_option"] and got["commands"]


# -- the unbatched FFD ---------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_unbatched_ffd_matches_reference(monkeypatch, name):
    from karpenter_tpu_torch.controllers.provisioning.scheduling import scheduler as sched

    built = []
    real = sched.Scheduler.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        built.append(self)

    monkeypatch.setattr(sched.Scheduler, "__init__", init)
    monkeypatch.setenv("KARPENTER_FFD_BATCH", "0")
    want, got = solve_both(SCENARIOS[name]())
    assert got == want
    assert built and all(not s.batch_enabled and not s._fit_memo for s in built)


# -- each non-default arm runs -------------------------------------------------------------


def _small_snapshot():
    from karpenter_tpu_torch.testing.scenarios import build_snapshot

    return build_snapshot(60, 12)


def test_ffd_batch_arms(monkeypatch):
    from karpenter_tpu_torch.controllers.provisioning.scheduling import Scheduler
    from karpenter_tpu_torch.solver.ffd import build_scheduler

    snap = _small_snapshot()
    on = build_scheduler(snap)
    on.solve(snap.pods)
    assert on.batch_enabled and on._fit_memo
    monkeypatch.setenv("KARPENTER_FFD_BATCH", "0")
    off = build_scheduler(snap)
    off.solve(snap.pods)
    assert not off.batch_enabled and not off._fit_memo and off._round_seed is None
    assert "ffd_batch" in Scheduler.__init__.__code__.co_varnames


def test_encode_columnar_arms(monkeypatch):
    from karpenter_tpu_torch.solver import encode as enc_mod

    calls = []
    real = enc_mod.EncodeCache._legacy_signature

    def legacy(self, pod):
        calls.append(pod.metadata.uid)
        return real(self, pod)

    monkeypatch.setattr(enc_mod.EncodeCache, "_legacy_signature", legacy)
    snap = _small_snapshot()
    monkeypatch.setenv("KARPENTER_ENCODE_COLUMNAR", "0")
    legacy_enc = enc_mod.encode(snap, enc_mod.EncodeCache())
    assert len(calls) == len(snap.pods)
    assert all(getattr(p, "_sig_stamp", None) is None for p in snap.pods)
    monkeypatch.delenv("KARPENTER_ENCODE_COLUMNAR")
    enc_mod.clear_encode_globals()
    columnar = enc_mod.encode(snap, enc_mod.EncodeCache())
    assert len(calls) == len(snap.pods) and all(getattr(p, "_sig_stamp", None) is not None for p in snap.pods)
    assert legacy_enc.sig_of_pod.tolist() == columnar.sig_of_pod.tolist()


def test_fastdecode_arms(monkeypatch):
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    snap = _small_snapshot()
    on = GPUSolver(device="cpu")
    on.solve(snap)
    assert on._decode_memo is not None
    monkeypatch.setenv("KARPENTER_SOLVER_FASTDECODE", "off")
    off = GPUSolver(device="cpu")
    off.solve(snap)
    off.solve(snap)
    assert off._decode_memo is None


@pytest.mark.parametrize("value,seeded", [("1", True), ("0", False), ("false", False), ("Off", False)])
def test_shared_sched_arms(monkeypatch, value, seeded):
    from karpenter_tpu_torch.solver.simulate import ConsolidationSimulator

    side = chip_smoke.arms_side("cpu", 4)
    monkeypatch.setenv("KARPENTER_SIM_SHARED_SCHED", value)
    sim = ConsolidationSimulator(side.prov, side.prov.cluster, side.clock, side.dc.get_candidates())
    assert (sim.sched_seed is not None) == seeded


def write_fixture() -> None:
    out = dict(nodes=chip_smoke.ARMS_NODES, seed=chip_smoke.CONS_ROUND_SEED, arms={})
    for arm in chip_smoke.ARMS:
        jsm.reset_bucket_highwater()
        out["arms"][arm] = chip_smoke.arm_pass(reference_side(chip_smoke.ARMS_NODES), arm, reset=_ref_reset)
        cmds = out["arms"][arm]["commands"]
        print(f"{arm}: {len(cmds)} command(s), sizes {[len(c[1]) for c in cmds]}, "
              f"{len(out['arms'][arm]['claims'])} NodeClaims")
    chip_smoke.ARMS_FIXTURE.write_text(json.dumps(out, sort_keys=True) + "\n")
    print(f"wrote {chip_smoke.ARMS_FIXTURE}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_fixture()
    else:
        print(__doc__)
