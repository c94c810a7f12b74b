"""The hybrid partitioned solve and hybrid-delta through `GPUSolver.solve`,
against the reference's default `TPUSolver(recover=False)`, on the CPU.

The cases are `tests/test_hybrid_solver.py`'s and `tests/test_hybrid_delta.py`'s
scenarios (their metric-counter assertions left out: the port has no
metrics registry). Each builds its snapshots with the reference's builders
and drives a chain of solves: at each step the reference's snapshot is
carried over (`testing.carry_over.SnapshotMirror`: one port store and
cluster following the reference's, every object carried once, so the
port's encoder sees the same pods by identity) and solved on both sides
from the same module state. At every step both must give equal canonical
`Results`, mode, backend (the port's "gpu" is the reference's "tpu"),
fallback and delta-reject reasons, and an equal resident carry (every
leaf, the assignment, basis and zoneset) and hybrid partition. Exact.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

from helpers import make_pod, zone_spread
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu.kube.objects import (
    Affinity,
    Container,
    PodAffinityTerm,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.carry_over import SnapshotMirror
from test_solver import make_snapshot
from test_torch_delta import _assert_same_state
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import assert_same, clear_globals, next_start, outcome, same_state

torch.set_num_threads(1)


def preferred_affinity_pod(name="odd", cpu="500m", labels=None, ports=None):
    """A pod whose only out-of-window constraint is a preferred pod
    affinity: the canonical pod-local fallback reason."""
    p = make_pod(cpu=cpu, name=name, labels=labels)
    if ports:
        p.spec.containers = [Container(resources=p.spec.containers[0].resources, ports=ports)]
    p.spec.affinity = Affinity(
        pod_affinity_preferred=[
            WeightedPodAffinityTerm(
                weight=1,
                term=PodAffinityTerm(label_selector={"matchLabels": {"x": "y"}}, topology_key=wk.ZONE_LABEL_KEY),
            )
        ]
    )
    return p


def assert_same_carry(gpu: GPUSolver, ref: TPUSolver, what: str) -> None:
    """The resident carry and the hybrid partition of both solvers agree."""
    got, want = gpu._resident, ref._resident
    assert (got is None) == (want is None), f"{what}: resident carry {got is not None}, reference {want is not None}"
    if got is not None:
        _assert_same_state(got["state"], want["state"], f"{what}: carry")
        for key in ("assignment", "slot_basis", "slot_zoneset"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=f"{what}: {key}")
        # the carry is keyed by the encoding the solve packed (the masked one on a hybrid solve)
        assert got["enc"].n_pods == want["enc"].n_pods and got["enc"].n_sigs == want["enc"].n_sigs, what
    hs, hw = gpu._hybrid_state, ref._hybrid_state
    assert (hs is None) == (hw is None), f"{what}: hybrid state {hs is not None}, reference {hw is not None}"
    if hs is not None:
        np.testing.assert_array_equal(hs["keep"], hw["keep"], err_msg=f"{what}: keep")
        np.testing.assert_array_equal(hs["remap"], hw["remap"], err_msg=f"{what}: remap")
        assert got is not None and got["enc"] is hs["masked_enc"] and want["enc"] is hw["masked_enc"], what
        assert hs["masked_enc"].n_pods == hw["masked_enc"].n_pods, what


class Chain:
    """A chain of solves over one reference snapshot, mutated in place
    between steps, solved by the reference and the port side by side."""

    def __init__(self, ref_snap, force: bool = False):
        self.ref = ref_snap
        self.mirror = SnapshotMirror()
        self.ref_solver = TPUSolver(force=force, recover=False)
        self.gpu = GPUSolver(device="cpu", force=force)
        self.steps: list[dict] = []
        clear_globals()

    def step(self, what: str = "") -> dict:
        what = f"step {len(self.steps)} {what}".strip()
        port_snap = self.mirror.snapshot(self.ref)
        start = next_start()
        same_state(start)
        want = outcome(self.ref_solver, self.ref_solver.solve(self.ref), port=False)
        same_state(start)
        results = self.gpu.solve(port_snap)
        got = outcome(self.gpu, results, port=True)
        assert_same(want, got, what)
        assert self.gpu.encode_cache.last_delta_reject == self.ref_solver.encode_cache.last_delta_reject, what
        assert_same_carry(self.gpu, self.ref_solver, what)
        got["placed"] = {p.metadata.name for nc in results.new_node_claims for p in nc.pods} | {
            p.metadata.name for en in results.existing_nodes for p in en.pods}
        self.steps.append(got)
        return got

    def modes(self) -> list[str]:
        return [s["mode"] for s in self.steps]


def _hybrid_snap(n_plain=6):
    pods = [make_pod(cpu="500m", name=f"p{i}") for i in range(n_plain)] + [preferred_affinity_pod()]
    return make_snapshot(pods)


def _existing_node_snap(pods):
    from test_sharded import existing_node_snapshot

    return existing_node_snapshot(pods, [catalog.make_instance_type("c", 4, zones=["test-zone-a"])])


# -- tests/test_hybrid_solver.py ---------------------------------------------------

def _spread_seam_pods():
    sel = {"matchLabels": {"app": "w"}}
    spread = zone_spread(selector=sel)
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[spread]) for _ in range(4)]
    multi = make_pod(cpu="1", name="multi", labels={"app": "w"}, tsc=[spread])
    multi.spec.affinity = preferred_affinity_pod().spec.affinity
    return pods + [multi]


def _shared_affinity_pods():
    sel = {"matchLabels": {"grp": "co"}}
    aff_term = PodAffinityTerm(label_selector=sel, topology_key=wk.ZONE_LABEL_KEY)
    pods = [make_pod(cpu="1", labels={"grp": "co"}, pod_affinity=[aff_term]) for _ in range(3)]
    pods.append(make_pod(
        cpu="1", name="flagged", labels={"grp": "co", "f": "x"}, pod_affinity=[aff_term],
        tsc=[TopologySpreadConstraint(max_skew=1, topology_key=wk.HOSTNAME_LABEL_KEY,
                                      label_selector={"matchLabels": {"f": "x"}})]))
    return pods


def _asymmetric_anti_pods():
    sel = {"matchLabels": {"app": "other"}}
    return [make_pod(cpu="1", labels={"app": "me"}, anti_affinity=[PodAffinityTerm(label_selector=sel, topology_key=wk.ZONE_LABEL_KEY)])] + [
        make_pod(cpu="1", labels={"app": "other"}) for _ in range(3)]


def _ported_pods():
    ports = [{"containerPort": 80, "hostPort": 80}]
    tensor_ported = make_pod(cpu="100m", name="t-ported")
    tensor_ported.spec.containers = [Container(resources=tensor_ported.spec.containers[0].resources, ports=ports)]
    return [tensor_ported, preferred_affinity_pod(name="r-ported", cpu="100m", ports=ports)]


def _mixed_pods():
    return ([make_pod(cpu="1", name=f"a{i}") for i in range(5)]
            + [make_pod(cpu="2", memory="4Gi", name=f"b{i}") for i in range(3)]
            + [make_pod(cpu="1", name=f"z{i}", node_selector={wk.ZONE_LABEL_KEY: "test-zone-b"}) for i in range(2)]
            + [preferred_affinity_pod(name=f"odd{i}", cpu="1") for i in range(2)])


# name -> (snapshot builder, the mode of the cold solve and of the resubmit)
SINGLE = {
    "pod_local_partition": (lambda: _hybrid_snap(6), ("hybrid", "hybrid-delta")),
    "merged_placement": (lambda: _hybrid_snap(8), ("hybrid", "hybrid-delta")),
    "global_reason": (lambda: make_snapshot(_asymmetric_anti_pods()), ("fallback", "fallback")),
    "all_flagged": (lambda: make_snapshot([preferred_affinity_pod(name=f"o{i}") for i in range(3)]), ("fallback", "fallback")),
    "spread_seam": (lambda: make_snapshot(_spread_seam_pods()), ("hybrid", "hybrid-delta")),
    "shared_affinity": (lambda: make_snapshot(_shared_affinity_pods()), ("fallback", "fallback")),
    "parity_with_ffd": (lambda: make_snapshot(_mixed_pods()), ("hybrid", "hybrid-delta")),
    "residual_host_ports": (lambda: make_snapshot(_ported_pods()), ("hybrid", "hybrid-delta")),
    "existing_node": (lambda: _existing_node_snap(
        [make_pod(cpu="1500m", name=f"p{i}") for i in range(2)] + [preferred_affinity_pod(name="odd", cpu="1500m")]),
        ("hybrid", "hybrid-delta")),
    "one_in_window": (lambda: make_snapshot([make_pod(cpu="1"), preferred_affinity_pod()]), ("hybrid", "hybrid-delta")),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_hybrid_solve_matches_reference(name):
    """A cold solve and an identical resubmit of each snapshot."""
    build, modes = SINGLE[name]
    chain = Chain(build())
    chain.step("cold")
    chain.step("resubmit")
    assert tuple(chain.modes()) == modes
    if modes[0] == "hybrid":
        assert chain.steps[0]["backend"] == "hybrid" and not chain.steps[0]["results"][2]


def test_residual_lands_on_tensor_claims():
    """The residual pod lands on a claim the tensor majority opened; ported
    pods get a node each; the existing node's capacity is respected."""
    chain = Chain(_hybrid_snap(6))
    got = chain.step()
    assert len(got["results"][0]) == 1 and "default/odd" in got["results"][0][0][1]
    chain = Chain(make_snapshot(_ported_pods()))
    got = chain.step()
    assert len(got["results"][0]) == 2


def test_force_raises_on_out_of_window():
    pods = [make_pod(cpu="500m"), preferred_affinity_pod()]
    chain = Chain(make_snapshot(pods), force=True)
    port_snap = chain.mirror.snapshot(chain.ref)
    with pytest.raises(RuntimeError, match="unsupported"):
        chain.ref_solver.solve(chain.ref)
    with pytest.raises(RuntimeError, match="unsupported"):
        chain.gpu.solve(port_snap)


def test_solve_mode_on_every_exit_path():
    for pods, mode, backend in (([make_pod(cpu="1")], "full", "gpu"), ([], "fallback", "ffd-fallback"),
                                ([make_pod(cpu="1"), preferred_affinity_pod()], "hybrid", "hybrid")):
        got = Chain(make_snapshot(pods)).step()
        assert (got["mode"], got["backend"]) == (mode, backend)


# -- tests/test_hybrid_delta.py ----------------------------------------------------

def test_appended_pod_takes_hybrid_delta():
    chain = Chain(_hybrid_snap())
    chain.step()
    chain.step("resubmit")
    chain.ref.pods.append(make_pod(cpu="500m", name="newcomer"))
    got = chain.step("append")
    assert chain.modes() == ["hybrid", "hybrid-delta", "hybrid-delta"]
    assert "newcomer" in got["placed"] and len(got["placed"]) == 8


def test_appended_flagged_pod_grows_residual():
    chain = Chain(_hybrid_snap())
    chain.step()
    chain.ref.pods.append(preferred_affinity_pod(name="odd2"))
    got = chain.step("append flagged")
    assert chain.modes() == ["hybrid", "hybrid-delta"] and {"odd", "odd2"} <= got["placed"]


def test_removed_tensor_pod_recredits():
    chain = Chain(_hybrid_snap())
    chain.step()
    gone = chain.ref.pods.pop(0)
    got = chain.step("remove")
    assert chain.modes() == ["hybrid", "hybrid-delta"]
    assert gone.metadata.name not in got["placed"] and len(got["placed"]) == 6


def test_chained_hybrid_deltas_hold_no_chain():
    """Three appends in a row stay on hybrid-delta, and the hybrid state
    holds one full and one masked encoding, never their predecessors: the
    first masked encoding is freed."""
    chain = Chain(_hybrid_snap())
    chain.step()
    first = weakref.ref(chain.gpu._hybrid_state["masked_enc"])
    first_full = weakref.ref(chain.gpu._hybrid_state["full_enc"])
    for i in range(3):
        chain.ref.pods.append(make_pod(cpu="500m", name=f"n{i}"))
        chain.step(f"append {i}")
        assert chain.gpu._resident["problem"].delta is None
        assert getattr(chain.gpu._hybrid_state["masked_enc"], "delta_base", None) is None
    assert chain.modes() == ["hybrid"] + ["hybrid-delta"] * 3
    assert len(chain.steps[-1]["placed"]) == 10
    gc.collect()
    assert first() is None and first_full() is None


def test_resubmit_after_delta_does_not_replay_stale_delta():
    pods = [make_pod(cpu="500m", name=f"p{i}") for i in range(5)]
    chain = Chain(make_snapshot(list(pods)))
    chain.step()
    chain.ref.pods.append(make_pod(cpu="500m", name="p5"))
    chain.step("append")
    got = chain.step("resubmit")
    assert chain.modes() == ["full", "delta", "delta"] and len(got["placed"]) == 6


def test_resubmit_after_hybrid_delta_does_not_replay_stale_delta():
    chain = Chain(_hybrid_snap())
    chain.step()
    chain.ref.pods.append(make_pod(cpu="500m", name="pp"))
    chain.step("append")
    got = chain.step("resubmit")
    assert chain.modes() == ["hybrid", "hybrid-delta", "hybrid-delta"] and len(got["placed"]) == 8


def test_unseen_shape_takes_cold_hybrid():
    chain = Chain(_hybrid_snap())
    chain.step()
    chain.ref.pods.append(make_pod(cpu="333m", memory="333Mi", name="strange"))
    chain.step("unseen shape")
    assert chain.modes() == ["hybrid", "hybrid"]


def test_full_hybrid_full_plus_one_resolves_as_delta():
    """After full -> hybrid the EncodeCache still holds the full hybrid
    encoding: the next in-window snapshot (the flagged pod gone, one pod
    added) is a delta of it, served from the masked carry."""
    chain = Chain(make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(6)]))
    chain.step()
    odd = preferred_affinity_pod()
    chain.ref.pods.append(odd)
    chain.step("flagged pod")
    cached = chain.gpu.encode_cache.last_enc
    assert cached.n_pods == 7 and cached.fallback_reasons
    chain.ref.pods.remove(odd)
    chain.ref.pods.append(make_pod(cpu="500m", name="p-new"))
    got = chain.step("flagged pod gone, one added")
    assert chain.modes() == ["full", "hybrid", "delta"]
    assert got["backend"] == "gpu" and len(got["placed"]) == 7


def test_removing_flagged_pod_clears_reasons():
    chain = Chain(_hybrid_snap())
    chain.step()
    chain.ref.pods = [p for p in chain.ref.pods if p.metadata.name != "odd"]
    got = chain.step("flagged pod gone")
    assert chain.modes() == ["hybrid", "delta"] and got["backend"] == "gpu" and not got["reasons"]


def test_hybrid_chain_to_residual_gone():
    """The small counterpart of the headline's steps: hybrid, then
    hybrid-delta on a resubmit, an append and a removal, then the last
    flagged pod leaves (a pure delta from the masked carry), then one more
    in-window pod (a delta of the masked carry's successor)."""
    chain = Chain(_hybrid_snap(8))
    chain.step("cold")
    chain.step("resubmit")
    chain.ref.pods.append(make_pod(cpu="500m", name="added"))
    chain.step("append")
    chain.ref.pods.pop(1)
    chain.step("remove")
    chain.ref.pods = [p for p in chain.ref.pods if p.metadata.name != "odd"]
    chain.step("residual gone")
    chain.ref.pods.append(make_pod(cpu="500m", name="after"))
    chain.step("after")
    assert chain.modes() == ["hybrid", "hybrid-delta", "hybrid-delta", "hybrid-delta", "delta", "delta"]


def test_nodepool_edit_takes_cold_hybrid():
    chain = Chain(_hybrid_snap())
    chain.step()
    chain.step("resubmit")
    # a hash-visible nodepool edit, made to both sides' nodepool
    chain.ref.node_pools[0].spec.template.labels["edited"] = "1"
    chain.mirror.carry(chain.ref.node_pools[0]).spec.template.labels["edited"] = "1"
    chain.ref.pods.append(make_pod(cpu="500m", name="after-edit"))
    chain.step("after edit")
    assert chain.modes() == ["hybrid", "hybrid-delta", "hybrid"]


def test_new_group_takes_cold_hybrid():
    chain = Chain(_hybrid_snap())
    chain.step()
    sel = {"matchLabels": {"app": "w"}}
    chain.ref.pods.append(make_pod(cpu="500m", name="grouped", labels={"app": "w"}, tsc=[zone_spread(selector=sel)]))
    chain.step("new group")
    assert chain.modes() == ["hybrid", "hybrid"]


def test_fallback_clears_hybrid_state():
    """A whole-snapshot fallback drops the hybrid carry on both sides, and
    the next hybrid snapshot starts cold."""
    chain = Chain(_hybrid_snap())
    chain.step()
    # asymmetric anti-affinity: a snapshot-global reason
    chain.ref.pods += _asymmetric_anti_pods()
    chain.step("global reason")
    assert chain.gpu._hybrid_state is None
    chain.ref.pods = chain.ref.pods[:7]
    chain.step("back")
    assert chain.modes() == ["hybrid", "fallback", "hybrid"]
