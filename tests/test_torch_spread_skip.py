"""The batched in-flight loop's spread pass-over
(`Scheduler._spread_domains`, `scheduler._spread_rules_out`) against the
probes it saves, on random topology states, on the CPU.

Each seed draws pods with a zone spread (maxSkew 1 or 2, with minDomains
2 or 4 or without, selecting their own label or another, some held to two
zones by required node affinity), pods with a hostname spread and plain
pods; builds them with the reference's helpers and carries them over;
prepares one port `Scheduler`, sets a random count on every domain of every
zone spread group, and opens in-flight claims whose zone requirement is
`In` one zone, `In` two, `NotIn` one, or absent. Then:

- every claim the pass-over rules out for a pod gets the zone spread's
  error string from `Topology.add_requirements` for that pod, and an error
  from `can_add_dynamic`; every claim it keeps gets the verdict of the
  unbatched `can_add`;
- the in-flight loop, pod after pod on the same state, lands every pod on
  the same claim, leaves the same topology counts and counts the same fit
  memo with the pass-over as with it off, and lands them as the unbatched
  loop (`KARPENTER_FFD_BATCH=0`) does.
"""

from __future__ import annotations

import random

import pytest

from helpers import make_pod
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.controllers.provisioning.scheduling.nodeclaim import SchedulingNodeClaim
from karpenter_tpu_torch.controllers.provisioning.scheduling.scheduler import _spread_rules_out
from karpenter_tpu_torch.controllers.provisioning.scheduling.topology import TYPE_SPREAD
from karpenter_tpu_torch.scheduling.requirements import Requirement
from karpenter_tpu_torch.solver.ffd import build_scheduler
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
from test_domain_topology import make_snapshot, spread

ZONE, HOST = wk.ZONE_LABEL_KEY, wk.HOSTNAME_LABEL_KEY
ZONES = catalog.ZONES[:3]
SEEDS = range(8)
ZONE_ERROR = f"unsatisfiable topology constraint for {TYPE_SPREAD}, key={ZONE}"


def _pods(rng) -> list:
    pods = []
    for _ in range(18):
        kind = rng.choice(("zone", "zone", "zone", "host", "plain"))
        own = rng.choice("xy")
        kw = dict(cpu=rng.choice(("100m", "250m", "500m")), labels={"grp": own})
        if kind == "zone":
            sel = own if rng.random() < 0.6 else rng.choice("xy")
            kw["tsc"] = [spread(ZONE, rng.choice((1, 2)), {"matchLabels": {"grp": sel}},
                                min_domains=rng.choice((None, 2, 4)))]
            if rng.random() < 0.3:
                kw["required_affinity"] = [[{"key": ZONE, "operator": "In", "values": rng.sample(ZONES, 2)}]]
        elif kind == "host":
            kw["tsc"] = [spread(HOST, 1, {"matchLabels": {"grp": own}})]
        pods.append(make_pod(**kw))
    return pods


def _state(seed: int):
    """(pods, scheduler) with random zone counts and in-flight claims; the
    same seed draws the same state."""
    rng = random.Random(seed)
    types = [catalog.make_instance_type(f, cpu, zones=ZONES) for f in ("c", "m") for cpu in (2, 4, 8)]
    snap = snapshot_from_reference(make_snapshot(_pods(rng), types=types))
    sched = build_scheduler(snap)
    sched._prepare(snap.pods)
    for tg in sched.topology.topology_groups.values():
        if tg.type == TYPE_SPREAD and tg.key == ZONE:
            for d in sorted(tg.domains):
                tg.domains[d] = rng.randrange(4)
    t = sched.templates[0]
    for _ in range(10):
        nc = SchedulingNodeClaim(t, sched.topology, sched.daemon_overhead_groups[id(t)], t.instance_type_options,
                                 allocator=sched.allocator, reservation_manager=sched.reservation_manager,
                                 reserved_offering_mode=sched.reserved_offering_mode, filter_cache=sched.filter_cache)
        shape = rng.randrange(4)
        if shape == 0:
            nc.requirements.add(Requirement(ZONE, "In", rng.sample(ZONES, 1)))
        elif shape == 1:
            nc.requirements.add(Requirement(ZONE, "In", rng.sample(ZONES, 2)))
        elif shape == 2:
            nc.requirements.add(Requirement(ZONE, "NotIn", rng.sample(ZONES, 1)))
        sched.new_node_claims.append(nc)
    return snap.pods, sched


@pytest.mark.parametrize("seed", SEEDS)
def test_passed_over_claims_fail_the_topology(seed):
    pods, sched = _state(seed)
    ruled = kept = 0
    for pod in pods:
        pod_data = sched.cached_pod_data[pod.metadata.uid]
        spread_domains = sched._spread_domains(pod, pod_data)
        for nc in sched.new_node_claims:
            if nc.static_error(pod, pod_data) is not None:
                continue
            base = nc.static_base(pod_data)
            err = nc.can_add_dynamic(pod, pod_data, base, relax_min_values=False)[2]
            if spread_domains and _spread_rules_out(spread_domains, nc.requirements):
                ruled += 1
                topo = sched.topology.add_requirements(pod, nc.template.taints, pod_data.strict_requirements, base,
                                                       allow_undefined=wk.WELL_KNOWN_LABELS)
                assert topo == ZONE_ERROR and err is not None
            else:
                kept += 1
                assert (err is None) == (nc.can_add(pod, pod_data, relax_min_values=False)[2] is None)
    assert ruled and kept


def _drive(seed: int, arm: str, monkeypatch) -> tuple:
    """Each pod through the in-flight loop: (verdict, claim it landed on)
    per pod, the zone counts after, the fit memo's counts and the
    pass-over's."""
    monkeypatch.setenv("KARPENTER_FFD_BATCH", "0" if arm == "unbatched" else "1")
    pods, sched = _state(seed)
    if arm == "off":
        sched._spread_domains = lambda pod, pod_data: ()
    claims = list(sched.new_node_claims)
    landed = []
    for pod in pods:
        if not sched.batch_enabled:
            # as Scheduler._add does before the unbatched loop
            sched.new_node_claims.sort(key=lambda m: len(m.pods))
        err = sched._add_to_inflight_node(pod)
        uid = pod.metadata.uid
        landed.append((err, [j for j, nc in enumerate(claims) if any(p.metadata.uid == uid for p in nc.pods)]))
    counts = sorted((tg.key, tg.max_skew, sorted(tg.domains.items()))
                    for tg in sched.topology.topology_groups.values() if tg.type == TYPE_SPREAD and tg.key == ZONE)
    return landed, counts, dict(sched.memo_stats), dict(sched.spread_skip)


@pytest.mark.parametrize("seed", SEEDS)
def test_in_flight_loop_lands_pods_as_without_the_pass_over(seed, monkeypatch):
    landed, counts, memo, skip = _drive(seed, "pass_over", monkeypatch)
    off = _drive(seed, "off", monkeypatch)
    unbatched = _drive(seed, "unbatched", monkeypatch)
    assert (landed, counts, memo) == off[:3]
    assert (landed, counts) == unbatched[:2]
    assert any(err is None for err, _ in landed) and any(err is not None for err, _ in landed)
    assert skip["skipped"] > 0 and off[3]["skipped"] == 0 and skip["reached"] == off[3]["reached"]
    assert unbatched[3] == {"skipped": 0, "reached": 0}
