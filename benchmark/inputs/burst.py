"""The scheduling burst's pods: upstream's `makeDiversePods`
(`scheduling_benchmark_test.go`) as plain specs, and the program's snapshot
built from those specs.

`makeDiversePods(n)` makes n/5 pods of each kind, in this order, and the
remainder generic: generic pods; topology spread over zones; topology
spread over hostnames; required pod affinity over zones; required pod
anti-affinity over hostnames. Each requests a CPU and a memory drawn from
the configuration's lists. A generic or spread pod carries the label
`my-label` with a value drawn from `label_values`; a spread pod's
selector (maxSkew 1, DoNotSchedule) draws its own value, apart from its
label. An affinity pod carries `my-affinity` with a drawn value and
requires a pod of that value in its zone (itself included). Every
anti-affinity pod carries `app: nginx` and repels every other on its node.

The draws come from one generator with the configuration's fixed seed, as
upstream fixes its own, so every run does the same work; the run's seed
shuffles the pods' order and draws their uids, which break the queue's
ties."""

from __future__ import annotations

import random
import uuid

MI = 1 << 20
LABEL, AFFINITY, APP = "my-label", "my-affinity", "app"


def pod_specs(config: dict, seed: int) -> list[dict]:
    """Plain pod specs: key, name, uid, kind, cpu_m, mem_b, and `label`
    (my-label's value), `selects` (a spread pod's selector value), `group`
    (an affinity pod's my-affinity value) where the kind has them."""
    mix, n = config["mix"], config["pods"]
    rng = random.Random(mix["generator_seed"])
    values = mix["label_values"]
    share = n // len(mix["kinds"])
    kinds = [k for k in mix["kinds"] for _ in range(share)] + [mix["kinds"][0]] * (n - share * len(mix["kinds"]))
    specs = []
    for kind in kinds:
        s = dict(kind=kind)
        if kind in ("generic", "zone_spread", "hostname_spread"):
            s["label"] = rng.choice(values)
        if kind in ("zone_spread", "hostname_spread"):
            s["selects"] = rng.choice(values)
        if kind == "zone_affinity":
            s["group"] = rng.choice(values)
        s["cpu_m"] = rng.choice(mix["cpu_m"])
        s["mem_b"] = rng.choice(mix["memory_mi"]) * MI
        specs.append(s)
    shuffle = random.Random(seed)
    shuffle.shuffle(specs)
    for i, s in enumerate(specs):
        s["name"] = f"pod-{i:05d}"
        s["key"] = f"default/{s['name']}"
        s["uid"] = str(uuid.UUID(int=shuffle.getrandbits(128), version=4))
    return specs


def to_pod(s: dict):
    """The program's Pod for a spec, as upstream's `test.Pod` builds it."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.kube import (Affinity, Container, ObjectMeta, Pod, PodAffinityTerm, PodSpec,
                                          TopologySpreadConstraint)
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    requests = parse_resource_list({"cpu": f"{s['cpu_m']}m", "memory": f"{s['mem_b'] // MI}Mi"})
    labels, tsc, affinity = {}, [], None
    kind = s["kind"]
    if "label" in s:
        labels = {LABEL: s["label"]}
    if kind in ("zone_spread", "hostname_spread"):
        key = wk.ZONE_LABEL_KEY if kind == "zone_spread" else wk.HOSTNAME_LABEL_KEY
        tsc = [TopologySpreadConstraint(max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
                                        label_selector={"matchLabels": {LABEL: s["selects"]}})]
    elif kind == "zone_affinity":
        labels = {AFFINITY: s["group"]}
        term = PodAffinityTerm(label_selector={"matchLabels": dict(labels)}, topology_key=wk.ZONE_LABEL_KEY)
        affinity = Affinity(pod_affinity_required=[term])
    elif kind == "hostname_anti_affinity":
        labels = {APP: "nginx"}
        term = PodAffinityTerm(label_selector={"matchLabels": dict(labels)}, topology_key=wk.HOSTNAME_LABEL_KEY)
        affinity = Affinity(pod_anti_affinity_required=[term])
    return Pod(
        metadata=ObjectMeta(name=s["name"], namespace="default", uid=s["uid"], labels=labels),
        spec=PodSpec(containers=[Container(resources={"requests": requests})], affinity=affinity,
                     topology_spread_constraints=tsc),
    )


def snapshot(specs: list[dict], instance_types: list):
    """A SolverSnapshot of the pending pods: one NodePool with no
    requirements (upstream's `test.NodePool`), no existing nodes, no
    daemonsets."""
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.kube import ObjectMeta, Store
    from karpenter_tpu_torch.solver.snapshot import SolverSnapshot
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.state.informer import start_informers
    from karpenter_tpu_torch.utils.clock import FakeClock

    store, clock = Store(), FakeClock()
    cluster = Cluster(store, clock)
    start_informers(store, cluster)
    pool = NodePool(metadata=ObjectMeta(name="default-pool"))
    store.create(pool)
    return SolverSnapshot(store=store, cluster=cluster, node_pools=[pool],
                          instance_types={pool.metadata.name: instance_types}, state_nodes=[], daemonset_pods=[],
                          pods=[to_pod(s) for s in specs], clock=clock)


def placement(results) -> tuple[list[dict], list]:
    """A solve's `Results` as plain data for the reference."""
    from karpenter_tpu_torch.apis import labels as wk

    claims = []
    for nc in results.new_node_claims:
        z = nc.requirements.get(wk.ZONE_LABEL_KEY) if wk.ZONE_LABEL_KEY in nc.requirements else None
        zones = None if z is None or z.operator().value != "In" else sorted(z.values)
        claims.append({"pods": [p.key() for p in nc.pods], "types": [it.name for it in nc.instance_type_options],
                       "zones": zones})
    return claims, sorted(results.pod_errors)
