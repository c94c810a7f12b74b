"""Snapshot builders of the port: the scheduling benchmark's snapshot and the
pod and nodepool builders it uses, over the port's own object model.

`build_snapshot(n_pods, n_types, ...)` is the reference benchmark's builder
(the headline is `build_snapshot(5000, 100)`: a heterogeneous population of
plain pods, zone-spread, zone-selector and hostname anti-affinity replicas
over `instance_types_assorted(n_types)`), with its optional required and
preferred pod-affinity, PVC and coupled-spread fractions. `make_pod`,
`make_nodepool`, `zone_spread` and `hostname_anti_affinity` are the test
suite's object builders.

Pod names come from a module counter (`_seq`) and pod uids from
`uuid.uuid4()`; both feed the FFD queue's tie-break and the encoder's pod
order, so a caller that needs a reproducible snapshot starts a fresh
counter and draws the uids from a seeded generator around the build.
"""

from __future__ import annotations

import itertools
import random

from ..apis import labels as wk
from ..apis.nodepool import NodePool
from ..kube import (
    Affinity,
    Container,
    NodeAffinity,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodSpec,
    PreferredSchedulingTerm,
    TopologySpreadConstraint,
)
from ..utils.resources import parse_resource_list

_seq = itertools.count(1)


def make_pod(
    name=None,
    ns="default",
    cpu="1",
    memory=None,
    labels=None,
    node_selector=None,
    node_name="",
    required_affinity=None,  # list of term lists
    preferred_affinity=None,  # list of (weight, term list)
    tolerations=None,
    tsc=None,  # list of TopologySpreadConstraint
    anti_affinity=None,  # list of PodAffinityTerm
    pod_affinity=None,
    priority=None,
    annotations=None,
    owner_refs=None,
    volumes=None,  # list of volume dicts (persistentVolumeClaim / ephemeral / ...)
):
    name = name or f"pod-{next(_seq)}"
    requests = {"cpu": cpu}
    if memory:
        requests["memory"] = memory
    affinity = None
    if required_affinity or preferred_affinity or anti_affinity or pod_affinity:
        affinity = Affinity(
            node_affinity=NodeAffinity(
                required=required_affinity or [],
                preferred=[PreferredSchedulingTerm(weight=w, preference=t) for w, t in (preferred_affinity or [])],
            )
            if (required_affinity or preferred_affinity)
            else None,
            pod_anti_affinity_required=anti_affinity or [],
            pod_affinity_required=pod_affinity or [],
        )
    pod = Pod(
        metadata=ObjectMeta(name=name, namespace=ns, labels=labels or {}, annotations=annotations or {}),
        spec=PodSpec(
            containers=[Container(resources={"requests": parse_resource_list(requests)})],
            node_selector=node_selector or {},
            node_name=node_name,
            affinity=affinity,
            tolerations=tolerations or [],
            topology_spread_constraints=tsc or [],
            priority=priority,
            volumes=volumes or [],
        ),
    )
    if owner_refs:
        pod.metadata.owner_references = owner_refs
    return pod


def make_nodepool(name="default-pool", requirements=None, taints=None, limits=None, weight=0, labels=None, replicas=None):
    np = NodePool(metadata=ObjectMeta(name=name))
    np.spec.weight = weight
    np.spec.replicas = replicas
    np.spec.template.requirements = requirements or [
        {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_ON_DEMAND, wk.CAPACITY_TYPE_SPOT]},
    ]
    np.spec.template.taints = taints or []
    np.spec.template.labels = labels or {}
    if limits:
        np.spec.limits = parse_resource_list(limits)
    return np


def zone_spread(max_skew=1, selector=None, when="DoNotSchedule"):
    return TopologySpreadConstraint(
        max_skew=max_skew,
        topology_key=wk.ZONE_LABEL_KEY,
        when_unsatisfiable=when,
        label_selector=selector,
    )


def hostname_anti_affinity(selector):
    return PodAffinityTerm(label_selector=selector, topology_key=wk.HOSTNAME_LABEL_KEY)


def build_snapshot(
    n_pods: int,
    n_types: int,
    n_variants: int = 400,
    affinity_frac: float = 0.0,
    fallback_frac: float = 0.0,
    pvc_frac: float = 0.0,
    coupled_frac: float = 0.0,
    min_values: int | None = None,
):
    from ..cloudprovider.fake import instance_types_assorted
    from ..kube import Store
    from ..kube.objects import ObjectMeta as ObjectMeta_
    from ..solver.snapshot import SolverSnapshot
    from ..state import Cluster
    from ..state.informer import start_informers
    from ..utils.clock import FakeClock

    LINUX = [
        {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
        {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
    ]
    rng = random.Random(0)
    store, clock = Store(), FakeClock()
    cluster = Cluster(store, clock)
    start_informers(store, cluster)
    reqs = list(LINUX)
    if min_values is not None:
        # NodePool-level instance-type flexibility floor: rides the tensor
        # path end-to-end via the decode-time relaxation (PR 3)
        reqs.append({"key": wk.INSTANCE_TYPE_LABEL_KEY, "operator": "Exists", "minValues": min_values})
    np_ = make_nodepool(requirements=reqs)
    store.create(np_)
    # heterogeneous variant pool a la the reference's 400-variant benchmark
    combos = [
        (f"{rng.randrange(100, 4100, 100)}m", f"{rng.randrange(128, 4096, 64)}Mi")
        for _ in range(n_variants)
    ]
    spread_sel = {"matchLabels": {"app": "web"}}
    anti_sels = [{"matchLabels": {"app": f"db-{i}"}} for i in range(10)]
    # required-pod-affinity deployments (tensorized r4): ~40 co-location
    # groups over zone, each with its own selector
    from ..kube.objects import Affinity, PodAffinityTerm, WeightedPodAffinityTerm

    aff_groups = [
        (
            {"aff": f"grp-{i}"},
            PodAffinityTerm(label_selector={"matchLabels": {"aff": f"grp-{i}"}}, topology_key=wk.ZONE_LABEL_KEY),
        )
        for i in range(40)
    ]
    if pvc_frac:
        # common-case dynamic provisioning: WaitForFirstConsumer StorageClasses,
        # one unconstrained + one with a single zonal topology term, plus
        # per-driver CSI attach limits (volumetopology.go + scheduler.go:623)
        from ..kube.objects import PersistentVolumeClaim, StorageClass

        store.create(StorageClass(
            metadata=ObjectMeta_(name="fast-sc"), provisioner="csi.test.fast",
            volume_binding_mode="WaitForFirstConsumer",
        ))
        store.create(StorageClass(
            metadata=ObjectMeta_(name="zonal-sc"), provisioner="csi.test.zonal",
            volume_binding_mode="WaitForFirstConsumer",
            allowed_topologies=[[{"key": wk.ZONE_LABEL_KEY, "values": ["test-zone-a", "test-zone-b"]}]],
        ))
    pvc_seq = 0
    pods = []
    for _ in range(n_pods):
        k = rng.random()
        if pvc_seq < n_pods * pvc_frac and rng.random() < pvc_frac * 1.5:
            sc = "zonal-sc" if pvc_seq % 2 else "fast-sc"
            claim = f"data-{pvc_seq}"
            store.create(PersistentVolumeClaim(metadata=ObjectMeta_(name=claim), storage_class_name=sc))
            cpu, mem = rng.choice(combos)
            pods.append(make_pod(cpu=cpu, memory=mem, volumes=[{"name": "data", "persistentVolumeClaim": {"claimName": claim}}]))
            pvc_seq += 1
            continue
        if k < affinity_frac:  # required zone pod-affinity deployments
            labels, term = rng.choice(aff_groups)
            cpu = rng.choice(["250m", "500m", "1"])
            p = make_pod(cpu=cpu, memory="512Mi", labels=dict(labels), pod_affinity=[term])
            pods.append(p)
            continue
        if k < affinity_frac + fallback_frac:  # PREFERRED affinity: out-of-window
            labels, term = rng.choice(aff_groups)
            p = make_pod(cpu="500m", memory="512Mi", labels=dict(labels))
            p.spec.affinity = Affinity(pod_affinity_preferred=[WeightedPodAffinityTerm(weight=1, term=term)])
            pods.append(p)
            continue
        if k < affinity_frac + fallback_frac + coupled_frac:
            # COUPLED spread: a flagged (preferred-affinity) pod that DECLARES
            # the same zone-spread group as the in-window "app: web" majority —
            # the group spans the hybrid seam, exercising the exported
            # tensor-side occupancy (tpu._seam_records)
            _labels, term = rng.choice(aff_groups)
            p = make_pod(cpu="500m", memory="1Gi", labels={"app": "web"}, tsc=[zone_spread(selector=spread_sel)])
            p.spec.affinity = Affinity(pod_affinity_preferred=[WeightedPodAffinityTerm(weight=1, term=term)])
            pods.append(p)
            continue
        if k < 0.60:  # heterogeneous plain pods
            cpu, mem = rng.choice(combos)
            pods.append(make_pod(cpu=cpu, memory=mem))
        elif k < 0.80:  # zonal topology spread (4 sizes so spread != 1 item)
            cpu = rng.choice(["250m", "500m", "1", "2"])
            pods.append(make_pod(cpu=cpu, memory="1Gi", labels={"app": "web"}, tsc=[zone_spread(selector=spread_sel)]))
        elif k < 0.90:  # zone node selectors
            pods.append(make_pod(cpu="1", node_selector={wk.ZONE_LABEL_KEY: rng.choice(["test-zone-a", "test-zone-b"])}))
        elif k < 0.98:  # more heterogeneous, memory-heavy
            cpu, mem = rng.choice(combos)
            pods.append(make_pod(cpu=cpu, memory=mem, labels={"tier": "batch"}))
        else:  # hostname anti-affinity groups (the north-star config)
            i = rng.randrange(len(anti_sels))
            pods.append(
                make_pod(cpu="500m", memory="512Mi", labels={"app": f"db-{i}"}, anti_affinity=[hostname_anti_affinity(anti_sels[i])])
            )
    return SolverSnapshot(
        store=store,
        cluster=cluster,
        node_pools=[np_],
        instance_types={np_.metadata.name: instance_types_assorted(n_types)},
        state_nodes=[],
        daemonset_pods=[],
        pods=pods,
        clock=clock,
    )

