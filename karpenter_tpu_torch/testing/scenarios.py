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
from dataclasses import dataclass

from ..apis import labels as wk
from ..apis.nodepool import NodePool
from ..scheduling.requirements import Operator
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



# what the kwok provider and the node-class hydration stamp on every node
_KWOK_NODE_LABEL = "kwok.x-k8s.io/node"
_KWOK_NODE_CLASS_LABEL = "karpenter.kwok.sh/kwoknodeclass"
_KWOK_PROVIDER_PREFIX = "kwok://"


@dataclass
class ConsolidationFleet:
    """A built consolidation fleet: its store, cluster (fed by informers),
    clock and cloud provider (the kwok catalog)."""

    store: object
    cluster: object
    clock: object
    cloud_provider: object


def _launched_labels(claim_reqs: list, pool_labels: dict, it, offering, node_name: str) -> dict:
    """The labels a kwok launch gives a node: the claim's labels, its
    single-valued `In` requirements, the instance type and the
    single-valued requirements of the type and the chosen offering."""
    labels = dict(pool_labels)
    for r in claim_reqs:
        if r["operator"] == "In" and len(r["values"]) == 1:
            labels[r["key"]] = r["values"][0]
    labels[wk.INSTANCE_TYPE_LABEL_KEY] = it.name
    for source in (it.requirements, offering.requirements):
        for key, r in source.items():
            if r.operator() == Operator.IN and len(r.values) == 1:
                labels[key] = r.any()
    labels[wk.HOSTNAME_LABEL_KEY] = node_name
    labels[_KWOK_NODE_LABEL] = "fake"
    return labels


FLEET_POD_UID_SEED = 0


def fleet_pod_uids(seed: int = FLEET_POD_UID_SEED):
    """The fleet pods' uids, in creation order: version-4 UUIDs drawn from
    `random.Random(seed)`. The host scheduler breaks ties between equal pods
    by uid, so a fleet whose uids came from `uuid.uuid4()` would place its
    identical pods in an order no other build reproduces."""
    import uuid

    rng = random.Random(seed)
    while True:
        yield str(uuid.UUID(int=rng.getrandbits(128), version=4))


def build_consolidation_fleet(n_nodes: int, hetero_prices: bool = False) -> ConsolidationFleet:
    """The reference benchmark's underutilized consolidation fleet
    (`bench._build_consolidation_fleet`), made without an operator: one
    NodePool (consolidateAfter 30s, a 100% budget), and per node one
    NodeClaim and one Node as the kwok provider, the lifecycle (launch,
    registration, initialization), consistency and hydration controllers
    leave them, two sizes x three zones, each node holding one pre-bound
    500m pod; then the clock steps past consolidateAfter and the NodeClaim
    disruption controller marks every claim Consolidatable (on a fresh
    `FakeClock`).

    Object for object, in the same order and at the same clock times, this
    is what the reference's Environment-built fleet holds (node names draw
    kwok's suffixes from `random.Random(0)` in launch order, pods bind to
    the nodes in name order); the pods' uids come from `fleet_pod_uids()`,
    where the benchmark draws them from `uuid.uuid4()`. `hetero_prices=True`
    lets the pool take spot and alternates spot/on-demand per claim."""
    from ..apis.conditions import ConditionSet
    from ..apis.nodeclaim import (
        COND_CONSISTENT_STATE_FOUND,
        COND_INITIALIZED,
        COND_LAUNCHED,
        COND_REGISTERED,
        NodeClaim,
        NodeClaimSpec,
        NodeClaimStatus,
        NodeClassReference,
    )
    from ..apis.nodepool import COND_NODE_REGISTRATION_HEALTHY, COND_NODEPOOL_READY, COND_NODEPOOL_VALIDATION_SUCCEEDED, Budget
    from ..cloudprovider import catalog
    from ..cloudprovider.fake import FakeCloudProvider
    from ..controllers.nodeclaim.disruption import NodeClaimDisruptionController
    from ..controllers.nodepool.hash import NODEPOOL_HASH_VERSION
    from ..kube import Store
    from ..kube.objects import Node, NodeSpec, NodeStatus, OwnerReference
    from ..scheduling.requirements import Requirements
    from ..state import Cluster
    from ..state.informer import start_informers
    from ..utils.clock import FakeClock
    from ..utils.quantity import Quantity

    clock = FakeClock()
    t0 = clock.now()
    store = Store(clock=clock)
    cluster = Cluster(store, clock)
    start_informers(store, cluster)
    types = catalog.construct_instance_types()
    by_name = {it.name: it for it in types}
    cloud = FakeCloudProvider(types)

    pool_reqs = [
        {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
        {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
    ]
    if not hetero_prices:
        pool_reqs.append({"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_ON_DEMAND]})
    np_ = make_nodepool(requirements=pool_reqs)
    np_.spec.disruption.consolidate_after = "30s"
    np_.spec.disruption.budgets = [Budget(nodes="100%")]
    pool_hash = np_.hash()
    np_.metadata.annotations = {wk.NODEPOOL_HASH_ANNOTATION_KEY: pool_hash,
                                wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY: NODEPOOL_HASH_VERSION}
    for ctype in (COND_NODEPOOL_VALIDATION_SUCCEEDED, COND_NODE_REGISTRATION_HEALTHY, "NodeClassReady", COND_NODEPOOL_READY):
        np_.status.conditions.set_true(ctype, now=t0 + 2)
    zones = ["test-zone-a", "test-zone-b", "test-zone-c"]
    sizes = ["s-2x-amd64-linux", "s-4x-amd64-linux"]
    cap_types = ([wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND] if hetero_prices
                 else [wk.CAPACITY_TYPE_ON_DEMAND, wk.CAPACITY_TYPE_ON_DEMAND])
    annotations = {wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY: NODEPOOL_HASH_VERSION,
                   wk.NODEPOOL_HASH_ANNOTATION_KEY: pool_hash}
    rng = random.Random(0)  # the kwok provider's node-name suffixes
    claims, nodes = [], []
    totals: dict = {}
    for i in range(n_nodes):
        name = f"default-pool-synth-{i}"
        reqs = [
            {"key": wk.INSTANCE_TYPE_LABEL_KEY, "operator": "In", "values": [sizes[i % 2]]},
            {"key": wk.ZONE_LABEL_KEY, "operator": "In", "values": [zones[i % 3]]},
            {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [cap_types[i % 2]]},
            {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
            {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
        ]
        # kwok's launch: the cheapest available offering the claim allows
        it = by_name[sizes[i % 2]]
        claim_reqs = Requirements.from_node_selector_terms(reqs)
        offering = min((o for o in it.offerings if o.available and claim_reqs.intersects(o.requirements) is None),
                       key=lambda o: o.price)
        node_name = f"kwok-{name}-{rng.randrange(1 << 32):08x}"
        labels = _launched_labels(reqs, {wk.NODEPOOL_LABEL_KEY: "default-pool"}, it, offering, node_name)
        capacity = {**it.capacity, **(offering.capacity_override or {})}
        allocatable = it.compute_allocatable(offering.capacity_override, offering.overhead_override)
        conditions = ConditionSet()
        for ctype in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED, COND_CONSISTENT_STATE_FOUND):
            conditions.set_true(ctype, now=t0 + 2)
        claims.append(NodeClaim(
            metadata=ObjectMeta(name=name, labels={**labels, _KWOK_NODE_CLASS_LABEL: "default"},
                                annotations=dict(annotations), finalizers=[wk.TERMINATION_FINALIZER]),
            spec=NodeClaimSpec(requirements=reqs, node_class_ref=NodeClassReference()),
            status=NodeClaimStatus(provider_id=_KWOK_PROVIDER_PREFIX + node_name, node_name=node_name,
                                   capacity=dict(capacity), allocatable=dict(allocatable), conditions=conditions,
                                   last_pod_event_time=t0 + 6),
        ))
        nodes.append(Node(
            metadata=ObjectMeta(name=node_name,
                                labels={**labels, wk.NODE_REGISTERED_LABEL_KEY: "true",
                                        wk.NODE_INITIALIZED_LABEL_KEY: "true"},
                                annotations={**annotations, _KWOK_NODE_LABEL: "fake"},
                                finalizers=[wk.TERMINATION_FINALIZER]),
            spec=NodeSpec(provider_id=_KWOK_PROVIDER_PREFIX + node_name),
            status=NodeStatus(capacity=dict(capacity), allocatable=dict(allocatable)),
        ))
        for k in ("cpu", "memory", "pods", "ephemeral-storage"):
            totals[k] = totals.get(k, 0) + capacity[k].milli
    np_.status.resources = {k: Quantity(m) for k, m in totals.items()} | {"nodes": Quantity(n_nodes * 1000)}
    np_.status.node_count = n_nodes
    store.create(np_)
    for claim in claims:
        store.create(claim)
    clock.step(2)
    for claim, node in zip(claims, nodes):
        node.metadata.owner_references = [OwnerReference(kind="NodeClaim", name=claim.metadata.name,
                                                         uid=claim.metadata.uid, api_version="karpenter.sh/v1",
                                                         block_owner_deletion=True)]
        store.create(node)
    clock.step(4)
    uids = fleet_pod_uids()
    for i, node in enumerate(sorted(nodes, key=lambda nd: nd.metadata.name)):
        pod = make_pod(cpu="500m", name=f"f{i}", node_name=node.metadata.name)
        pod.metadata.uid = next(uids)
        store.create(pod)
    clock.step(44)
    NodeClaimDisruptionController(store, cluster, cloud, clock).reconcile()
    return ConsolidationFleet(store=store, cluster=cluster, clock=clock, cloud_provider=cloud)
