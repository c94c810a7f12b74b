"""ExistingNode: scheduling against an already-running (or launching) node.

Reference: scheduling/existingnode.go — remaining resources start at
allocatable minus current pods minus expected daemon overhead; CanAdd checks
taints, host ports, resources, requirements, then topology.
"""

from __future__ import annotations

from ....apis import labels as wk
from ....scheduling.requirements import Requirement, Requirements
from ....scheduling.taints import taints_tolerate_pod
from ....scheduling.hostports import pod_host_ports
from ....utils import resources as res
from ....utils.quantity import Quantity


class ExistingNode:
    def __init__(self, state_node, topology, taints, daemon_resources: dict[str, Quantity], is_under_consolidate_after: bool = False, allocator=None, daemon_pods: list | None = None):
        self.state_node = state_node
        self.topology = topology
        self.taints = taints
        self.pods: list = []
        self.is_under_consolidate_after = is_under_consolidate_after
        self.allocator = allocator  # DRA; None when the gate is off
        self._pending_dra = None
        # monotone state version: bumped on every add(); the scheduler's fit
        # memo stamps static-pass entries with it so a stale pass is recomputed
        self._version = 0

        # remaining = allocatable - committed pods - headroom for daemons that
        # haven't scheduled yet (existingnode.go:45-60)
        remaining = res.subtract(state_node.allocatable(), state_node.total_pod_requests())
        daemon_headroom = res.subtract(daemon_resources, state_node.total_daemon_requests())
        daemon_headroom = {k: v for k, v in daemon_headroom.items() if v.milli > 0}
        self.remaining_resources = res.subtract(remaining, daemon_headroom)

        self.host_port_usage = state_node.host_port_usage.copy()
        # phantom daemon port headroom: this substrate has no DaemonSet
        # controller materializing daemon pods, so compatible daemons that
        # haven't landed yet reserve their ports here the same way their
        # resources reserve headroom above; a port already held by a real
        # daemon pod stays held (the conflicting add is skipped)
        for d in daemon_pods or []:
            ports = pod_host_ports(d)
            if ports and self.host_port_usage.conflicts(d.key(), ports) is None:
                self.host_port_usage.add(f"daemon-headroom/{d.key()}", ports)
        self.volume_usage = state_node.volume_usage.copy()
        self.requirements = Requirements.from_labels_view(state_node.labels()).copy_shallow()
        self.requirements.add(Requirement(wk.HOSTNAME_LABEL_KEY, "In", [state_node.hostname()]))
        topology.register(wk.HOSTNAME_LABEL_KEY, state_node.hostname())

    def name(self) -> str:
        return self.state_node.name()

    def can_add(self, pod, pod_data):
        """Returns (updated_requirements, None) or error string
        (existingnode.go:81-139)."""
        base, err = self.can_add_static(pod, pod_data)
        if err is not None:
            return None, err
        return self.can_add_dynamic(pod, pod_data, base)

    def can_add_static(self, pod, pod_data):
        """The MONOTONE prefix of can_add: taints, volume limits, host ports,
        resource fit, and requirements compatibility. Within one solve this
        node's taints and labels are fixed and its usage only grows (resources
        shrink, requirements tighten, port/volume usage accumulates), so a
        rejection here can never turn into an acceptance later — the
        scheduler's fit memo caches it permanently per pod signature. Returns
        (base_requirements, None) or (None, err)."""
        err = taints_tolerate_pod(self.taints, pod, include_prefer_no_schedule=True)
        if err is not None:
            return None, err
        verr = self.volume_usage.exceeds_limits(pod_data.volumes)
        if verr is not None:
            return None, f"checking volume usage, {verr}"
        ports = pod_host_ports(pod)
        cerr = self.host_port_usage.conflicts(pod.key(), ports)
        if cerr is not None:
            return None, cerr
        if not res.fits(pod_data.requests, self.remaining_resources):
            return None, "exceeds node resources"
        cerr = self.requirements.compatible(pod_data.requirements)
        if cerr is not None:
            return None, cerr
        base = Requirements()
        base.add(*self.requirements.values())
        base.add(*pod_data.requirements.values())
        return base, None

    def can_add_dynamic(self, pod, pod_data, base: Requirements):
        """The NON-monotone suffix: topology (skew counts move both ways) and
        DRA allocation. Never memoized — must re-run on every probe.

        Try each volume topology alternative; the selected constraints shape
        the topology checks (existingnode.go:108-137)."""
        last_err = None
        self._pending_dra = None
        for vol_reqs in pod_data.volume_requirements or [None]:
            reqs, err = self._try_volume_alternative(pod, pod_data, base, vol_reqs)
            if err is not None:
                last_err = err
                continue
            # simulate DRA allocation against this node's published devices;
            # committed on Add. The result is independent of the volume
            # alternative (node requirements are immutable here), so a failure
            # short-circuits instead of re-running the DFS per alternative
            # (existingnode.go:122-135)
            if (pod_data.resource_claims or pod_data.resource_claim_err) and self.allocator is not None:
                if pod_data.resource_claim_err is not None:
                    return None, pod_data.resource_claim_err
                result, derr = self.allocator.allocate_for_node(self.name(), pod_data.resource_claims)
                if derr is not None:
                    return None, f"allocating dynamic resources, {derr}"
                self._pending_dra = result
            return reqs, None
        return None, last_err

    def _try_volume_alternative(self, pod, pod_data, base: Requirements, vol_reqs):
        """Volume requirements bind to the node only — never to pod affinity —
        so spread counting keeps the pod's own constraints
        (existingnode.go:143-168)."""
        node_reqs = Requirements()
        node_reqs.add(*base.values())
        if vol_reqs is not None:
            cerr = node_reqs.compatible(vol_reqs)
            if cerr is not None:
                return None, f"incompatible volume requirements, {cerr}"
            node_reqs.add(*vol_reqs.values())
        topo = self.topology.add_requirements(pod, self.taints, pod_data.strict_requirements, node_reqs)
        if isinstance(topo, str):
            return None, topo
        cerr = node_reqs.compatible(topo)
        if cerr is not None:
            return None, cerr
        node_reqs.add(*topo.values())
        return node_reqs, None

    def add(self, pod, pod_data, updated_requirements: Requirements) -> None:
        self._version += 1
        self.pods.append(pod)
        self.requirements = updated_requirements
        self.remaining_resources = res.subtract(self.remaining_resources, pod_data.requests)
        self.host_port_usage.add(pod.key(), pod_host_ports(pod))
        self.volume_usage.add(pod.key(), pod_data.volumes)
        if self._pending_dra is not None and self.allocator is not None:
            self.allocator.commit_for_node(self.name(), self._pending_dra)
            self._pending_dra = None
        self.topology.record(pod, self.taints, self.requirements)
