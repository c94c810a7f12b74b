"""A minimal DaemonSet controller stand-in for the hermetic substrate.

The reference's e2e environment (kind + KWOK) runs the real DaemonSet
controller, so daemon pods exist on every matching node and the
kube-scheduler's NodePorts/resource accounting sees them. This substrate has
no kubelet or controller-manager; the runner materializes one daemon pod per
(DaemonSet, compatible registered node) so that:

- state nodes account daemon usage as REAL pods (the scheduler's phantom
  daemon headroom then nets to zero, exactly as designed in
  existingnode.go:45-60 semantics);
- host-port reservations made by daemons exist on the node for the Binder's
  NodePorts check and the solver's encode;
- emptiness/consolidation treat daemon-only nodes as reclaimable (daemon
  pods are excluded from reschedulability, like the reference).
"""

from __future__ import annotations

from ..apis import labels as wk
from ..scheduling.requirements import Requirements
from ..scheduling.taints import taints_tolerate_pod


class DaemonSetRunner:
    def __init__(self, store, clock):
        self.store = store
        self.clock = clock

    def reconcile(self) -> int:
        """Converge daemon pods: create missing ones on compatible registered
        nodes, delete orphans (DS gone or node gone). Returns pods created."""
        created = 0
        daemonsets = {(ds.metadata.namespace, ds.metadata.name): ds for ds in self.store.list("DaemonSet")}
        nodes = {n.metadata.name: n for n in self.store.list("Node")}

        # index existing daemon pods by (ds namespace, ds name, node)
        have: dict[tuple[str, str, str], object] = {}
        for p in self.store.list("Pod"):
            owner = next((o for o in p.metadata.owner_references if o.kind == "DaemonSet"), None)
            if owner is None:
                continue
            key = (p.metadata.namespace, owner.name)
            if key not in daemonsets or (p.spec.node_name and p.spec.node_name not in nodes):
                self.store.try_delete("Pod", p.metadata.name, namespace=p.metadata.namespace)
                continue
            if p.spec.node_name:
                have[(p.metadata.namespace, owner.name, p.spec.node_name)] = p

        from .store import AlreadyExists

        for (ns, ds_name), ds in daemonsets.items():
            template = ds.to_pod()
            for name, node in nodes.items():
                if (ns, ds_name, name) in have:
                    continue
                if node.metadata.deletion_timestamp is not None:
                    continue
                if any(t.key == wk.UNREGISTERED_TAINT_KEY for t in node.spec.taints):
                    continue
                if not self._matches(template, node):
                    continue
                pod = ds.to_pod()
                pod.metadata.name = f"{ds_name}-{name}"
                pod.spec.node_name = name
                pod.status.phase = "Running"
                pod.status.start_time = self.clock.now()
                try:
                    self.store.create(pod)
                    created += 1
                except AlreadyExists:
                    # a non-daemon pod owns the name; converges next tick if
                    # it goes away, and the port is held meanwhile either way
                    continue
        return created

    @staticmethod
    def _matches(template, node) -> bool:
        """DaemonSet scheduling predicate: tolerates the node's taints (the
        real controller adds not-ready/unreachable tolerations implicitly;
        the substrate's registered gate stands in for that) and matches the
        template's node selector or ANY required affinity OR-term — the same
        predicate the scheduler's daemon-compatibility uses
        (_daemon_requirement_alternatives), so materialization converges with
        the headroom the solve reserved."""
        from ..controllers.provisioning.scheduling.scheduler import _daemon_requirement_alternatives

        if taints_tolerate_pod(node.spec.taints, template) is not None:
            return False
        node_reqs = Requirements.from_labels(node.metadata.labels)
        return any(node_reqs.compatible(alt) is None for alt in _daemon_requirement_alternatives(template))
