"""A minimal kube-scheduler stand-in: binds pending pods to Ready nodes.

The reference relies on the real kube-scheduler (via kind/KWOK) to bind pods
once Karpenter has provisioned capacity; in this hermetic substrate the Binder
plays that role for e2e flows. First-fit over nodes: resources, taints,
node-selector/affinity, registered + schedulable.
"""

from __future__ import annotations

from ..apis import labels as wk
from ..scheduling.hostports import HostPortUsage, pod_host_ports
from ..scheduling.requirements import Requirements
from ..scheduling.taints import taints_tolerate_pod
from ..utils import pods as pod_utils
from ..utils import resources as res


class Binder:
    def __init__(self, store, cluster, clock, dra_enabled: bool = False):
        self.store = store
        self.cluster = cluster
        self.clock = clock
        self.dra_enabled = dra_enabled
        self._dra_allocator = None
        self._bound_now: dict[str, str] = {}

    def bind_all(self) -> int:
        """One scheduling pass; returns number of pods bound.

        The pod view is BORROWED (store.borrow_list): under churn, deep-
        cloning every pod per pass was the binder's dominant cost. Borrowed
        objects are never mutated; binds made mid-pass are tracked in the
        `self._bound_now` overlay, and every node-name read below goes
        through `self._nn` so later candidates in the same pass see them —
        exactly the visibility the old mutate-the-local-clone scheme gave."""
        bound = 0
        nodes = sorted(self.store.list("Node"), key=lambda n: n.metadata.name)
        node_reqs = {n.metadata.name: Requirements.from_labels(n.metadata.labels) for n in nodes}
        self._bound_now: dict[str, str] = {}
        all_pods = self.store.borrow_list("Pod")
        # kube PodGC stand-in: active pods bound to a node that no longer
        # exists reset to pending (modeling controller recreation, like
        # eviction does) so the provisioner sees them again; node-owned
        # (static/mirror) pods die with their node instead — they must never
        # become pending demand
        node_names = {n.metadata.name for n in nodes}
        orphaned = False
        for q in all_pods:
            if q.spec.node_name and q.spec.node_name not in node_names and pod_utils.is_active(q):
                if pod_utils.is_owned_by_node(q):
                    # dies with the node: drop from this pass's view too, or
                    # the stale entry would count into affinity matching
                    self.store.try_delete("Pod", q.metadata.name, namespace=q.metadata.namespace)
                    orphaned = True
                    continue

                def orphan(p):
                    p.spec.node_name = ""
                    p.status.phase = "Pending"
                    p.status.start_time = None

                self.store.patch("Pod", q.metadata.name, orphan, namespace=q.metadata.namespace)
                orphaned = True
        if orphaned:
            # rare path: re-borrow so the view reflects the deletions/orphans
            all_pods = self.store.borrow_list("Pod")
        # per-node host-port usage, built once per pass from ACTIVE bound
        # pods (terminal pods free their ports, as in Kubernetes)
        self._port_usage = {}
        for q in all_pods:
            if self._nn(q) and pod_utils.is_active(q):
                self._port_usage.setdefault(self._nn(q), HostPortUsage()).add(q.key(), pod_host_ports(q))
        # store-content authority for node usage (faultline watch-loss
        # robustness): the cluster's per-node usage is event-fed, so a lossy
        # watch stream (dropped bind echo, dropped departure DELETED) leaves
        # it stale mid-pass. Track the pods ACTUALLY bound and non-terminal
        # per store content — the same population Cluster.update_pod counts —
        # keyed by node, so _available() can diff-correct sn.available().
        # When the two views agree (the lossless in-process default) the key
        # sets match and the correction is an exact no-op.
        self._node_pods = {}
        for q in all_pods:
            nn = self._nn(q)
            if nn and not pod_utils.is_terminal(q):
                self._node_pods.setdefault(nn, {})[q.key()] = q
        self._dra_allocator = None  # fresh per pass
        self._node_domain = {n.metadata.name: n.metadata.labels for n in nodes}
        # symmetric anti-affinity (the kube-scheduler's InterPodAffinity
        # plugin): ACTIVE BOUND pods carrying required anti terms repel
        # matching candidates from their domains; maintained incrementally so
        # a pod binding mid-pass repels later candidates in the same pass
        self._anti_holders = [
            (q, term, self._term_namespaces(q, term, all_pods))
            for q in all_pods
            if self._nn(q) and pod_utils.is_active(q) and q.spec.affinity is not None
            for term in q.spec.affinity.pod_anti_affinity_required
        ]
        for pod in all_pods:
            if not pod_utils.is_provisionable(pod):
                continue
            node = self._find_node(pod, nodes, node_reqs, all_pods)
            if node is not None:
                self._bind(pod, node)
                # overlay, not mutation: keeps the pass-local view current
                # for spread/affinity counting without touching the borrowed
                # stored object
                self._bound_now[pod.key()] = node.metadata.name
                self._node_pods.setdefault(node.metadata.name, {})[pod.key()] = pod
                self._port_usage.setdefault(node.metadata.name, HostPortUsage()).add(pod.key(), pod_host_ports(pod))
                if pod.spec.affinity is not None:
                    for term in pod.spec.affinity.pod_anti_affinity_required:
                        self._anti_holders.append((pod, term, self._term_namespaces(pod, term, all_pods)))
                bound += 1
        return bound

    def _nn(self, q) -> str:
        """The pod's node name as of NOW in this pass: binds made earlier in
        the pass (recorded in the overlay) win over the borrowed snapshot."""
        nn = self._bound_now.get(q.key())
        return nn if nn is not None else q.spec.node_name

    @staticmethod
    def _term_namespaces(pod, term, all_pods) -> set:
        return pod_utils.term_namespaces(pod, term, lambda: (p.metadata.namespace for p in all_pods))

    def _dra_ok(self, pod, node) -> bool:
        """Claim-bearing pods bind only where their claims are allocated (or
        allocatable) — the kube-scheduler's DRA plugin behavior. With the
        feature gate off the whole control plane ignores claims, so the binder
        must too or scheduled pods could never bind."""
        if not self.dra_enabled or not pod.spec.resource_claims:
            return True
        from ..scheduling.dynamicresources import Allocator, resolve_pod_claims

        claims, err = resolve_pod_claims(self.store, pod)
        if err is not None:
            return False
        if self._dra_allocator is None:
            self._dra_allocator = Allocator(self.store, self.clock)
        result, aerr = self._dra_allocator.allocate_for_node(node.metadata.name, claims)
        if aerr is not None:
            return False
        self._dra_allocator.commit_for_node(node.metadata.name, result)
        return True

    def _affinity_context(self, pod, all_pods):
        """Per-PENDING-POD precompute for the inter-pod affinity checks: the
        matching pods' occupied domains are node-independent, so one O(pods)
        pass here replaces an O(pods) rescan per candidate node. Reflects
        every bind made earlier in this pass (local node_name updates)."""
        from .objects import match_label_selector

        aff = pod.spec.affinity
        anti_blocked: set = set()  # (key, domain) the pod's own anti terms forbid
        aff_terms: list = []  # (key, allowed domains, found_any, self_match)
        if aff is not None:
            for term in aff.pod_anti_affinity_required:
                key = term.topology_key
                nss = self._term_namespaces(pod, term, all_pods)
                for q in all_pods:
                    if not self._nn(q) or not pod_utils.is_active(q):
                        continue
                    if q.metadata.namespace not in nss:
                        continue
                    if not match_label_selector(term.label_selector, q.metadata.labels):
                        continue
                    d = self._node_domain.get(self._nn(q), {}).get(key)
                    if d is not None:
                        anti_blocked.add((key, d))
            for term in aff.pod_affinity_required:
                key = term.topology_key
                nss = self._term_namespaces(pod, term, all_pods)
                allowed: set = set()
                found_any = False
                for q in all_pods:
                    if not self._nn(q) or not pod_utils.is_active(q):
                        continue
                    if q.metadata.namespace not in nss:
                        continue
                    if not match_label_selector(term.label_selector, q.metadata.labels):
                        continue
                    found_any = True
                    d = self._node_domain.get(self._nn(q), {}).get(key)
                    if d is not None:
                        allowed.add(d)
                self_match = pod.metadata.namespace in nss and match_label_selector(
                    term.label_selector, pod.metadata.labels
                )
                aff_terms.append((key, allowed, found_any, self_match))
        # symmetric enforcement: domains whose holders' anti terms match THIS pod
        holder_blocked: set = set()
        for q, term, q_ns in self._anti_holders:
            if pod.metadata.namespace not in q_ns:
                continue
            if not match_label_selector(term.label_selector, pod.metadata.labels):
                continue
            d = self._node_domain.get(self._nn(q), {}).get(term.topology_key)
            if d is not None:
                holder_blocked.add((term.topology_key, d))
        return anti_blocked, aff_terms, holder_blocked

    def _find_node(self, pod, nodes, node_reqs_cache, all_pods):
        reqs = Requirements.from_pod(pod, strict=True)
        requests = res.pod_requests(pod)
        aff_ctx = self._affinity_context(pod, all_pods)
        for node in nodes:
            if node.spec.unschedulable or node.metadata.deletion_timestamp is not None:
                continue
            if any(t.key == wk.UNREGISTERED_TAINT_KEY for t in node.spec.taints):
                continue
            if taints_tolerate_pod(node.spec.taints, pod) is not None:
                continue
            if node_reqs_cache[node.metadata.name].compatible(reqs) is not None:
                continue
            sn = self.cluster.node_for_name(node.metadata.name)
            available = self._available(node, sn)
            if not res.fits(requests, available):
                continue
            if not self._topology_ok(pod, node, nodes, all_pods, aff_ctx):
                continue
            if not self._ports_ok(pod, node):
                continue
            if not self._dra_ok(pod, node):
                continue
            return node
        return None

    def _available(self, node, sn) -> dict:
        """The node's available resources with the store as the authority:
        start from the cluster's event-fed `sn.available()` and correct it
        for any divergence between the pods the cluster TRACKS on the node
        and the pods the store actually has bound there (including binds
        made earlier in this pass). A lossy watch stream is the only way
        the two differ — when they agree this returns sn.available()
        untouched, so no-fault placements are bit-identical by
        construction."""
        if sn is None:
            return node.status.allocatable
        available = sn.available()
        view = self._node_pods.get(node.metadata.name, {})
        tracked = sn.pod_requests
        if view.keys() != tracked.keys():
            # missed bind/create echoes: the store knows the pod is here,
            # the cluster never saw the event — its requests are in use
            for key, q in view.items():
                if key not in tracked:
                    available = res.subtract(available, res.pod_requests(q))
            # missed departure DELETEDs: the cluster still charges a pod
            # the store no longer has — give its recorded requests back
            ghosts = [tracked[key] for key in tracked if key not in view]
            if ghosts:
                available = res.merge(available, *ghosts)
        return available

    def _ports_ok(self, pod, node) -> bool:
        """The kube-scheduler NodePorts plugin: a pod with host ports cannot
        land on a node where an ACTIVE bound pod already holds a conflicting
        port (terminal pods free theirs)."""
        ports = pod_host_ports(pod)
        if not ports:
            return True
        usage = self._port_usage.get(node.metadata.name)
        return usage is None or usage.conflicts(pod.key(), ports) is None

    def _topology_ok(self, pod, node, nodes, all_pods, aff_ctx) -> bool:
        """Honor DoNotSchedule spread constraints and inter-pod
        (anti-)affinity — the kube-scheduler behaviors the e2e flows rely on.
        `aff_ctx` is the pod's precomputed (anti_blocked, aff_terms,
        holder_blocked) from _affinity_context."""
        from .objects import match_label_selector
        from ..controllers.provisioning.scheduling.topology import effective_spread_selector

        for tsc in pod.spec.topology_spread_constraints:
            if tsc.when_unsatisfiable != "DoNotSchedule":
                continue
            node_domain = self._node_domain
            eff_sel = effective_spread_selector(pod, tsc)
            counts: dict[str, int] = {}
            for n in nodes:
                d = n.metadata.labels.get(tsc.topology_key)
                if d is not None:
                    counts.setdefault(d, 0)
            for q in all_pods:
                # terminal pods vacate their domain (kube-scheduler semantics;
                # mirrors the solver's ignored_for_topology)
                if not self._nn(q) or not pod_utils.is_active(q):
                    continue
                if q.metadata.namespace != pod.metadata.namespace:
                    continue
                if not match_label_selector(eff_sel, q.metadata.labels):
                    continue
                d = node_domain.get(self._nn(q), {}).get(tsc.topology_key)
                if d is not None:
                    counts[d] = counts.get(d, 0) + 1
            my_domain = node.metadata.labels.get(tsc.topology_key)
            if my_domain is None:
                continue
            if counts:
                if counts.get(my_domain, 0) + 1 - min(counts.values()) > tsc.max_skew:
                    return False
        # inter-pod (anti-)affinity, kube-scheduler InterPodAffinity
        # semantics over ANY topology key (a node missing the key offers no
        # domain: anti terms cannot be violated there, affinity terms cannot
        # be satisfied there) — set lookups against the precomputed context
        node_labels = node.metadata.labels
        anti_blocked, aff_terms, holder_blocked = aff_ctx
        for key, d in anti_blocked:
            if node_labels.get(key) == d:
                return False
        for key, d in holder_blocked:
            if node_labels.get(key) == d:
                return False
        for key, allowed, found_any, self_match in aff_terms:
            my_d = node_labels.get(key)
            if my_d is None:
                return False
            if my_d in allowed:
                continue
            # bootstrap rule: with NO matching pod anywhere, a pod matching
            # its own term may found the domain
            if found_any or not self_match:
                return False
        return True

    def _bind(self, pod, node) -> None:
        def apply(p):
            p.spec.node_name = node.metadata.name
            p.status.phase = "Running"
            p.status.start_time = self.clock.now()

        self.store.patch("Pod", pod.metadata.name, apply, namespace=pod.metadata.namespace)
