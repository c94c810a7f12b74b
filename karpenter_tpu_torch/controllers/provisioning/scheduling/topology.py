"""Topology tracking: spread constraints, pod affinity/anti-affinity, and
inverse anti-affinity.

Reference: scheduling/topology.go:47-590, topologygroup.go, and
topologynodefilter.go. The semantics preserved exactly:

- spread: valid domains satisfy `count + self - globalMin <= maxSkew`; hostname
  is special-cased (a new node is always a fresh empty domain, global min 0).
- affinity: domains where a selected pod already runs; a self-selecting pod may
  bootstrap a fresh domain.
- anti-affinity: only empty domains are allowed, and inverse tracking blocks
  domains that contain pods whose anti-affinity selects the incoming pod.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

from ....apis import labels as wk
from ....scheduling.requirements import Operator, Requirement, Requirements
from ....scheduling.taints import Taint, Toleration, taints_tolerate_pod
from ....kube.objects import match_label_selector
from ....utils import pods as pod_utils

TYPE_SPREAD = "topology-spread"
TYPE_AFFINITY = "pod-affinity"
TYPE_ANTI_AFFINITY = "pod-anti-affinity"

HONOR = "Honor"
IGNORE = "Ignore"


class TopologyDomainGroup:
    """Universe of domains for a topology key, each tagged with the taints of
    the NodePools providing it (topologygroup.go TopologyDomainGroup)."""

    def __init__(self):
        self._domains: dict[str, list[list[Taint]]] = {}

    def insert(self, domain: str, taints: list[Taint]) -> None:
        self._domains.setdefault(domain, []).append(list(taints))

    def for_each_domain(self, pod, taint_policy: str, fn: Callable[[str], None]) -> None:
        """Yield domains reachable by the pod: if taint_policy is Honor, at
        least one providing NodePool's taints must be tolerated."""
        for domain, taint_sets in self._domains.items():
            if taint_policy == HONOR:
                if not any(taints_tolerate_pod(ts, pod, include_prefer_no_schedule=True) is None for ts in taint_sets):
                    continue
            fn(domain)


class TopologyNodeFilter:
    """Decides whether a node participates in a spread topology
    (topologynodefilter.go:31-95)."""

    def __init__(self, requirements: list[Requirements], taint_policy: str, affinity_policy: str, tolerations: list):
        self.requirements = requirements
        self.taint_policy = taint_policy
        self.affinity_policy = affinity_policy
        self.tolerations = tolerations

    @classmethod
    def always(cls) -> "TopologyNodeFilter":
        return cls([], IGNORE, IGNORE, [])

    @classmethod
    def for_pod(cls, pod, taint_policy: str, affinity_policy: str) -> "TopologyNodeFilter":
        selector_reqs = Requirements.from_labels(pod.spec.node_selector)
        aff = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        reqs_list: list[Requirements] = []
        if aff is None or not aff.required:
            reqs_list = [selector_reqs]
        else:
            for term in aff.required:  # OR'd terms
                r = Requirements()
                r.add(*selector_reqs.values())
                r.add(*Requirements.from_node_selector_terms(term).values())
                reqs_list.append(r)
        return cls(reqs_list, taint_policy, affinity_policy, pod.spec.tolerations or [])

    def matches(self, taints: Iterable[Taint], node_requirements: Requirements, allow_undefined=frozenset()) -> bool:
        ok_affinity = True
        if self.affinity_policy == HONOR and self.requirements:
            ok_affinity = any(
                node_requirements.compatible(r, allow_undefined=allow_undefined or wk.WELL_KNOWN_LABELS) is None
                for r in self.requirements
            )
        ok_taints = True
        if self.taint_policy == HONOR:
            tols = [t if isinstance(t, Toleration) else Toleration.from_dict(t) for t in self.tolerations]
            for t in taints:
                if t.effect == "PreferNoSchedule":
                    continue
                if not any(tol.tolerates(t) for tol in tols):
                    ok_taints = False
                    break
        return ok_affinity and ok_taints


class TopologyGroup:
    def __init__(
        self,
        type_: str,
        key: str,
        pod,
        namespaces: set[str],
        label_selector: Optional[dict],
        max_skew: int,
        min_domains: Optional[int],
        taint_policy: Optional[str],
        affinity_policy: Optional[str],
        domain_group: TopologyDomainGroup,
    ):
        self.type = type_
        self.key = key
        self.namespaces = namespaces
        self.selector = label_selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        self.owners: set[str] = set()
        if type_ == TYPE_SPREAD:
            tp = taint_policy if taint_policy is not None else IGNORE
            ap = affinity_policy if affinity_policy is not None else HONOR
            self.node_filter = TopologyNodeFilter.for_pod(pod, tp, ap)
        else:
            self.node_filter = TopologyNodeFilter.always()
        self.domains: dict[str, int] = {}
        self.empty_domains: set[str] = set()
        domain_group.for_each_domain(pod, self.node_filter.taint_policy, self._register_one)

    def _register_one(self, domain: str) -> None:
        if domain not in self.domains:
            self.domains[domain] = 0
            self.empty_domains.add(domain)

    # -- identity for dedup (topologygroup.go:188-204) -------------------------
    def hash_key(self) -> tuple:
        return (
            self.type,
            self.key,
            frozenset(self.namespaces),
            self.max_skew,
            self.min_domains,
            _selector_key(self.selector),
            self.node_filter.taint_policy,
            self.node_filter.affinity_policy,
            # full node-filter identity: requirement values/operators/bounds and
            # tolerations, not just keys — distinct filters must not dedupe
            tuple(
                tuple(sorted((r.key, r.complement, frozenset(r.values), r.gte, r.lte) for r in reqs.values()))
                for reqs in self.node_filter.requirements
            ),
            tuple(sorted(repr(t) for t in self.node_filter.tolerations)),
        )

    # -- ownership -------------------------------------------------------------
    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    # -- counting --------------------------------------------------------------
    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1
            self.empty_domains.discard(d)

    def register(self, *domains: str) -> None:
        for d in domains:
            if d not in self.domains:
                self.domains[d] = 0
                self.empty_domains.add(d)

    def unregister(self, *domains: str) -> None:
        for d in domains:
            self.domains.pop(d, None)
            self.empty_domains.discard(d)

    def selects(self, pod) -> bool:
        return pod.metadata.namespace in self.namespaces and (
            self.selector is not None and match_label_selector(self.selector, pod.metadata.labels)
        )

    def counts(self, pod, taints, requirements: Requirements) -> bool:
        return self.selects(pod) and self.node_filter.matches(taints, requirements)

    # -- the heart: next viable domain (topologygroup.go:128-440) --------------
    def get(self, pod, pod_domains: Requirement, node_domains: Requirement) -> tuple[Requirement, set[str]]:
        if self.type == TYPE_SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TYPE_AFFINITY:
            req = self._next_domain_affinity(pod, pod_domains, node_domains)
            return req, set(req.values)
        req = self._next_domain_anti_affinity(pod_domains, node_domains)
        return req, set(req.values)

    def _next_domain_spread(self, pod, pod_domains: Requirement, node_domains: Requirement) -> tuple[Requirement, set[str]]:
        min_count = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        valid: set[str] = set()

        # hostname special case: a new NodeClaim is always a fresh domain
        if self.key == wk.HOSTNAME_LABEL_KEY and len(node_domains.values) == 1:
            hostname = next(iter(node_domains.values))
            count = self.domains.get(hostname, 0) + (1 if self_selecting else 0)
            if count <= self.max_skew:
                valid.add(hostname)
                return Requirement(self.key, Operator.IN, [hostname]), valid
            return Requirement(self.key, Operator.DOES_NOT_EXIST), valid

        best_domain, best_count = None, math.inf
        candidates = (
            [d for d in node_domains.values if d in self.domains]
            if node_domains.operator() == Operator.IN
            else [d for d in self.domains if node_domains.has(d)]
        )
        for domain in candidates:
            count = self.domains[domain] + (1 if self_selecting else 0)
            if self._within_skew(count, min_count):
                valid.add(domain)
                if count < best_count:
                    best_domain, best_count = domain, count
        if best_domain is None:
            return Requirement(self.key, Operator.DOES_NOT_EXIST), valid
        return Requirement(self.key, Operator.IN, [best_domain]), valid

    def _within_skew(self, count: int, min_count: int) -> bool:
        """The spread's test of one domain: `count` already holds the pod
        itself when the group selects it."""
        return count - min_count <= self.max_skew

    def spread_domains(self, pod, pod_domains: Requirement) -> list[str]:
        """Every domain `_next_domain_spread` would find valid for the pod on
        a node that allowed them all (the non-hostname branch). Counts move
        only when a pod is recorded, so the list holds until the next add."""
        min_count = self._domain_min_count(pod_domains)
        incr = 1 if self.selects(pod) else 0
        return [d for d, c in self.domains.items() if self._within_skew(c + incr, min_count)]

    def _domain_min_count(self, pod_domains: Requirement) -> int:
        if self.key == wk.HOSTNAME_LABEL_KEY:
            return 0  # we can always create a new hostname domain
        min_count = math.inf
        supported = 0
        for domain, count in self.domains.items():
            if pod_domains.has(domain):
                supported += 1
                min_count = min(min_count, count)
        if self.min_domains is not None and supported < self.min_domains:
            min_count = 0
        return 0 if min_count is math.inf else min_count

    def _next_domain_affinity(self, pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        options = Requirement(self.key, Operator.DOES_NOT_EXIST)

        if self.key == wk.HOSTNAME_LABEL_KEY and len(node_domains.values) == 1:
            hostname = next(iter(node_domains.values))
            if not pod_domains.has(hostname):
                return options
            if self.domains.get(hostname, 0) > 0:
                options.insert(hostname)
                return options
            if self.selects(pod) and (len(self.domains) == len(self.empty_domains) or not self._any_compatible_pod_domain(pod_domains)):
                options.insert(hostname)
            return options

        candidates = (
            [d for d in node_domains.values if d in self.domains]
            if node_domains.operator() == Operator.IN
            else [d for d in self.domains if node_domains.has(d)]
        )
        for domain in candidates:
            if pod_domains.has(domain) and self.domains.get(domain, 0) > 0:
                options.insert(domain)
        if len(options.values) != 0:
            return options

        # bootstrap: self-selecting pod and no compatible scheduled pods yet
        if self.selects(pod) and (len(self.domains) == len(self.empty_domains) or not self._any_compatible_pod_domain(pod_domains)):
            for domain in self.domains:
                if pod_domains.has(domain) and node_domains.has(domain):
                    options.insert(domain)
                    break
            if len(options.values) == 0:
                for domain in self.domains:
                    if pod_domains.has(domain):
                        options.insert(domain)
                        break
        return options

    def _any_compatible_pod_domain(self, pod_domains: Requirement) -> bool:
        return any(pod_domains.has(d) and c > 0 for d, c in self.domains.items())

    def _next_domain_anti_affinity(self, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        options = Requirement(self.key, Operator.DOES_NOT_EXIST)
        if self.key == wk.HOSTNAME_LABEL_KEY and len(node_domains.values) == 1:
            hostname = next(iter(node_domains.values))
            if self.domains.get(hostname, 0) == 0:
                options.insert(hostname)
            return options
        if node_domains.operator() == Operator.IN and len(node_domains.values) < len(self.empty_domains):
            for domain in node_domains.values:
                if domain in self.empty_domains and pod_domains.has(domain):
                    options.insert(domain)
        else:
            for domain in self.empty_domains:
                if node_domains.has(domain) and pod_domains.has(domain):
                    options.insert(domain)
        return options


def effective_spread_selector(pod, tsc) -> Optional[dict]:
    """The spread constraint's selector with the pod's values for every
    matchLabelKeys entry merged in as In-expressions (topology.go:467-475);
    keys absent from the pod's labels are ignored."""
    sel = tsc.label_selector
    if sel is None:
        return None  # nil selector matches nothing; matchLabelKeys can't revive it
    keys = [k for k in (getattr(tsc, "match_label_keys", None) or []) if k in pod.metadata.labels]
    if not keys:
        return sel
    merged = {
        "matchLabels": dict((sel or {}).get("matchLabels") or {}),
        "matchExpressions": list((sel or {}).get("matchExpressions") or []),
    }
    for k in keys:
        merged["matchExpressions"].append({"key": k, "operator": "In", "values": [pod.metadata.labels[k]]})
    return merged


def _selector_key(selector: Optional[dict]):
    if selector is None:
        return None
    ml = tuple(sorted((selector.get("matchLabels") or {}).items()))
    me = tuple(
        sorted(
            (e["key"], e["operator"], tuple(sorted(e.get("values", []))))
            for e in (selector.get("matchExpressions") or [])
        )
    )
    return (ml, me)


# domain-group construction iterates every (NodePool x InstanceType x
# requirement key) — ~1e3 Requirements builds — yet its inputs change only
# when a NodePool template or the instance-type catalog does. Cached across
# Scheduler builds (each consolidation simulation builds one) keyed on
# template content + catalog list identity; groups are read-only after build
# (insert happens only inside _build_domain_groups).
_DOMAIN_GROUPS_CACHE: dict = {}

# whether a node participates in a spread topology depends only on the group's
# filter identity and the node's content — memoized across the many Topology
# instances the consolidation loop builds per round (one per simulation)
_NODE_MATCH_CACHE: dict = {}


def _node_filter_matches_cached(tg, tg_hash: tuple, node, scope) -> bool:
    # `scope` is the owning Cluster's process-unique epoch: (name, rv) pairs
    # repeat across Environments in one process, so verdicts must not leak
    # between stores
    key = (scope, tg_hash, node.metadata.name, node.metadata.resource_version)
    hit = _NODE_MATCH_CACHE.get(key)
    if hit is None:
        if len(_NODE_MATCH_CACHE) > 200_000:
            _NODE_MATCH_CACHE.clear()
        hit = _NODE_MATCH_CACHE[key] = tg.node_filter.matches(
            node.spec.taints, Requirements.from_labels_view(node.metadata.labels)
        )
    return hit


def _nodepool_template_fingerprint(np) -> tuple:
    t = np.spec.template
    return (
        np.metadata.name,
        repr(t.requirements),
        repr(t.labels),
        tuple(t.taints),
    )


def _domain_groups_cached(node_pools, instance_types: dict[str, list]) -> dict:
    key = tuple(sorted(_nodepool_template_fingerprint(np) for np in node_pools))
    entry = _DOMAIN_GROUPS_CACHE.get(key)
    if entry is not None:
        cached_its, groups = entry
        if len(cached_its) == len(instance_types) and all(
            cached_its.get(name) is its for name, its in instance_types.items()
        ):
            return groups
    groups = Topology._build_domain_groups(node_pools, instance_types)
    if len(_DOMAIN_GROUPS_CACHE) > 8:
        _DOMAIN_GROUPS_CACHE.clear()
    _DOMAIN_GROUPS_CACHE[key] = (dict(instance_types), groups)
    return groups


class Topology:
    """The per-solve topology state (topology.go:47-103)."""

    def __init__(
        self,
        store,
        cluster,
        state_nodes: list,
        node_pools: list,
        instance_types: dict[str, list],
        pods: list,
        preference_policy: str = "Respect",
    ):
        self.store = store
        self.cluster = cluster
        self.state_nodes = state_nodes
        self.preference_policy = preference_policy
        self.topology_groups: dict[tuple, TopologyGroup] = {}
        self.inverse_topology_groups: dict[tuple, TopologyGroup] = {}
        self.domain_groups = _domain_groups_cached(node_pools, instance_types)
        self.excluded_pods: set[str] = set()
        self._prepared = False
        # record() memo: (namespace, labels) -> (n_groups stamp, groups whose
        # selector selects such pods). Every add used to scan ALL topology
        # groups per recorded pod; deployment replicas share (ns, labels), so
        # the selector scan runs once per distinct shape. The group-count
        # stamp invalidates entries when prepare()/update() registers new
        # groups mid-solve (groups are never removed within a solve).
        self._record_memo: dict[tuple, tuple[int, list]] = {}
        if pods:
            self.prepare(pods)

    def prepare(self, pods: list) -> None:
        """Exclude the solve pods from counting BEFORE recording inverse
        anti-affinity domains (topology.go:91-103 order), then build each
        pod's topology groups. Must run exactly once per solve."""
        self.excluded_pods.update(p.metadata.uid for p in pods)
        if not self._prepared:
            self._update_inverse_affinities()
            self._prepared = True
        for p in pods:
            self.update(p)

    def get_topology_zone_constraints(self, pod, pod_requirements: Requirements) -> tuple[set | None, bool]:
        """Valid zones intersected across every zone-keyed topology group
        owning the pod, plus whether they are satisfiable; None means no zone
        topology constrains the pod (topology.go:250-281
        GetTopologyZoneConstraints)."""
        result: set | None = None
        for tg in self.topology_groups.values():
            if not tg.is_owned_by(pod.metadata.uid) or tg.key != wk.ZONE_LABEL_KEY:
                continue
            pod_domains = Requirement(tg.key, Operator.EXISTS)
            if pod_requirements.has(tg.key):
                pod_domains = pod_requirements.get(tg.key)
            node_domains = Requirement(tg.key, Operator.EXISTS)
            _, valid = tg.get(pod, pod_domains, node_domains)
            if not valid:
                return None, False
            result = set(valid) if result is None else result & valid
        return result, True

    # -- construction ----------------------------------------------------------
    @staticmethod
    def _build_domain_groups(node_pools, instance_types: dict[str, list]) -> dict[str, TopologyDomainGroup]:
        """Universe of domains per key from NodePool x InstanceType requirements
        (topology.go:105-143). NodePool requirements narrow instance domains."""
        groups: dict[str, TopologyDomainGroup] = {}
        by_name = {np.metadata.name: np for np in node_pools}
        for np_name, its in instance_types.items():
            np = by_name.get(np_name)
            if np is None:
                continue
            np_taints = np.spec.template.taints
            base = Requirements.from_node_selector_terms(np.spec.template.requirements)
            base.add(*Requirements.from_labels(np.spec.template.labels).values())
            for it in its:
                reqs = base.copy()
                reqs.add(*it.requirements.values())
                for key, requirement in reqs.items():
                    if requirement.operator() == Operator.IN:
                        g = groups.setdefault(key, TopologyDomainGroup())
                        for domain in requirement.values:
                            g.insert(domain, np_taints)
            for key, requirement in base.items():
                if requirement.operator() == Operator.IN:
                    g = groups.setdefault(key, TopologyDomainGroup())
                    for domain in requirement.values:
                        g.insert(domain, np_taints)
        return groups

    # -- update on pod add/relax (topology.go:361-425) -------------------------
    def update(self, pod) -> None:
        for tg in self.topology_groups.values():
            tg.remove_owner(pod.metadata.uid)

        aff = pod.spec.affinity
        has_required_anti = aff is not None and bool(aff.pod_anti_affinity_required)
        has_any_anti = aff is not None and (bool(aff.pod_anti_affinity_required) or bool(aff.pod_anti_affinity_preferred))
        if (self.preference_policy == "Ignore" and has_required_anti) or (self.preference_policy == "Respect" and has_any_anti):
            self._update_inverse_anti_affinity(pod, None)

        for tg in self._new_for_topologies(pod) + self._new_for_affinities(pod):
            h = tg.hash_key()
            existing = self.topology_groups.get(h)
            if existing is None:
                self._count_domains(tg)
                self.topology_groups[h] = tg
            else:
                tg = existing
            tg.add_owner(pod.metadata.uid)

    def _new_for_topologies(self, pod) -> list[TopologyGroup]:
        out = []
        for tsc in pod.spec.topology_spread_constraints:
            if self.preference_policy == "Ignore" and tsc.when_unsatisfiable != "DoNotSchedule":
                continue
            out.append(
                TopologyGroup(
                    TYPE_SPREAD,
                    tsc.topology_key,
                    pod,
                    {pod.metadata.namespace},
                    effective_spread_selector(pod, tsc),
                    tsc.max_skew,
                    tsc.min_domains,
                    tsc.node_taints_policy,
                    tsc.node_affinity_policy,
                    self.domain_groups.get(tsc.topology_key, TopologyDomainGroup()),
                )
            )
        return out

    def _new_for_affinities(self, pod) -> list[TopologyGroup]:
        out = []
        aff = pod.spec.affinity
        if aff is None:
            return out
        terms: list[tuple[str, object]] = []
        for t in aff.pod_affinity_required:
            terms.append((TYPE_AFFINITY, t))
        for t in aff.pod_anti_affinity_required:
            terms.append((TYPE_ANTI_AFFINITY, t))
        if self.preference_policy == "Respect":
            for wt in aff.pod_affinity_preferred:
                terms.append((TYPE_AFFINITY, wt.term))
            for wt in aff.pod_anti_affinity_preferred:
                terms.append((TYPE_ANTI_AFFINITY, wt.term))
        for type_, term in terms:
            out.append(
                TopologyGroup(
                    type_,
                    term.topology_key,
                    pod,
                    self._namespaces_for_term(pod, term),
                    term.label_selector,
                    2**31 - 1,
                    None,
                    None,
                    None,
                    self.domain_groups.get(term.topology_key, TopologyDomainGroup()),
                )
            )
        return out

    def _namespaces_for_term(self, pod, term) -> set[str]:
        from ....utils.pods import term_namespaces

        # empty selector matches all namespaces; approximated with the
        # namespaces of current pods plus the pod's own (shared helper keeps
        # the Binder's term scoping identical)
        return term_namespaces(
            pod, term, lambda: (p.metadata.namespace for p in self.store.borrow_list("Pod"))
        )

    def _update_inverse_affinities(self) -> None:
        for pod in self.cluster.pods_with_anti_affinity():
            if pod.metadata.uid in self.excluded_pods:
                continue
            node = self.store.borrow_get("Node", pod.spec.node_name) if pod.spec.node_name else None
            self._update_inverse_anti_affinity(pod, node.metadata.labels if node else None)

    def _update_inverse_anti_affinity(self, pod, node_labels: Optional[dict]) -> None:
        """Track pods with anti-affinity so incoming pods they select can't land
        in their domains (topology.go:476-508)."""
        aff = pod.spec.affinity
        for term in aff.pod_anti_affinity_required:
            tg = TopologyGroup(
                TYPE_ANTI_AFFINITY,
                term.topology_key,
                pod,
                self._namespaces_for_term(pod, term),
                term.label_selector,
                2**31 - 1,
                None,
                None,
                None,
                self.domain_groups.get(term.topology_key, TopologyDomainGroup()),
            )
            h = tg.hash_key()
            existing = self.inverse_topology_groups.get(h)
            if existing is None:
                self.inverse_topology_groups[h] = tg
            else:
                tg = existing
            if node_labels and tg.key in node_labels:
                tg.record(node_labels[tg.key])
            tg.add_owner(pod.metadata.uid)

    def _count_domains(self, tg: TopologyGroup) -> None:
        """Initialize counts from existing scheduled pods (topology.go:361-459)."""
        tg_hash = tg.hash_key()
        scope = getattr(self.cluster, "epoch", None) or id(self.store)
        for n in self.state_nodes:
            if n.node is None:
                continue
            if not _node_filter_matches_cached(tg, tg_hash, n.node, scope):
                continue
            domain = n.labels().get(tg.key)
            if domain is not None:
                tg.register(domain)

        if tg.selector is None:
            return  # nil selector matches no pods (labels.Nothing()), but node
            # domains above are still registered
        node_cache: dict[str, object] = {}
        for ns in tg.namespaces:
            # borrowed reads: pure counting over the informer-cache view
            for pod in self.store.borrow_list("Pod", namespace=ns, label_selector=tg.selector):
                if not pod.spec.node_name or pod.metadata.uid in self.excluded_pods:
                    continue
                if ignored_for_topology(pod):
                    continue
                node = node_cache.get(pod.spec.node_name)
                if node is None:
                    node = self.store.borrow_get("Node", pod.spec.node_name)
                    if node is None:
                        continue
                    node_cache[pod.spec.node_name] = node
                domain = node.metadata.labels.get(tg.key)
                if domain is None and tg.key == wk.HOSTNAME_LABEL_KEY:
                    domain = node.metadata.name
                if domain is None:
                    continue
                if not _node_filter_matches_cached(tg, tg_hash, node, scope):
                    continue
                tg.record(domain)

    # -- solve-time interface (topology.go:222-270) ----------------------------
    def add_requirements(
        self, pod, taints, pod_requirements: Requirements, node_requirements: Requirements, allow_undefined=frozenset()
    ) -> Requirements | str:
        """Tighten node requirements with per-topology viable domains; returns
        the tightened Requirements or an error string."""
        out = Requirements()
        out.add(*node_requirements.values())
        for tg in self._matching_topologies(pod, taints, node_requirements):
            pod_domains = pod_requirements.get(tg.key)
            node_domains = node_requirements.get(tg.key)
            domains, _ = tg.get(pod, pod_domains, node_domains)
            if len(domains) == 0:
                return f"unsatisfiable topology constraint for {tg.type}, key={tg.key}"
            out.add(domains)
        return out

    def record(self, pod, taints, requirements: Requirements) -> None:
        # per-(namespace, labels) memo of the groups that SELECT this pod
        # shape (counts() = selects() AND node_filter.matches(); the selector
        # half is signature-stable, the node-filter half depends on the
        # placement and re-evaluates per call)
        md = pod.metadata
        key = (md.namespace, tuple(sorted(md.labels.items())) if md.labels else ())
        entry = self._record_memo.get(key)
        if entry is None or entry[0] != len(self.topology_groups):
            entry = (
                len(self.topology_groups),
                [tg for tg in self.topology_groups.values() if tg.selects(pod)],
            )
            self._record_memo[key] = entry
        for tg in entry[1]:
            if tg.node_filter.matches(taints, requirements):
                domains = requirements.get(tg.key)
                if tg.type == TYPE_ANTI_AFFINITY:
                    tg.record(*domains.values)
                elif domains.operator() == Operator.IN and len(domains.values) == 1:
                    tg.record(next(iter(domains.values)))
        for tg in self.inverse_topology_groups.values():
            if tg.is_owned_by(pod.metadata.uid):
                tg.record(*requirements.get(tg.key).values)

    def register(self, key: str, domain: str) -> None:
        for tg in list(self.topology_groups.values()) + list(self.inverse_topology_groups.values()):
            if tg.key == key:
                tg.register(domain)

    def _matching_topologies(self, pod, taints, requirements: Requirements) -> list[TopologyGroup]:
        out = [tg for tg in self.topology_groups.values() if tg.is_owned_by(pod.metadata.uid)]
        out += [tg for tg in self.inverse_topology_groups.values() if tg.counts(pod, taints, requirements)]
        return out


def ignored_for_topology(pod) -> bool:
    return pod_utils.is_terminal(pod) or pod_utils.is_terminating(pod)
