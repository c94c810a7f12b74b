"""Exact host-side validation of solver Results — used in tests and as the
safety net for the tensor backend (SURVEY.md §7: "validated by
simulation-equivalence (all pods schedulable, cost <=), not bit-identical
placement").
"""

from __future__ import annotations

from collections import defaultdict

from ..apis import labels as wk
from ..kube.objects import match_label_selector
from ..scheduling.requirements import Requirements
from ..scheduling.taints import taints_tolerate_pod
from ..utils import resources as res


def validate_results(snap, results) -> list[str]:
    """Returns a list of violations (empty = valid)."""
    errors: list[str] = []

    # per new claim: resources, requirements, taints
    for idx, nc in enumerate(results.new_node_claims):
        if not nc.pods:
            continue
        total = res.requests_for_pods(nc.pods)
        if not nc.instance_type_options:
            errors.append(f"claim {idx}: no instance types")
            continue
        # override offerings give a group its own allocatable — a claim may
        # be launchable ONLY via such a group (types.go AllocatableOfferings)
        fits_any = any(
            offs and res.fits(total, alloc)
            for it in nc.instance_type_options
            for alloc, offs in it.allocatable_offerings_list()
        )
        if not fits_any:
            errors.append(f"claim {idx}: pods exceed every instance type allocatable")
        for p in nc.pods:
            reqs = Requirements.from_pod(p, strict=True)
            if nc.requirements.compatible(reqs, allow_undefined=wk.WELL_KNOWN_LABELS) is not None:
                errors.append(f"claim {idx}: pod {p.key()} incompatible with claim requirements")
            err = taints_tolerate_pod(nc.template.taints, p, include_prefer_no_schedule=True)
            if err is not None:
                errors.append(f"claim {idx}: pod {p.key()} {err}")

    for en in results.existing_nodes:
        if not en.pods:
            continue
        for r, q in en.remaining_resources.items():
            if q.milli < 0:
                errors.append(f"existing node {en.name()}: over-committed {r}")
                break

    # host ports: per placement target, pairwise conflict check from the pod
    # OBJECTS (independent of the tensor path's port masks)
    from ..scheduling.hostports import HostPortUsage, pod_host_ports

    for idx, nc in enumerate(results.new_node_claims):
        # a fresh node opens with its daemon group's reserved ports
        # (scheduler.py _compute_daemon_overhead_groups seeding); the claim is
        # sound if SOME group consistent with its remaining instance types
        # accepts every pod's ports
        groups = [
            g
            for g in getattr(nc, "daemon_overhead_groups", [])
            if any(it in nc.instance_type_options for it in g.instance_types)
        ] or [None]
        ok_any, last_err = False, None
        for g in groups:
            usage = g.host_port_usage.copy() if g is not None else HostPortUsage()
            err = None
            for p in nc.pods:
                ports = pod_host_ports(p)
                err = usage.conflicts(p.key(), ports)
                if err is not None:
                    break
                usage.add(p.key(), ports)
            if err is None:
                ok_any = True
                break
            last_err = err
        if not ok_any:
            errors.append(f"claim {idx}: {last_err}")
    for en in results.existing_nodes:
        if not en.pods:
            continue
        usage = en.state_node.host_port_usage.copy()
        for p in en.pods:
            ports = pod_host_ports(p)
            err = usage.conflicts(p.key(), ports)
            if err is not None:
                errors.append(f"existing node {en.name()}: {err}")
                break
            usage.add(p.key(), ports)

    # topology: spread skew and anti-affinity over the final placement, for
    # ANY topology key — a new claim's domain for a key is the single value
    # its requirements pin (None while uncommitted); an existing node's is
    # its label
    def claim_domain(nc, key):
        r = nc.requirements.get(key)
        return r.any() if len(r.values) == 1 else None

    placements = []  # (pod, domain_lookup, host)
    for nc in results.new_node_claims:
        dom = (lambda nc_: lambda key: claim_domain(nc_, key))(nc)
        for p in nc.pods:
            placements.append((p, dom, id(nc)))
    for en in results.existing_nodes:
        labels = en.state_node.labels()
        dom = (lambda lbls: lambda key: lbls.get(key))(labels)
        for p in en.pods:
            placements.append((p, dom, en.name()))
        # include already-bound pods for counting
        for key in en.state_node.pod_requests:
            ns, name = key.split("/", 1)
            pod = snap.store.try_get("Pod", name, ns)
            if pod is not None:
                placements.append((pod, dom, en.name()))

    from ..controllers.provisioning.scheduling.topology import effective_spread_selector

    for pod in snap.pods:
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.when_unsatisfiable != "DoNotSchedule":
                continue
            eff_sel = effective_spread_selector(pod, tsc)
            counts = defaultdict(int)
            for q, dom, host in placements:
                if q.metadata.namespace != pod.metadata.namespace:
                    continue
                if not match_label_selector(eff_sel, q.metadata.labels):
                    continue
                domain = host if tsc.topology_key == wk.HOSTNAME_LABEL_KEY else dom(tsc.topology_key)
                if domain is not None:
                    counts[domain] += 1
            if counts and tsc.topology_key != wk.HOSTNAME_LABEL_KEY:
                skew = max(counts.values()) - min(counts.values())
                if skew > tsc.max_skew:
                    errors.append(
                        f"pod {pod.key()}: {tsc.topology_key} skew {skew} > {tsc.max_skew} ({dict(counts)})"
                    )
        aff = pod.spec.affinity
        if aff is not None:
            for term in aff.pod_anti_affinity_required:
                my = next(((dom, h) for q, dom, h in placements if q.key() == pod.key()), None)
                if my is None:
                    continue
                if term.topology_key == wk.HOSTNAME_LABEL_KEY:
                    same_domain = lambda dom, host: host == my[1]  # noqa: E731
                else:
                    mine = my[0](term.topology_key)
                    same_domain = (
                        (lambda dom, host: dom(term.topology_key) == mine) if mine is not None else (lambda dom, host: False)
                    )
                for q, dom, host in placements:
                    if q.key() == pod.key() or not same_domain(dom, host):
                        continue
                    if q.metadata.namespace == pod.metadata.namespace and match_label_selector(term.label_selector, q.metadata.labels):
                        errors.append(
                            f"pod {pod.key()}: {term.topology_key} anti-affinity violated with {q.key()}"
                        )
    return errors
