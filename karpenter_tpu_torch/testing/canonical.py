"""Scheduler `Results` as plain, comparable data.

Read by attribute name, so it takes the port's `Results` and the
reference's alike (nothing of the reference is imported). Per new claim:
its nodepool, its sorted pod keys, its sorted instance-type names and its
requirements as (key, operator, sorted values, minValues, gte, lte), the
hostname requirement left out (its value is a placeholder drawn from a
process-global counter); per existing node: its name and its sorted pod
keys; every pod error, key and message. `canonical_node_claims` gives the
NodeClaims a provisioning pass created in a store the same way,
`canonical_allocation` a DRA allocator's committed allocations and claim
metadata, `canonical_command` a disruption `Command`, `canonical_store`
every object of a store and `canonical_operator` an operator
`Environment`'s state. Only tests and `chip_smoke.py` call this.
"""

from __future__ import annotations

import json

from ..apis import labels as wk


def _requirement(r) -> tuple:
    return (r.key, r.operator().value, tuple(sorted(r.values)), r.min_values, r.gte, r.lte)


def canonical_results(results) -> tuple:
    claims = sorted(
        (nc.nodepool_name, tuple(sorted(p.key() for p in nc.pods)),
         tuple(sorted(it.name for it in nc.instance_type_options)),
         tuple(sorted(_requirement(r) for r in nc.requirements.values() if r.key != wk.HOSTNAME_LABEL_KEY)))
        for nc in results.new_node_claims
    )
    existing = sorted((en.name(), tuple(sorted(p.key() for p in en.pods))) for en in results.existing_nodes)
    return tuple(claims), tuple(existing), tuple(sorted(results.pod_errors.items()))


def canonical_node_claims(store) -> tuple:
    """Every NodeClaim a store holds: its nodepool, its requirements as
    (key, operator, sorted values, minValues) without the hostname, and its
    resource requests in milli-units; sorted. Claim names are left out
    (their suffix is random)."""
    out = []
    for nc in store.list("NodeClaim"):
        reqs = tuple(sorted((d["key"], d["operator"], tuple(sorted(d.get("values") or ())), d.get("minValues"))
                            for d in nc.spec.requirements if d["key"] != wk.HOSTNAME_LABEL_KEY))
        resources = tuple(sorted((k, q.milli) for k, q in nc.spec.resources.items()))
        out.append((nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""), reqs, resources))
    return tuple(sorted(out))


def canonical_command(cmd) -> tuple:
    """A disruption `Command`: its reason, its candidates' node names in
    order, per replacement its nodepool, its instance-type names in the
    command's (price) order and its requirements without the hostname, and
    its simulation's canonical `Results` (None without one)."""
    replacements = tuple(
        (nc.nodepool_name, tuple(it.name for it in nc.instance_type_options),
         tuple(sorted(_requirement(r) for r in nc.requirements.values() if r.key != wk.HOSTNAME_LABEL_KEY)))
        for nc in cmd.replacements
    )
    results = canonical_results(cmd.results) if cmd.results is not None else None
    return cmd.reason, tuple(cmd.candidate_names()), replacements, results


def _milli(q: dict | None) -> tuple:
    return tuple(sorted((k, v.milli) for k, v in (q or {}).items()))


def canonical_allocation(allocator) -> tuple:
    """A DRA `Allocator`'s committed state: the claims' targets (claim key,
    node or in-flight NodeClaim), per claim its template-allocation metadata
    (`resource_claim_allocation_metadata()`: the NodeClaim, whether template
    devices served it, per instance type in order the requirements its
    devices contributed and its picks as (request, device id, consumed
    capacity), the pessimistic total), and the loop tracker's exclusive
    devices, consumed capacity and remaining counter budgets."""

    def reqs(r):
        return None if r is None else tuple(sorted(_requirement(x) for x in r.values()))

    def picks(ps):
        return tuple((name, tuple(ref.device_id), _milli(cap)) for name, ref, cap in ps)

    meta = tuple(
        (key, m.node_claim_id, m.used_template_devices, tuple((it, reqs(r)) for it, r in m.contributed.items()),
         tuple((it, picks(p)) for it, p in m.devices.items()), reqs(m.total))
        for key, m in sorted(allocator.resource_claim_allocation_metadata().items()))
    t = allocator.loop_tracker
    tracker = (tuple(sorted(t.exclusive)), tuple(sorted((d, _milli(c)) for d, c in t.consumed.items())),
               tuple(sorted((pk, tuple(sorted((cs, _milli(cn)) for cs, cn in sets.items())))
                            for pk, sets in t.remaining_counters.items())))
    return tuple(sorted(allocator.claim_targets.items())), meta, tracker


def _conditions(cs) -> tuple:
    items = cs.conditions if hasattr(cs, "conditions") else cs
    return tuple((c.type, c.status, c.reason, c.message, c.last_transition_time) for c in items)


def _store_rows(store, kind: str) -> tuple:
    out = []
    for o in store.list(kind):
        m = o.metadata
        row = (m.namespace, m.name, tuple(sorted(m.labels.items())), tuple(sorted(m.annotations.items())),
               tuple(m.finalizers), tuple((r.kind, r.name) for r in m.owner_references), m.creation_timestamp,
               m.deletion_timestamp, repr(o.spec))
        if kind == "Pod":
            row += (o.status.phase, o.status.nominated_node_name)
        else:
            row += (_conditions(o.status.conditions),)
        if kind == "NodeClaim":
            row += (o.status.provider_id, o.status.node_name)
        out.append(row)
    return tuple(sorted(out))


def canonical_store(store) -> tuple:
    """Every NodePool, NodeClaim, Node and Pod of a store, by kind and key:
    name, labels, annotations, finalizers, owners (kind and name), creation
    and deletion times, the spec as text and the status conditions (for a
    NodeClaim also its provider id and node name; for a Pod its phase).
    Uids and resource versions are left out."""
    return tuple((kind, _store_rows(store, kind)) for kind in ("NodePool", "NodeClaim", "Node", "Pod"))


# counters whose values are wall-clock readings (an event's end-to-end
# seconds against its SLO) or the port's own (kernel-library loads, where
# the reference counts JIT traces)
NOT_COUNTED = frozenset({"karpenter_solver_event_slo_breach_total", "karpenter_solver_recompile_total"})


def canonical_counters(registry) -> tuple:
    """Every counter of a metrics registry, by name and labels, sorted; a
    `backend` label of "gpu" reads as the reference's "tpu" (the same arm)
    and `NOT_COUNTED` is left out."""
    out = []
    with registry._lock:
        metrics = list(registry._metrics.values())
    for mt in metrics:
        if mt.TYPE != "counter" or mt.name in NOT_COUNTED:
            continue
        for labels, value in mt.collect():
            if labels.get("backend") == "gpu":
                labels = {**labels, "backend": "tpu"}
            out.append((mt.name, tuple(sorted(labels.items())), value))
    return tuple(sorted(out))


def canonical_operator(env) -> tuple:
    """An operator `Environment`'s state after a tick: its NodeClaims and
    Nodes (as `canonical_store` gives them), each pod's namespace, name and
    node, the event recorder's events and the registry's counters
    (`canonical_counters`)."""
    pods = tuple(sorted((p.metadata.namespace, p.metadata.name, p.spec.node_name) for p in env.store.list("Pod")))
    events = tuple((e.involved_kind, e.involved_name, e.type, e.reason, e.message, e.timestamp)
                   for e in env.recorder.events)
    return (_store_rows(env.store, "NodeClaim"), _store_rows(env.store, "Node"), pods, events,
            canonical_counters(env.registry))


def json_form(x):
    """`x` as it reads back from JSON (tuples become lists)."""
    return json.loads(json.dumps(x))
