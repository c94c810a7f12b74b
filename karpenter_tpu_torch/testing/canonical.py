"""Scheduler `Results` as plain, comparable data.

Read by attribute name, so it takes the port's `Results` and the
reference's alike (nothing of the reference is imported). Per new claim:
its nodepool, its sorted pod keys, its sorted instance-type names and its
requirements as (key, operator, sorted values, minValues, gte, lte), the
hostname requirement left out (its value is a placeholder drawn from a
process-global counter); per existing node: its name and its sorted pod
keys; every pod error, key and message. Only tests and `chip_smoke.py`
call this.
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


def json_form(x):
    """`x` as it reads back from JSON (tuples become lists)."""
    return json.loads(json.dumps(x))
