"""The serving scenarios the card's run and its fixture share: the headline
churn (`bench.py`'s `bench_churn_sustained(5000, 32)` scale, the record half
with `concurrent_seconds=0`), the multi-tenant fleet (`bench.py`'s fleet
scale: 1250 base pods a tenant, churn rates / 40) and the drivers that
record each solve's mode and the placement digest after every bind flush.

The drivers take an `api` namespace (`port_api()` here; the fixture writer
builds the reference's from the same names), so one scenario runs on either
package.
"""

from __future__ import annotations

import types

HEADLINE = dict(n_base_pods=5000, n_types=100, arrivals=800, cancels=600, departures=800, bind_every=4,
                iterations=32, concurrent_seconds=0.0, seed=0)
FLEET_TENANTS = 4
FLEET = dict(n_base_pods=1250, n_types=100, arrivals=20, cancels=15, departures=20, bind_every=4, iterations=8,
             concurrent_seconds=0.0)

# the report fields that no wall clock enters (a run without the concurrent
# segment and with the prestager synchronous)
REPORT_FIELDS = ("events", "solves", "modes", "delta_hit_rate", "full_solve_reasons", "pods_per_solve_p50", "n_nodes",
                 "n_pending_end", "e2e_events", "faults_injected", "recoveries", "revoked_nodes", "prestage_reused",
                 "prestage_staged", "coalesced_triggers")


def port_api(device=None) -> types.SimpleNamespace:
    """The port's serving entry points, the GPU solver on `device`."""
    from ..cloudprovider.fake import instance_types_assorted
    from ..operator.options import Options
    from ..serving import ChurnHarness, ChurnSpec, FleetFrontend, placement_digest

    return types.SimpleNamespace(
        ChurnSpec=ChurnSpec, Options=Options, instance_types_assorted=instance_types_assorted, backend="gpu",
        placement_digest=placement_digest,
        harness=lambda spec: ChurnHarness(spec, device=device),
        fleet=lambda: FleetFrontend(device=device),
    )


def report_fields(rep) -> dict:
    d = rep.as_dict()
    return {k: d[k] for k in REPORT_FIELDS}


def solve_modes(harness) -> list[str]:
    """The mode of every provisioning solve the harness's recorder holds."""
    return [t.mode for t in harness.recorder.traces() if t.mode not in ("", "consolidate")]


def run_recorded(api, harness) -> dict:
    """`harness.run()` with the placement digest taken after every bind
    flush: {"modes", "digests", "report"} (the report's wall-clock-free
    fields) and the report itself under "_report"."""
    digests = []
    real = harness.bind_flush

    def bind_flush():
        real()
        digests.append(api.placement_digest(harness.env))

    harness.bind_flush = bind_flush
    try:
        rep = harness.run()
    finally:
        del harness.bind_flush
    return {"modes": solve_modes(harness), "digests": digests, "report": report_fields(rep), "_report": rep}


def revoke_and_repack(api, harness) -> dict:
    """Revoke the first node (by name) and compute the global repack's
    savings over the shrunken fleet (`repack_savings("global")`)."""
    names = sorted(n.metadata.name for n in harness.env.store.borrow_list("Node"))
    events = harness.revoke_node(names[0])
    savings = harness.repack_savings(mode="global")
    return {"revoked_events": events, "savings": round(float(savings), 6),
            "digest": api.placement_digest(harness.env)}


def headline_spec(api, **overrides):
    return api.ChurnSpec(**{**HEADLINE, **overrides})


def fleet_spec(api, tenant: int, **overrides):
    return api.ChurnSpec(**{**FLEET, "seed": tenant, **overrides})


def run_fleet(api, fleet, log_dir=None) -> dict:
    """FLEET_TENANTS tenants on `fleet` (`fleet-0`.., which a ring of two
    shards splits two and two), each a harness attached through the
    fleet's DRR pump (no serve thread), run one after another; with
    `log_dir`, each tenant's event log is recorded as `<tenant>.jsonl`
    (replayable by a shard router). Returns {tenant: run_recorded(...)}."""
    import os

    out = {}
    for i in range(FLEET_TENANTS):
        tid = f"fleet-{i}"
        record = os.path.join(log_dir, f"{tid}.jsonl") if log_dir else None
        spec = fleet_spec(api, i, record_path=record)
        sess = fleet.add_tenant(tid, options=api.Options(solver_backend=api.backend,
                                                         batch_idle_duration=spec.batch_idle_seconds,
                                                         batch_max_duration=10.0),
                                instance_types=api.instance_types_assorted(spec.n_types))
        h = api.harness(spec).attach(sess, fleet=fleet)
        out[tid] = run_recorded(api, h)
    return out


def fresh_state() -> None:
    """The port's module state a scenario run starts from: the claim
    hostname counter from 1, the encoder's process-global caches, the
    bucket high-water marks and the tenant labels emptied."""
    import itertools

    from ..controllers.provisioning.scheduling import nodeclaim
    from ..models.scheduler_model import reset_bucket_highwater
    from ..serving.fleet import reset_tenant_labels
    from ..solver.encode import clear_encode_globals

    nodeclaim._hostname_seq = itertools.count(1)
    clear_encode_globals()
    reset_bucket_highwater()
    reset_tenant_labels()
