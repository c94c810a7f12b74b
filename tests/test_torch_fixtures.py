"""Fixtures of the PyTorch port: encoded problems with the JAX pack's outputs.

Each `karpenter_tpu_torch/fixtures/<name>.npz` holds an `EncodedProblem`
(written by `save_npz`) plus the reference outputs of the JAX path on it:
the pack's flat int32 output, the assignment, the open count and every leaf
of the scan's final carry (`ref_*` arrays). The CPU tests and
`chip_smoke.py` read them; the chip machine has no JAX.

The corpus: the headline problem (`bench.build_snapshot(5000, 100)`), its
required-affinity variant (`affinity_frac=0.1`) and small encodes built with
`tests/helpers.py` that together reach all five pack branches, the joint
multi-group water-fill, existing nodes holding host ports, inverse
anti-affinity blocked slots and minDomains.

Chain fixtures (`fixtures/chains/<name>.npz`, written by `save_chain`) hold
a sequence of problems solved by the JAX `TPUSolver(force=True)`: a full
solve, then mutations of the pod list that the reference serves on its
delta path (or rejects, for a recorded reason). Each later problem carries
its delta (from the solver's `encode_cache.last_enc`); per step the file
holds the inputs and output carry of each recredit (`s<i>.rc_*`), the input
carry, flat output and final carry of each delta pack (`s<i>.dp_*`), and
after the step the reference's mode, delta-reject reason and resident
carry, assignment, basis and zoneset (`s<i>.ref_*`). The chains together
reach every branch of the reference's `_solve_delta_inner`.

The tests below rebuild every fixture with the JAX encoder and pack on the
CPU and require it equal to the committed file, array by array (pod names
aside: they come from a process-global counter). Regenerate the files with

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_fixtures.py --write [name ...]
"""

from __future__ import annotations

import itertools
import os
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from helpers import hostname_anti_affinity, make_pod, zone_spread  # noqa: E402
from karpenter_tpu.apis import labels as wk  # noqa: E402
from karpenter_tpu.kube.objects import PodAffinityTerm  # noqa: E402
from karpenter_tpu_torch.solver.encoded import (  # noqa: E402
    chain_arrays,
    delta_of_reference,
    from_reference,
    load_npz,
    problem_arrays,
    save_chain,
    save_npz,
)

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "karpenter_tpu_torch" / "fixtures"
CHAIN_DIR = FIXTURE_DIR / "chains"
STATE_LEAVES = ("slot_basis", "slot_rem", "slot_zoneset", "slot_rank", "counts_zone", "counts_host", "open_count",
                "port_any", "port_wild", "port_spec")
ZONE = wk.ZONE_LABEL_KEY
HOST = wk.HOSTNAME_LABEL_KEY


def _sel(**kv):
    return {"matchLabels": kv}


def _ported(pod, port=8080):
    pod.spec.containers[0].ports = [{"containerPort": port, "hostPort": port, "protocol": "TCP"}]
    return pod


def _aff(key, labels):
    return PodAffinityTerm(label_selector={"matchLabels": dict(labels)}, topology_key=key)


def _spread_anti_ports():
    """simple, zone-spread and zone-anti items, plus host-ported replicas."""
    from test_domain_topology import anti, make_snapshot

    web = [make_pod(cpu=c, labels={"app": "web"}, tsc=[zone_spread(1, _sel(app="web"))]) for c in ("1", "1", "2", "2", "500m") * 3]
    db = [make_pod(cpu="1", labels={"app": "db"}, anti_affinity=[anti(_sel(app="db"), ZONE)]) for _ in range(4)]
    plain = [make_pod(cpu=c, memory="1Gi") for c in ("250m", "3", "7", "1500m") * 4]
    ported = [_ported(make_pod(cpu="500m")) for _ in range(5)]
    return make_snapshot(web + db + plain + ported)


def _multigroup():
    """replica sets that are members of two zone-spread groups: the joint
    multi-group water-fill."""
    from test_domain_topology import make_snapshot, spread

    pods = []
    for g, (n, tier) in enumerate(((7, "front"), (5, "front"), (9, "back"))):
        tsc = [spread(ZONE, 1, _sel(app=f"g{g}")), spread(ZONE, 2, _sel(tier=tier))]
        pods += [make_pod(cpu="500m", labels={"app": f"g{g}", "tier": tier}, tsc=tsc) for _ in range(n)]
    pods += [_ported(make_pod(cpu="250m", labels={"app": "g9", "tier": "back"},
                              tsc=[spread(ZONE, 1, _sel(app="g9")), spread(ZONE, 2, _sel(tier="back"))])) for _ in range(3)]
    return make_snapshot(pods)


def _affinity():
    """required pod affinity over zone (bootstrap one domain) and hostname
    (bootstrap one host), beside plain pods."""
    from test_domain_topology import make_snapshot

    zl, hl = {"aff": "z"}, {"aff": "h"}
    pods = [make_pod(cpu="1", labels=dict(zl), pod_affinity=[_aff(ZONE, zl)]) for _ in range(6)]
    pods += [make_pod(cpu="500m", labels=dict(hl), pod_affinity=[_aff(HOST, hl)]) for _ in range(4)]
    pods += [make_pod(cpu="2") for _ in range(3)]
    return make_snapshot(pods)


def _existing_cluster(**kw):
    from test_pod_affinity_tpu import existing_cluster

    return existing_cluster(**kw)


def _snapshot(store, clock, cluster, np_, pending, types=None):
    from test_pod_affinity_tpu import snapshot_of

    return snapshot_of(store, clock, cluster, np_, pending, types)


def _existing_ports_inverse():
    """existing nodes: one holds a running host-ported pod, one a running pod
    whose hostname anti-affinity blocks the pending web pods."""
    store, clock, cluster, np_ = _existing_cluster(nodes=(("na", "test-zone-a"), ("nb", "test-zone-b"), ("nc", "test-zone-c")), node_cpu="8")
    holder = _ported(make_pod(cpu="100m", name="port-holder"))
    holder.spec.node_name = "nb"
    store.create(holder)
    runner = make_pod(cpu="100m", name="runner", labels={"sentinel": "y"},
                      anti_affinity=[PodAffinityTerm(label_selector=_sel(app="web"), topology_key=HOST)])
    runner.spec.node_name = "na"
    store.create(runner)
    pending = [make_pod(cpu="1", labels={"app": "web"}) for _ in range(10)]
    pending += [_ported(make_pod(cpu="500m")) for _ in range(4)]
    pending += [make_pod(cpu="3") for _ in range(3)]
    return _snapshot(store, clock, cluster, np_, pending)


def _existing_affinity():
    """recorded affinity: running pods pin a zone and a host that pending
    affinity replicas must join; hostname spread beside them."""
    store, clock, cluster, np_ = _existing_cluster(node_cpu="16")
    zl, hl = {"aff": "z"}, {"aff": "h"}
    for name, labels, node in (("rz", zl, "nb"), ("rh", hl, "na")):
        runner = make_pod(cpu="100m", name=name, labels=dict(labels))
        runner.spec.node_name = node
        store.create(runner)
    from test_domain_topology import spread

    pending = [make_pod(cpu="2", labels=dict(zl), pod_affinity=[_aff(ZONE, zl)]) for _ in range(5)]
    pending += [make_pod(cpu="1", labels=dict(hl), pod_affinity=[_aff(HOST, hl)]) for _ in range(3)]
    pending += [make_pod(cpu="500m", labels={"app": "hs"}, tsc=[spread(HOST, 2, _sel(app="hs"))]) for _ in range(6)]
    return _snapshot(store, clock, cluster, np_, pending)


def _min_domains_hostname():
    """zone spread with unmet minDomains (force-zero minimum), hostname
    anti-affinity and hostname spread."""
    from test_domain_topology import make_snapshot, spread

    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[spread(ZONE, 2, _sel(app="w"), min_domains=6)]) for _ in range(9)]
    pods += [make_pod(cpu="500m", labels={"app": "h"}, anti_affinity=[hostname_anti_affinity(_sel(app="h"))]) for _ in range(5)]
    pods += [make_pod(cpu="750m", labels={"app": "s"}, tsc=[spread(HOST, 1, _sel(app="s"))]) for _ in range(4)]
    return make_snapshot(pods)


def _existing_fleet(n_nodes: int):
    """A fleet of `n_nodes` existing 4-cpu nodes over the three zones and 300
    pending pods: plain pods of five sizes, zone-spread and hostname-spread
    replicas, host-ported pods, pods pinned by hostname to nodes past the
    first 1024, and pods too large for any existing node (fresh slots open
    past the fleet). Every existing node is an open slot from the start, so
    the pack's active slot range exceeds 1024 slots from its first item."""
    from test_domain_topology import spread

    zones = ("test-zone-a", "test-zone-b", "test-zone-c")
    nodes = tuple((f"n{k:04d}", zones[k % 3]) for k in range(n_nodes))
    store, clock, cluster, np_ = _existing_cluster(nodes=nodes, node_cpu="4")
    pending = [make_pod(cpu=c, memory="1Gi") for c in ("250m", "1", "2", "3", "500m") * 30]
    pending += [make_pod(cpu="1", labels={"app": "web"}, tsc=[zone_spread(1, _sel(app="web"))]) for _ in range(80)]
    pending += [make_pod(cpu="500m", labels={"app": "hs"}, tsc=[spread(HOST, 1, _sel(app="hs"))]) for _ in range(30)]
    pending += [_ported(make_pod(cpu="250m")) for _ in range(20)]
    pending += [make_pod(cpu="1", node_selector={HOST: f"n{k:04d}"}) for k in range(1030, 1200, 17)]
    pending += [make_pod(cpu="6", memory="2Gi") for _ in range(10)]
    return _snapshot(store, clock, cluster, np_, pending)


def _headline(affinity_frac=0.0):
    def build():
        import bench

        return bench.build_snapshot(5000, 100, affinity_frac=affinity_frac)

    return build


CORPUS = {
    "small_spread_anti_ports": _spread_anti_ports,
    "small_multigroup": _multigroup,
    "small_affinity": _affinity,
    "small_existing_ports_inverse": _existing_ports_inverse,
    "small_existing_affinity": _existing_affinity,
    "small_min_domains_hostname": _min_domains_hostname,
    "existing_fleet_1200": lambda: _existing_fleet(1200),
    "existing_fleet_3800": lambda: _existing_fleet(3800),
    "headline_5000x100": _headline(),
    "headline_aff_5000x100": _headline(0.1),
}


def reference_solve(enc) -> dict:
    """The JAX path on one encode, the way the solver runs it: items, slot-
    capped tensors, the fused pack (retried uncapped on overflow), the
    assignment. Returns the `ref_*` arrays."""
    from karpenter_tpu.models.scheduler_model import make_tensors
    from karpenter_tpu.models.scheduler_model_grouped import (
        _next_pow2,
        _pack_compressed_impl,
        _parse_flat,
        assignment_from_triples,
        build_items,
        make_item_tensors,
    )

    arrays, item_pods = build_items(enc)
    items = make_item_tensors(arrays)
    W = arrays["item_count"].shape[0]

    def pack(n_slots):
        t = make_tensors(enc, n_slots=n_slots, with_pods=False)
        nnz_cap = int(min(_next_pow2(enc.n_pods), W * t.n_slots))
        flat, state = _pack_compressed_impl(t, items, t.dom_keys, t.n_slots, nnz_cap)
        flat = np.asarray(flat)
        return t, nnz_cap, flat, state, _parse_flat(flat, nnz_cap, t.n_slots, t.counts_dom_init.shape[1], W)

    cap = enc.n_existing + min(enc.n_pods, 4096)
    t, nnz_cap, flat, state, out = pack(cap)
    if out["open_count"] == t.n_slots and int(out["leftovers"].sum()) > 0 and cap < enc.n_existing + enc.n_pods:
        t, nnz_cap, flat, state, out = pack(None)
    assignment = assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], item_pods, enc.n_pods)
    leaves = list(state[:7]) + list(state[7])
    ref = {f"ref_state_{name}": np.asarray(x) for name, x in zip(STATE_LEAVES, leaves)}
    ref.update(ref_flat=flat, ref_assignment=assignment, ref_open_count=np.int64(out["open_count"]),
               ref_nnz_cap=np.int64(nnz_cap), ref_n_slots=np.int64(t.n_slots))
    return ref


def corpus_snapshot(name: str):
    """The corpus entry's snapshot with deterministic pod uids: the FFD
    queue breaks ties by uid, which the builders draw at random."""
    snap = CORPUS[name]()
    for i, pod in enumerate(snap.pods):
        pod.metadata.uid = f"00000000-0000-4000-8000-{i:012d}"
    return snap


def build_fixture(name: str):
    """(EncodedProblem, ref arrays) of one corpus entry, from scratch."""
    from karpenter_tpu.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu.solver.encode import encode

    reset_bucket_highwater()
    enc = encode(corpus_snapshot(name))
    return from_reference(enc), reference_solve(enc)


# -- delta chains ----------------------------------------------------------------

def _pin_uids(pods, tag: int) -> None:
    """Deterministic uids (the FFD queue breaks ties by uid)."""
    for i, pod in enumerate(pods):
        pod.metadata.uid = f"00000000-0000-4000-{tag:04x}-{i:012d}"


def _two_spreads(app="g0", tier="front", cpu="500m"):
    """A member of two zone-spread groups (a multi-group shape)."""
    from test_domain_topology import spread

    return make_pod(cpu=cpu, labels={"app": app, "tier": tier},
                    tsc=[spread(ZONE, 1, _sel(app=app)), spread(ZONE, 2, _sel(tier=tier))])


def _chain_small_members():
    """Removals of a zone-spread member (counts_zone recredit), hostname anti
    and spread members (counts_host), a host-ported pod (port planes
    rebuilt) and a keyed zone-anti member (anti recount); appends of known
    shapes and of a never-seen shape; then an identical resubmit."""
    from test_domain_topology import anti, make_snapshot, spread

    web = [make_pod(cpu=c, labels={"app": "web"}, tsc=[zone_spread(1, _sel(app="web"))]) for c in ("1", "500m") * 6]
    hanti = [make_pod(cpu="500m", labels={"app": "h"}, anti_affinity=[hostname_anti_affinity(_sel(app="h"))])
             for _ in range(4)]
    hspread = [make_pod(cpu="750m", labels={"app": "s"}, tsc=[spread(HOST, 1, _sel(app="s"))]) for _ in range(4)]
    zanti = [make_pod(cpu="1", labels={"app": "db"}, anti_affinity=[anti(_sel(app="db"), ZONE)],
                      node_selector={ZONE: f"test-zone-{z}"}) for z in "abc"]
    ported = [_ported(make_pod(cpu="500m")) for _ in range(3)]
    plain = [make_pod(cpu=c, memory="1Gi") for c in ("250m", "3", "1500m") * 2]
    pods = web + hanti + hspread + zanti + ported + plain
    _pin_uids(pods, 0x8000)
    snap = make_snapshot(pods)
    yield snap
    # step 1: a web, a hostname-anti and a hostname-spread member leave; a
    # web replica and two plain pods arrive
    for pod in (web[0], hanti[1], hspread[2]):
        snap.pods.remove(pod)
    arrivals = [make_pod(cpu="1", labels={"app": "web"}, tsc=[zone_spread(1, _sel(app="web"))]),
                make_pod(cpu="250m", memory="1Gi"), make_pod(cpu="3", memory="1Gi")]
    _pin_uids(arrivals, 0x8001)
    snap.pods.extend(arrivals)
    yield snap
    # step 2: a ported pod and a zone-anti member leave; a never-seen shape
    # and a ported replica arrive
    for pod in (ported[0], zanti[2]):
        snap.pods.remove(pod)
    arrivals = [make_pod(cpu="619m", memory="153Mi"), _ported(make_pod(cpu="500m"))]
    _pin_uids(arrivals, 0x8002)
    snap.pods.extend(arrivals)
    yield snap
    # step 3: an identical resubmit
    yield snap


def _chain_small_irreversible():
    """A removal touching required zone pod affinity: the reference rejects
    it as irreversible and packs in full; a later append continues from
    that full solve's carry; then a plain removal."""
    from test_domain_topology import make_snapshot

    zl, hl = {"aff": "z"}, {"aff": "h"}
    zaff = [make_pod(cpu="1", labels=dict(zl), pod_affinity=[_aff(ZONE, zl)]) for _ in range(4)]
    haff = [make_pod(cpu="500m", labels=dict(hl), pod_affinity=[_aff(HOST, hl)]) for _ in range(3)]
    plain = [make_pod(cpu=c) for c in ("2", "1", "2")]
    pods = zaff + haff + plain
    _pin_uids(pods, 0x8100)
    snap = make_snapshot(pods)
    yield snap
    snap.pods.remove(zaff[1])
    yield snap
    arrivals = [make_pod(cpu="1"), make_pod(cpu="2")]
    _pin_uids(arrivals, 0x8101)
    snap.pods.extend(arrivals)
    yield snap
    snap.pods.remove(plain[0])
    yield snap


def _chain_small_demoted():
    """Multi-group shapes with the multi-group merge switched off
    (`KARPENTER_SOLVER_MULTIGROUP=0`, the one demotion the encoder lets
    through): each pod is its own item. A member of both spread groups
    leaves (its spread counts recredited at one committed domain) and
    demoted replicas arrive (one delta item per pod)."""
    from test_domain_topology import make_snapshot

    front = [_two_spreads("g0", "front") for _ in range(5)] + [_two_spreads("g1", "front", "250m") for _ in range(3)]
    back = [_two_spreads("g2", "back", "1") for _ in range(4)]
    plain = [make_pod(cpu=c) for c in ("1", "2")]
    pods = front + back + plain
    _pin_uids(pods, 0x8500)
    snap = make_snapshot(pods)
    yield snap
    snap.pods.remove(front[2])
    arrivals = [_two_spreads("g0", "front") for _ in range(3)] + [_two_spreads("g2", "back", "1")]
    _pin_uids(arrivals, 0x8501)
    snap.pods.extend(arrivals)
    yield snap


def _chain_small_bind_flush():
    """Bind flushes over existing nodes: pending pods bind and the solver
    sees them leave while the existing rows refresh (capacity, zone and
    hostname counts, host ports). The first flush binds pods where the last
    solve did not put them and fails the reference's validation; the later
    ones bind pods where it put them, beside appends, and stay deltas.
    (Each step receives the previous solve's results.)"""
    import copy

    from test_domain_topology import spread

    store, clock, cluster, np_ = _existing_cluster(
        nodes=(("na", "test-zone-a"), ("nb", "test-zone-b"), ("nc", "test-zone-c")), node_cpu="16")
    hs = [make_pod(cpu="500m", labels={"app": "hs"}, tsc=[spread(HOST, 2, _sel(app="hs"))]) for _ in range(6)]
    web = [make_pod(cpu="1", labels={"app": "web"}, tsc=[zone_spread(1, _sel(app="web"))]) for _ in range(6)]
    ported = [_ported(make_pod(cpu="250m")) for _ in range(2)]
    plain = [make_pod(cpu=c, memory="2Gi") for c in ("2", "1", "4", "500m")]
    pending = hs + web + ported + plain
    _pin_uids(pending, 0x8200)
    snap = _snapshot(store, clock, cluster, np_, pending)
    types = snap.instance_types[np_.metadata.name]  # one catalog: the row key holds its identity

    def bind(pods, nodes):
        for pod, node in zip(pods, nodes):
            bound = copy.deepcopy(pod)
            bound.spec.node_name = node
            store.create(bound)
            pending.remove(pod)

    def where(results, pods):
        at = {id(q): en.state_node.name() for en in results.existing_nodes for q in en.pods}
        return [at[id(q)] for q in pods]

    results = yield snap
    bind([hs[0], web[1], plain[1]], ("nc", "nc", "na"))
    results = yield _snapshot(store, clock, cluster, np_, pending, types)
    chosen = [ported[0], hs[2], web[3]]
    bind(chosen, where(results, chosen))
    arrivals = [make_pod(cpu="500m", labels={"app": "hs"}, tsc=[spread(HOST, 2, _sel(app="hs"))]), make_pod(cpu="1")]
    _pin_uids(arrivals, 0x8201)
    pending.extend(arrivals)
    results = yield _snapshot(store, clock, cluster, np_, pending, types)
    chosen = [plain[2], web[4]]
    bind(chosen, where(results, chosen))
    yield _snapshot(store, clock, cluster, np_, pending, types)


def _chain_small_slot_exhausted():
    """An append of hostname anti-affinity replicas that needs more slots
    than the resident slot axis holds: the reference rejects it as
    slot-exhausted and packs in full on a wider axis."""
    from test_domain_topology import make_snapshot

    plain = [make_pod(cpu=c, memory="256Mi") for c in ("100m", "200m") * 100]
    solo = [make_pod(cpu="100m", labels={"app": "solo"}, anti_affinity=[hostname_anti_affinity(_sel(app="solo"))])
            for _ in range(10)]
    pods = plain + solo
    _pin_uids(pods, 0x8300)
    snap = make_snapshot(pods)
    yield snap
    arrivals = [make_pod(cpu="100m", labels={"app": "solo"}, anti_affinity=[hostname_anti_affinity(_sel(app="solo"))])
                for _ in range(505)]
    _pin_uids(arrivals, 0x8301)
    snap.pods.extend(arrivals)
    yield snap


def _chain_churn_headline():
    """The churn deployment of the serving loop (`ChurnSpec` defaults) as the
    solver sees it: the 5000-pod headline base, then per step 800 arrivals
    drawn from the base's own pod shapes and 600 cancellations, 480 of this
    step's arrivals (never seen by the solver) and 120 of the oldest pending
    pods (placed: real recredits). Step 2 adds a few never-seen shapes
    (signature growth); step 3 is an identical resubmit."""
    import copy

    import bench

    snap = bench.build_snapshot(5000, 100)
    _pin_uids(snap.pods, 0x8400)
    shapes = list(snap.pods)
    yield snap
    rng = np.random.default_rng(0)
    for step in (1, 2):
        arrivals = []
        for i, k in enumerate(rng.integers(0, len(shapes), 800)):
            pod = copy.deepcopy(shapes[int(k)])
            pod.metadata.name = f"churn-{step}-{i}"
            arrivals.append(pod)
        if step == 2:
            for i, (cpu, mem) in enumerate((("617m", "151Mi"), ("1234m", "777Mi"), ("3333m", "2222Mi"))):
                arrivals[10 * i] = make_pod(cpu=cpu, memory=mem, name=f"churn-{step}-new-{i}")
        _pin_uids(arrivals, 0x8400 + step)
        del snap.pods[:120]
        snap.pods.extend(arrivals[:320])
        yield snap
    yield snap


CHAINS = {
    "chain_small_members": _chain_small_members,
    "chain_small_irreversible": _chain_small_irreversible,
    "chain_small_demoted": _chain_small_demoted,
    "chain_small_bind_flush": _chain_small_bind_flush,
    "chain_small_slot_exhausted": _chain_small_slot_exhausted,
    "churn_headline_5000x100": _chain_churn_headline,
}
# environment a chain is built and replayed under (stored in its file as
# `env`, "NAME=value" strings)
CHAIN_ENV = {"chain_small_demoted": {"KARPENTER_SOLVER_MULTIGROUP": "0"}}


def _leaves(prefix: str, state) -> dict:
    leaves = list(state[:7]) + list(state[7])
    return {f"{prefix}_{name}": np.asarray(x) for name, x in zip(STATE_LEAVES, leaves)}


def build_chain(name: str):
    """(problems, ref arrays) of one chain: the JAX `TPUSolver(force=True)`
    solves each step; its recredits and delta packs are recorded through
    wrappers around the module functions it calls."""
    from unittest import mock

    import karpenter_tpu.models.scheduler_model_grouped as jsg
    from karpenter_tpu.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu.solver import tpu as jtpu
    from karpenter_tpu.solver.tpu import TPUSolver

    reset_bucket_highwater()
    cur: dict = {}
    reasons: list = []
    bases: list = []
    real_recredit, real_delta = jsg.recredit_removals, jsg.greedy_pack_delta_compressed
    real_impl, real_note, real_encode = jsg._pack_delta_compressed_impl, TPUSolver._note_delta_reject, jtpu.encode

    def recredit(state, t, slot_idx, req, zmem, hmem):
        out = real_recredit(state, t, slot_idx, req, zmem, hmem)
        cur.update(rc_slot_idx=np.asarray(slot_idx), rc_req=np.asarray(req), rc_zmem=np.asarray(zmem),
                   rc_hmem=np.asarray(hmem), **_leaves("rc_in", state), **_leaves("rc_out", out))
        return out

    def delta_pack(state, t, items, n_added):
        out = real_delta(state, t, items, n_added)
        cur.update(dp_n_added=np.int64(n_added), dp_nnz_cap=np.int64(out["nnz_cap"]), **_leaves("dp_in", state),
                   **_leaves("dp_out", out["state"]))
        return out

    def impl(state, t, items, dom_keys, n_slots, nnz_cap):
        flat, st = real_impl(state, t, items, dom_keys, n_slots, nnz_cap)
        cur["dp_flat"] = np.asarray(flat)
        return flat, st

    def note(self, reason):
        reasons.append(reason)
        return real_note(self, reason)

    def encode(snap, cache=None):
        enc = real_encode(snap, cache=cache)
        bases.append(getattr(enc, "delta_base", None))
        return enc

    env = CHAIN_ENV.get(name, {})
    problems, encs = [], []
    ref = {"env": np.asarray([f"{k}={v}" for k, v in sorted(env.items())], dtype=np.str_).reshape(-1)}
    solver = TPUSolver(force=True)
    with mock.patch.dict(os.environ, env), mock.patch.object(jsg, "recredit_removals", recredit), \
            mock.patch.object(jsg, "greedy_pack_delta_compressed", delta_pack), \
            mock.patch.object(jsg, "_pack_delta_compressed_impl", impl), \
            mock.patch.object(TPUSolver, "_note_delta_reject", note), mock.patch.object(jtpu, "encode", encode):
        steps = CHAINS[name]()
        results = None
        for i in itertools.count():
            try:
                snap = steps.send(results)
            except StopIteration:
                break
            cur.clear()
            reasons.clear()
            results = solver.solve(snap)
            enc = solver.encode_cache.last_enc
            resident = solver._resident
            assert resident is not None and resident["enc"] is enc, f"{name} step {i}: the resident is not this encode"
            if encs and enc is encs[-1]:  # identical resubmit: the encode is its own base
                problem = replace(problems[-1], delta=delta_of_reference(enc, problems[-1]))
            else:
                base = bases[-1]
                assert base is None or base is encs[-1], f"{name} step {i}: delta base is not the previous encode"
                problem = from_reference(enc, base=problems[-1] if base is not None else None)
            problems.append(problem)
            encs.append(enc)
            pre = f"s{i}."
            ref.update({pre + k: v for k, v in cur.items()})
            ref.update({pre + k: v for k, v in _leaves("ref_state", resident["state"]).items()})
            ref.update({
                pre + "ref_mode": np.str_(solver.last_solve_mode),
                pre + "ref_reject": np.str_(reasons[-1] if reasons else ""),
                pre + "ref_assignment": np.asarray(resident["assignment"]),
                pre + "ref_slot_basis": np.asarray(resident["slot_basis"]),
                pre + "ref_slot_zoneset": np.asarray(resident["slot_zoneset"]),
                pre + "ref_open_count": np.int64(np.asarray(resident["state"][6])),
                pre + "ref_n_slots": np.int64(resident["t"].n_slots),
            })
    return problems, ref


def write_all(names=None) -> None:
    """Write the named fixtures and chains (all of them by default)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for name in CORPUS:
        if names and name not in names:
            continue
        problem, ref = build_fixture(name)
        save_npz(FIXTURE_DIR / f"{name}.npz", problem, **ref)
        print(name, problem.n_pods, "pods", int(ref["ref_open_count"]), "open", file=sys.stderr)
    CHAIN_DIR.mkdir(parents=True, exist_ok=True)
    for name in CHAINS:
        if names and name not in names:
            continue
        problems, ref = build_chain(name)
        save_chain(CHAIN_DIR / f"{name}.npz", problems, **ref)
        modes = [(str(ref[f"s{i}.ref_mode"]), str(ref[f"s{i}.ref_reject"])) for i in range(len(problems))]
        print(name, [p.n_pods for p in problems], "pods", modes, file=sys.stderr)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_fixture_matches_reference(name):
    """The committed fixture equals a fresh JAX encode + pack, array by
    array (pod names aside)."""
    problem, ref = build_fixture(name)
    stored, stored_ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    fresh = problem_arrays(problem)
    kept = problem_arrays(stored)
    assert set(fresh) == set(kept)
    for key in fresh:
        if key == "pod_keys":
            assert len(fresh[key]) == len(kept[key])
            continue
        assert fresh[key].dtype == kept[key].dtype, key
        np.testing.assert_array_equal(fresh[key], kept[key], err_msg=key)
    assert set(ref) == set(stored_ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]), stored_ref[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_fixture_matches_reference(name):
    """The committed chain equals a fresh run of the JAX solver over the
    same mutations, array by array (pod names aside)."""
    problems, ref = build_chain(name)
    fresh = {**chain_arrays(problems), **ref}
    with np.load(CHAIN_DIR / f"{name}.npz", allow_pickle=False) as z:
        stored = {k: z[k] for k in z.files}
    assert set(fresh) == set(stored)
    for key, want in stored.items():
        got = np.asarray(fresh[key])
        if key.endswith(".pod_keys"):
            assert len(got) == len(want), key
            continue
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_corpus_reaches_every_branch_and_shape():
    """Together the fixtures reach all five pack branches, the joint
    multi-group fill, existing host ports, inverse-anti blocks and
    minDomains."""
    from karpenter_tpu_torch.models.scheduler_model_grouped import build_items
    from karpenter_tpu_torch.solver.encoded import (
        KIND_DOM_AFF,
        KIND_DOM_ANTI,
        KIND_DOM_SPREAD,
        KIND_HOST_AFF,
    )

    branches, multi = set(), False
    ports = blocked = min_domains = False
    for name in CORPUS:
        p, _ = load_npz(FIXTURE_DIR / f"{name}.npz")
        arrays, _pods = build_items(p)
        kinds = np.concatenate([p.group_kind, np.full(arrays["item_member"].shape[1] - p.n_groups, -1)])
        for w in range(int((arrays["item_count"] > 0).sum())):
            mem = arrays["item_member"][w]
            zm = mem & np.isin(kinds, (KIND_DOM_SPREAD, KIND_DOM_ANTI, KIND_DOM_AFF))
            if (mem & (kinds == KIND_HOST_AFF)).any():
                branches.add(4)
            elif (zm & (kinds == KIND_DOM_AFF)).any():
                branches.add(3)
            elif (zm & (kinds == KIND_DOM_ANTI)).any():
                branches.add(2)
            elif zm.any():
                branches.add(1)
                multi |= int(zm.sum()) > 1
            else:
                branches.add(0)
        ports |= bool(p.existing_port_any.any())
        blocked |= bool(p.sig_host_blocked.any())
        min_domains |= bool((p.group_min_domains > 0).any())
    assert branches == {0, 1, 2, 3, 4}
    assert multi and ports and blocked and min_domains


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_all([a for a in sys.argv[1:] if a != "--write"])
    else:
        print(__doc__)
