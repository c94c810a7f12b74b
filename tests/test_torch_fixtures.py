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

The test below rebuilds every fixture with the JAX encoder and pack on the
CPU and requires it equal to the committed file, array by array (pod names
aside: they come from a process-global counter). Regenerate the files with

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_fixtures.py --write
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from helpers import hostname_anti_affinity, make_pod, zone_spread  # noqa: E402
from karpenter_tpu.apis import labels as wk  # noqa: E402
from karpenter_tpu.kube.objects import PodAffinityTerm  # noqa: E402
from karpenter_tpu_torch.solver.encoded import from_reference, load_npz, problem_arrays, save_npz  # noqa: E402

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "karpenter_tpu_torch" / "fixtures"
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


def _snapshot(store, clock, cluster, np_, pending):
    from test_pod_affinity_tpu import snapshot_of

    return snapshot_of(store, clock, cluster, np_, pending)


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


def write_all() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for name in CORPUS:
        problem, ref = build_fixture(name)
        save_npz(FIXTURE_DIR / f"{name}.npz", problem, **ref)
        print(name, problem.n_pods, "pods", int(ref["ref_open_count"]), "open", file=sys.stderr)


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
        write_all()
    else:
        print(__doc__)
