"""Composed delta solves through `GPUSolver.solve` against the reference's
default `TPUSolver(force=True, recover=False)`, on the CPU: the scenarios of
`tests/test_delta_compose.py` (mixed add and remove batches, arrivals of
unseen pod shapes growing the signature axis, removals of ported, spread and
affinity pods, and every delta-reject reason the encoder gives).

Each runs as a chain of `tests/test_torch_hybrid_solve.py` (`Chain`): at
every step equal canonical `Results`, mode, backend, delta-reject reasons
(the solver's and the encoder's) and resident carry. Left out: the metric
counter, the recompile sentinel (JAX's) and the churn harness's row-refresh
cases (the serving loop is not ported).
"""

from __future__ import annotations

import random

import pytest
import torch

from helpers import make_pod, zone_spread
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.kube.objects import PodAffinityTerm
from karpenter_tpu.utils.quantity import Quantity
from karpenter_tpu_torch.solver.encode import DELTA_REJECT_REASONS
from test_solver import make_snapshot
from test_torch_hybrid_solve import Chain
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)

torch.set_num_threads(1)

SHAPES = [("250m", "512Mi"), ("500m", "512Mi"), ("500m", "1Gi"), ("1", "1Gi")]
NEW_SHAPES = [("311m", "413Mi"), ("613m", "217Mi"), ("911m", "1111Mi"), ("157m", "87Mi")]


def warm(pods) -> Chain:
    chain = Chain(make_snapshot(list(pods)), force=True)
    got = chain.step("warm")
    assert got["mode"] == "full" and not got["results"][2]
    return chain


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_randomized_mixed_new_shape_churn(seed):
    rng = random.Random(seed)
    chain = warm([make_pod(cpu=c, memory=m) for c, m in rng.choices(SHAPES, k=24)])
    fresh_pool = list(NEW_SHAPES)
    for i in range(4):
        for _ in range(rng.randrange(1, 4)):
            chain.ref.pods.pop(rng.randrange(len(chain.ref.pods)))
        for _ in range(rng.randrange(1, 4)):
            if fresh_pool and rng.random() < 0.5:
                c, m = fresh_pool.pop()  # a never-interned shape: growth
            else:
                c, m = rng.choice(SHAPES)
            chain.ref.pods.append(make_pod(cpu=c, memory=m))
        chain.step(f"churn {i}")
    assert chain.modes() == ["full"] + ["delta"] * 4


def test_grown_encoding_chains_as_next_delta_base():
    chain = warm([make_pod(cpu="500m") for _ in range(10)])
    chain.ref.pods.append(make_pod(cpu="313m", memory="209Mi"))
    chain.step("grown")
    chain.ref.pods.pop(0)
    chain.step("removal off the grown base")
    chain.ref.pods.append(make_pod(cpu="313m", memory="209Mi"))
    chain.step("the grown shape again")
    assert chain.modes() == ["full", "delta", "delta", "delta"]


def test_grown_spread_member_joins_existing_group():
    sel = {"app": "web"}
    chain = warm([make_pod(cpu="500m", labels=sel, tsc=[zone_spread(selector=sel)]) for _ in range(8)])
    chain.ref.pods.append(make_pod(cpu="433m", memory="333Mi", labels=sel, tsc=[zone_spread(selector=sel)]))
    chain.step("new shape, same group")
    assert chain.modes() == ["full", "delta"]


def test_new_group_identity_routes_full():
    chain = warm([make_pod(cpu="500m") for _ in range(6)])
    sel = {"matchLabels": {"app": "brand-new-spread"}}
    chain.ref.pods.append(make_pod(cpu="500m", labels={"app": "brand-new-spread"}, tsc=[zone_spread(selector=sel)]))
    got = chain.step("new group")
    assert got["mode"] == "full" and chain.gpu.encode_cache.last_delta_reject == "unseen-sig"


def test_ported_pod_churn():
    rng = random.Random(7)

    def ported(port):
        p = make_pod(cpu="500m")
        p.spec.containers[0].ports = [{"containerPort": port, "hostPort": port, "protocol": "TCP"}]
        return p

    pods = [make_pod(cpu="500m") for _ in range(8)] + [ported(8080) for _ in range(3)]
    rng.shuffle(pods)
    chain = warm(pods)
    chain.ref.pods.remove(next(p for p in chain.ref.pods if p.spec.containers[0].ports))
    chain.ref.pods.pop(0)
    chain.step("remove a ported and a plain pod")
    chain.ref.pods.append(ported(8080))
    chain.step("add a ported pod")
    assert chain.modes() == ["full", "delta", "delta"]


def test_spread_removal_then_refill():
    sel = {"app": "spread"}
    chain = warm([make_pod(cpu="500m", labels=sel, tsc=[zone_spread(selector=sel)]) for _ in range(12)])
    for _ in range(3):
        chain.ref.pods.pop(2)
    chain.step("remove")
    chain.ref.pods.extend(make_pod(cpu="500m", labels=sel, tsc=[zone_spread(selector=sel)]) for _ in range(3))
    got = chain.step("refill")
    assert len(got["placed"]) == 12


def test_dom_affinity_owner_removal_routes_full():
    sel = {"app": "aff"}
    term = PodAffinityTerm(label_selector=sel, topology_key=wk.ZONE_LABEL_KEY)
    chain = warm([make_pod(cpu="500m", labels=sel, pod_affinity=[term]) for _ in range(4)])
    chain.ref.pods.pop()
    got = chain.step("remove an affinity owner")
    assert (got["mode"], got["reject"]) == ("full", "irreversible")


def _pvc(chain):
    chain.ref.pods.append(make_pod(cpu="500m", volumes=[{"persistentVolumeClaim": {"claimName": "c1"}}]))


def _cap(chain):
    chain.ref.pods.extend(make_pod(cpu="500m") for _ in range(200))


def _reorder(chain):
    chain.ref.pods[0], chain.ref.pods[3] = chain.ref.pods[3], chain.ref.pods[0]


def _unseen(chain):
    odd = make_pod(cpu="500m")
    odd.spec.containers[0].resources["requests"]["vendor.example/gpu"] = Quantity.parse("1")
    chain.ref.pods.append(odd)


def _row_key(chain):
    chain.ref.pods.append(make_pod(cpu="500m"))
    name = chain.ref.node_pools[0].metadata.name
    chain.ref.instance_types[name] = chain.ref.instance_types[name][:-1]


REJECTS = {"pvc": _pvc, "cap": _cap, "reorder": _reorder, "unseen-sig": _unseen, "row-key": _row_key}


@pytest.mark.parametrize("reason", sorted(REJECTS))
def test_delta_reject_reason(reason):
    chain = warm([make_pod(cpu="500m") for _ in range(6)])
    REJECTS[reason](chain)
    got = chain.step(reason)
    # the encoder's reason; the solver's is the reference's too (equal at
    # every step): the full encoding is its own base, and the carry is not
    # keyed by it, so the solve notes "no-carry" after the encoder's reason
    assert chain.gpu.encode_cache.last_delta_reject == reason
    assert got["mode"] == "full"


def test_reject_reason_enum():
    from karpenter_tpu.solver.encode import DELTA_REJECT_REASONS as REF_REASONS

    assert DELTA_REJECT_REASONS == REF_REASONS
