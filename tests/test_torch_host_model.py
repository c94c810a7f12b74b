"""The port's host object model against the reference's, on the CPU.

Seeded cases drawn with numpy go through the same functions of both
packages: the `Requirements` algebra (built from node-selector terms over
well-known, custom and integer keys with every operator, then `compatible`,
`intersects`, `intersection`, `labels`, `has` and `Requirement.any`),
`Quantity` parsing and arithmetic, `resources` sums and fits,
`taints_tolerate_pod` and `HostPortUsage`. Every result (values, error
messages, exception types) must be equal. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.apis import labels as ref_wk
from karpenter_tpu.kube import objects as ref_objects
from karpenter_tpu.scheduling import hostports as ref_hostports
from karpenter_tpu.scheduling import requirements as ref_requirements
from karpenter_tpu.scheduling import taints as ref_taints
from karpenter_tpu.utils import quantity as ref_quantity
from karpenter_tpu.utils import resources as ref_resources
from karpenter_tpu_torch.apis import labels as port_wk
from karpenter_tpu_torch.kube import objects as port_objects
from karpenter_tpu_torch.scheduling import hostports as port_hostports
from karpenter_tpu_torch.scheduling import requirements as port_requirements
from karpenter_tpu_torch.scheduling import taints as port_taints
from karpenter_tpu_torch.utils import quantity as port_quantity
from karpenter_tpu_torch.utils import resources as port_resources

SEEDS = range(6)
REF = dict(wk=ref_wk, objects=ref_objects, hostports=ref_hostports, requirements=ref_requirements,
           taints=ref_taints, quantity=ref_quantity, resources=ref_resources)
PORT = dict(wk=port_wk, objects=port_objects, hostports=port_hostports, requirements=port_requirements,
            taints=port_taints, quantity=port_quantity, resources=port_resources)


def outcome(fn, *args):
    """fn(*args), or the exception's type name and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the exception is the result compared
        return ("raised", type(e).__name__, str(e))


def both(case):
    """`case(modules)` run against each package."""
    return case(REF), case(PORT)


# -- Requirements ----------------------------------------------------------------

KEYS = ("topology.kubernetes.io/zone", "karpenter.sh/capacity-type", "node.kubernetes.io/instance-type",
        "example.com/team", "example.com/gpu-count", "kubernetes.io/arch")
VALUES = ("a", "b", "c", "test-zone-a", "test-zone-b", "spot", "on-demand", "amd64", "1", "2", "8", "16")
OPERATORS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")


def draw_terms(rng: np.random.Generator) -> list:
    terms = []
    for _ in range(int(rng.integers(0, 5))):
        key = KEYS[int(rng.integers(len(KEYS)))]
        op = OPERATORS[int(rng.integers(len(OPERATORS)))]
        if op in ("Gt", "Lt"):
            values = [str(int(rng.integers(-2, 20)))]
        elif op in ("In", "NotIn"):
            values = sorted({VALUES[int(i)] for i in rng.integers(len(VALUES), size=int(rng.integers(1, 4)))})
        else:
            values = []
        term = {"key": key, "operator": op, "values": values}
        if rng.random() < 0.2:
            term["minValues"] = int(rng.integers(1, 3))
        terms.append(term)
    return terms


def req_state(reqs) -> list:
    return sorted((r.key, r.complement, sorted(r.values), r.gte, r.lte, r.min_values) for r in reqs.values())


@pytest.mark.parametrize("seed", SEEDS)
def test_requirements_algebra_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pairs = [(draw_terms(rng), draw_terms(rng)) for _ in range(60)]
    probes = [(KEYS[int(rng.integers(len(KEYS)))], VALUES[int(rng.integers(len(VALUES)))]) for _ in range(20)]

    def case(m):
        R = m["requirements"].Requirements
        out = []
        for ta, tb in pairs:
            a = outcome(R.from_node_selector_terms, ta)
            b = outcome(R.from_node_selector_terms, tb)
            if a[0] != "ok" or b[0] != "ok":
                out.append((a if a[0] != "ok" else None, b if b[0] != "ok" else None))
                continue
            a, b = a[1], b[1]
            inter = outcome(a.intersection, b)
            out.append((
                req_state(a), req_state(b),
                a.compatible(b), a.intersects(b), b.compatible(a, allow_undefined=m["wk"].WELL_KNOWN_LABELS),
                req_state(inter[1]) if inter[0] == "ok" else inter,
                outcome(a.labels), a.has_min_values(),
                [(k, a.has(k), a.get(k).has(v), len(a.get(k))) for k, v in probes],
                [a.get(k).any() for k in sorted(a.keys()) if a.get(k).operator().value == "In"],
            ))
        return out

    want, got = both(case)
    assert got == want


# -- Quantity and resources ------------------------------------------------------

NUMBERS = ("0", "1", "2", "7", "100", "250", "1.5", "0.5", "3.25", "1e3", "12e-1", ".5")
SUFFIXES = ("", "m", "k", "M", "G", "Ki", "Mi", "Gi", "Ti", "n", "u", "x")


@pytest.mark.parametrize("seed", SEEDS)
def test_quantity_matches_reference(seed):
    rng = np.random.default_rng(seed)
    texts = [NUMBERS[int(rng.integers(len(NUMBERS)))] + SUFFIXES[int(rng.integers(len(SUFFIXES)))]
             for _ in range(120)]
    scalars = [int(v) for v in rng.integers(-3, 4, size=20)] + [float(v) for v in rng.random(10)]

    def case(m):
        Q = m["quantity"].Quantity
        qs = [outcome(Q.parse, t) for t in texts]
        ok = [q[1] for q in qs if q[0] == "ok"]
        out = [(q[0], q[1].milli, str(q[1]), q[1].value, q[1].as_float()) if q[0] == "ok" else q for q in qs]
        for x, y in zip(ok, ok[1:] + ok[:1]):
            out.append(((x + y).milli, (x - y).milli, x < y, x == y, bool(x), str(x - y)))
        for x, k in zip(ok, scalars):
            out.append(outcome(lambda: (x * k).milli))
        out.append([outcome(Q.parse, v).__repr__() for v in (3, 2.5, "  4Gi ")])
        return out

    want, got = both(case)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_resources_match_reference(seed):
    rng = np.random.default_rng(seed)
    names = ("cpu", "memory", "pods", "nvidia.com/gpu")
    lists = [{names[int(i)]: f"{int(rng.integers(0, 9000))}{('m', 'Mi', '')[int(rng.integers(3))]}"
              for i in rng.integers(len(names), size=int(rng.integers(0, 4)))} for _ in range(40)]

    def case(m):
        r = m["resources"]
        parsed = [r.parse_resource_list(d) for d in lists]
        out = []
        for a, b in zip(parsed, parsed[1:]):
            out.append((r.fmt(r.merge(a, b)), r.fmt(r.subtract(a, b)), r.fits(a, b), r.any_exceeds(a, b),
                        r.cmp_resources(a, b), r.fmt(r.max_resources(a, b)), r.is_zero(a), r.to_float_dict(a)))
        return out

    want, got = both(case)
    assert got == want


# -- taints and host ports -------------------------------------------------------

EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
TAINT_KEYS = ("dedicated", "gpu", "example.com/special", "node.kubernetes.io/not-ready")


@pytest.mark.parametrize("seed", SEEDS)
def test_taints_tolerate_pod_matches_reference(seed):
    rng = np.random.default_rng(seed)

    def draw_taint():
        return dict(key=TAINT_KEYS[int(rng.integers(len(TAINT_KEYS)))], effect=EFFECTS[int(rng.integers(3))],
                    value=("", "x", "y")[int(rng.integers(3))])

    def draw_toleration():
        tol = {"key": ("",) + TAINT_KEYS, "operator": ("Equal", "Exists"), "value": ("", "x", "y"),
               "effect": ("",) + EFFECTS}
        return {k: v[int(rng.integers(len(v)))] for k, v in tol.items()}

    cases = [([draw_taint() for _ in range(int(rng.integers(0, 4)))],
              [draw_toleration() for _ in range(int(rng.integers(0, 4)))]) for _ in range(80)]

    def case(m):
        t, o = m["taints"], m["objects"]
        out = []
        for taints, tols in cases:
            pod = o.Pod(metadata=o.ObjectMeta(name="p"), spec=o.PodSpec(tolerations=list(tols)))
            ts = [t.Taint(**d) for d in taints]
            out.append((t.taints_tolerate_pod(ts, pod), t.taints_tolerate_pod(ts, pod, include_prefer_no_schedule=True),
                        [t.is_known_ephemeral_taint(x) for x in ts]))
        return out

    want, got = both(case)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_host_port_usage_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(40):
        ports = [{"containerPort": 80, "hostPort": int((0, 80, 443, 8080)[int(rng.integers(4))]),
                  "hostIP": ("", "0.0.0.0", "10.0.0.1", "10.0.0.2")[int(rng.integers(4))],
                  "protocol": ("TCP", "UDP")[int(rng.integers(2))]} for _ in range(int(rng.integers(0, 3)))]
        pods.append((f"default/p{i}", ports, bool(rng.random() < 0.2)))

    def case(m):
        o, h = m["objects"], m["hostports"]
        usage, out = h.HostPortUsage(), []
        for key, ports, remove in pods:
            pod = o.Pod(metadata=o.ObjectMeta(name=key.split("/")[1]),
                        spec=o.PodSpec(containers=[o.Container(ports=list(ports))]))
            hp = h.pod_host_ports(pod)
            err = usage.conflicts(key, hp)
            if err is None:
                usage.add(key, hp)
            if remove:
                usage.remove(key)
            out.append(([(p.ip, p.port, p.protocol) for p in hp], err,
                        sorted((p.ip, p.port, p.protocol) for p in usage.copy().all_ports())))
        return out

    want, got = both(case)
    assert got == want
