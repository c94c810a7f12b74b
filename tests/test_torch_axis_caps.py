"""The port's plain arms against the JAX reference on problems past every
axis limit its CUDA kernels once had, on the CPU.

The kernels K2 (grouped pack), K8 (per-pod pack), K5 (globalpack), K6
(subset scores) and K7 (anneal) used to refuse R > 16 resources, more than
256 (K8: 64) groups, 32 (K5/K6: 64) ranks or classes, 32 domain values,
restricted keys or host ports, and Np past K7's shared-memory sums. The
reference pads every axis with no ceiling. These problems are past those
limits, and the plain versions (which the kernels are held to on the card,
in `chip_smoke.py`'s `caps` phase) must give the reference's outputs:

- `caps_groups`: 264 topology groups (252 hostname-spread, 12 zone-spread),
  one pod each; the grouped pack and the per-pod pack;
- `caps_wide`: 39 custom topology keys beside the zone (Kd = 40, D past
  80 domain values), 36 node pools (Q = 36 ranks), 40 distinct host ports
  (P1 = 40, P2 = 20), 16 extended resources (R = 20), pods restricted to
  keys past the 32nd; the grouped pack and the per-pod pack;
- `caps_lp` / `caps_anneal`: a synthetic consolidation round with R = 20
  and 70 classes (Qp = 128), run through the reference's proposers: K6 and
  K7 bit-equal, the LP proposals identical. K5's d is not within 2e-6 of
  JAX's here: the reference's unplaced hinge sits at a rounding-noise kink
  (ROADMAP Queue 3 item 2); that test is a strict xfail. The reference
  does not define d there either: `caps_lp_alt.npz` holds its d and
  proposals from the same inputs under
  `XLA_FLAGS=--xla_cpu_multi_thread_eigen=false` (single-threaded Eigen
  contractions, another float32 summation order), 3.0e-8 from the stored d
  after 1 step, 2.0e-4 after 5 and 2.9e-2 after 300, with the same
  proposals. The contract on this round is the proposals.

The JAX reference is slow to compile at these widths (minutes per problem),
so its outputs are stored in `karpenter_tpu_torch/fixtures/caps/`, written
by `JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python
tests/test_torch_axis_caps.py --write`. The tests here check that a fresh
encode (or synthetic round) equals the stored problem, then run the port's
plain arms against the stored JAX outputs. `--write-alt` writes
`caps_lp_alt.npz` alone (~15 s; `--write` writes it too).
"""

from __future__ import annotations

import functools
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import synthetic_round  # noqa: E402
from helpers import make_nodepool, make_pod  # noqa: E402
from karpenter_tpu.apis import labels as wk  # noqa: E402
from karpenter_tpu.kube.objects import PodAffinityTerm  # noqa: E402
from karpenter_tpu.utils.quantity import Quantity  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model_grouped as tsg  # noqa: E402
from karpenter_tpu_torch.solver import consolidation as tcons  # noqa: E402
from karpenter_tpu_torch.solver.check import fast_validate  # noqa: E402
from karpenter_tpu_torch.solver.encoded import from_reference, problem_arrays  # noqa: E402
from karpenter_tpu_torch.solver.encoded import load_npz as load_problem  # noqa: E402
from test_torch_fixtures import FIXTURE_DIR, STATE_LEAVES  # noqa: E402

# the plain scan is thousands of tiny ops: one intra-op thread per test worker
torch.set_num_threads(1)

CAPS_DIR = FIXTURE_DIR / "caps"
PACKS = ("caps_groups", "caps_wide")
ROUNDS = {"caps_lp": "lp", "caps_anneal": "anneal"}
PERPOD_OUTPUTS = ("assignment", "slot_basis", "slot_domset", "slot_rank", "open_count")
D_TOL = 2e-6  # K5's d against JAX's: float64 sums rounded once vs XLA:CPU's float32 order

KEYS = [f"topo.example.com/k{i:02d}" for i in range(39)]
EXT = [f"example.com/dev{i:02d}" for i in range(16)]
ZONES = ["test-zone-a", "test-zone-b", "test-zone-c"]
LINUX_OD = [
    {"key": wk.OS_LABEL_KEY, "operator": "In", "values": [wk.OS_LINUX]},
    {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": [wk.ARCH_AMD64]},
    {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_ON_DEMAND]},
]


def _sel(**kv):
    return {"matchLabels": kv}


def _spread(key, app):
    from test_domain_topology import spread

    return spread(key, 1, _sel(app=app))


def _types(ext: bool):
    from karpenter_tpu.cloudprovider import catalog

    out = []
    for cpu in (4, 16):
        it = catalog.make_instance_type("c", cpu, zones=ZONES)
        if ext:
            for k in EXT:
                it.capacity[k] = Quantity.parse(8)
        out.append(it)
    return out


def _caps_groups():
    """264 groups: 252 hostname-spread replica sets and 12 zone-spread ones,
    one pod each (G = 264 > 256, the grouped kernel's old limit; > 64, the
    per-pod kernel's)."""
    from test_domain_topology import make_snapshot

    pods = [make_pod(cpu="250m", labels={"app": f"h{g:03d}"}, tsc=[_spread(wk.HOSTNAME_LABEL_KEY, f"h{g:03d}")])
            for g in range(252)]
    pods += [make_pod(cpu="500m", labels={"app": f"z{g:02d}"}, tsc=[_spread(wk.ZONE_LABEL_KEY, f"z{g:02d}")])
             for g in range(12)]
    return make_snapshot(pods, node_pools=[make_nodepool(requirements=LINUX_OD)], types=_types(False))


def _caps_wide():
    """Kd = 40 dom keys (the zone and 39 custom keys, each labelled by every
    pool: D past 80 with the per-key sentinels), Q = 36 pools, 40 host ports
    (20 on a specific IP), R = 20 (16 extended resources), pods restricted
    by node selector to keys past the 32nd, anti-affinity and affinity over
    a custom key."""
    from test_domain_topology import anti, make_snapshot

    pools = [make_nodepool(name=f"pool-{p:02d}", requirements=LINUX_OD, weight=p,
                           labels={k: f"v{(p + i) % 2}" for i, k in enumerate(KEYS)}) for p in range(36)]
    pods = []
    # three replica sets spread over 13 custom keys each: the keys become dom keys
    for s in range(3):
        app = f"spread{s}"
        tsc = [_spread(k, app) for k in KEYS[13 * s:13 * (s + 1)]]
        pods += [make_pod(cpu="500m", labels={"app": app}, tsc=tsc) for _ in range(2)]
    for i in range(40):
        p = make_pod(cpu="100m")
        port = {"containerPort": 9000 + i, "hostPort": 9000 + i, "protocol": "TCP"}
        if i % 2:
            port["hostIP"] = "10.0.0.1"
        p.spec.containers[0].ports = [port]
        pods.append(p)
    for i, k in enumerate(EXT):
        p = make_pod(cpu="500m")
        p.spec.containers[0].resources["requests"][k] = Quantity.parse(1 + i % 3)
        pods.append(p)
    pods += [make_pod(cpu="1", node_selector={KEYS[38 - i]: f"v{i % 2}"}) for i in range(6)]
    pods += [make_pod(cpu="1", labels={"app": "anti"}, anti_affinity=[anti(_sel(app="anti"), KEYS[37])])
             for _ in range(2)]
    pods += [make_pod(cpu="1", labels={"app": "aff"},
                      pod_affinity=[PodAffinityTerm(label_selector=_sel(app="aff"), topology_key=KEYS[36])])
             for _ in range(2)]
    return make_snapshot(pods, node_pools=pools, types=_types(True))


SNAPSHOTS = {"caps_groups": _caps_groups, "caps_wide": _caps_wide}


def caps_snapshot(name: str):
    """The snapshot with deterministic pod uids (the FFD queue breaks ties by uid)."""
    snap = SNAPSHOTS[name]()
    for i, pod in enumerate(snap.pods):
        pod.metadata.uid = f"00000000-0000-4000-8000-{i:012d}"
    return snap


def _encode(name: str):
    from karpenter_tpu.models import scheduler_model as jsm
    from karpenter_tpu.solver.encode import encode

    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    return encode(caps_snapshot(name))


def _stored(name: str) -> dict:
    return _stored_path(CAPS_DIR / f"{name}.npz")


def _stored_path(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _widths(name: str) -> dict:
    problem, _ref = load_problem(CAPS_DIR / f"{name}.npz")
    tsm.reset_bucket_highwater()
    t = tsm.make_tensors(problem, "cpu")
    arrays, _pods = tsg.build_items(problem)
    return dict(R=arrays["item_req"].shape[1], G=t.counts_dom_init.shape[0], D=t.counts_dom_init.shape[1],
                Q=t.rank_domset.shape[0], Kd=arrays["item_restrict"].shape[1], P1=arrays["item_port_any"].shape[1],
                P2=arrays["item_port_spec"].shape[1])


@pytest.mark.parametrize("name", PACKS)
def test_fixture_is_past_the_old_limits_and_matches_a_fresh_encode(name):
    """Each stored problem equals a fresh encode of its snapshot, and is past
    the old kernel limits it stands for."""
    stored, _ref = load_problem(CAPS_DIR / f"{name}.npz")
    fresh, kept = problem_arrays(from_reference(_encode(name))), problem_arrays(stored)
    for key in fresh:
        if key != "pod_keys":
            np.testing.assert_array_equal(fresh[key], kept[key], err_msg=f"{name}: {key}")
    w = _widths(name)
    if name == "caps_groups":
        assert w["G"] > 256
    else:
        assert w["R"] > 16 and w["D"] > 64 and w["Q"] > 32 and w["Kd"] > 32 and w["P1"] > 32 and w["P2"] > 16, w


@pytest.mark.parametrize("name", PACKS)
def test_grouped_pack_plain_equals_reference(name):
    """The plain grouped pack (K2's plain version) and sparsify give the
    stored JAX flat output and final carry, element for element."""
    problem, ref = load_problem(CAPS_DIR / f"{name}.npz")
    tsm.reset_bucket_highwater()
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, "cpu")
    n_slots = int(ref["ref_n_slots"])
    t = tsm.make_tensors(problem, "cpu", n_slots=n_slots)
    takes, left, state = tsg._pack_body(t, items, n_slots=n_slots)
    flat = tsg._flat_outputs(takes, left, state[0], state[2], state[6], int(ref["ref_nnz_cap"]))
    np.testing.assert_array_equal(flat.numpy(), ref["ref_flat"], err_msg=f"{name}: flat")
    leaves = list(state[:7]) + list(state[7])
    for leaf, x in zip(STATE_LEAVES, leaves):
        np.testing.assert_array_equal(x.numpy(), ref[f"ref_state_{leaf}"], err_msg=f"{name}: {leaf}")


@pytest.mark.parametrize("name", PACKS)
def test_perpod_pack_plain_equals_reference(name):
    """The plain per-pod pack (K8's plain version) gives the stored JAX
    outputs and the reference's validation errors."""
    problem, _ref = load_problem(CAPS_DIR / f"{name}.npz")
    ref = _stored(f"{name}_perpod")
    tsm.reset_bucket_highwater()
    got = tsm.greedy_pack_encoded(problem, device="cpu")
    for k, a in zip(PERPOD_OUTPUTS, got):
        np.testing.assert_array_equal(a.numpy(), ref[f"ref_{k}"], err_msg=f"{name}: {k}")
    assert fast_validate(problem, *(x.numpy() for x in got[:3])) == list(ref["ref_errors"])


def test_round_fixtures_match_a_fresh_synthetic_round():
    for name in ROUNDS:
        problem, _ref = tcons.load_npz(CAPS_DIR / f"{name}.npz")
        fresh = tcons.ConsolidationProblem.from_reference(synthetic_round()).arrays()
        for key, v in problem.arrays().items():
            np.testing.assert_array_equal(v, fresh[key], err_msg=f"{name}: {key}")
        assert problem.node_used.shape[1] == 20 and problem.n_classes == 70


def _lp_case():
    problem, ref = tcons.load_npz(CAPS_DIR / "caps_lp.npz")
    t, aux = tcons.tensors_from_problem(problem, "cpu")
    assert aux["onehot"].shape[1] == 128
    return problem, ref, t, aux


def test_score_subsets_plain_equals_reference():
    """K6's plain scores and flags on the reference's rounded rows are
    bit-equal to JAX's (R = 20, Qp = 128)."""
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets_plain

    _problem, ref, t, aux = _lp_case()
    X = torch.as_tensor(ref["ref_X"])
    s, f = score_subsets_plain(t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"],
                               aux["pend_active"], X)
    np.testing.assert_array_equal(s.numpy(), ref["ref_scores"])
    np.testing.assert_array_equal(f.numpy(), ref["ref_feas"])


@pytest.mark.xfail(strict=True, reason=(
    "Queue 3 item 2, shown: after the projection every class's route total is 1 up to rounding, so the "
    "unplaced hinge max(1 - route, 0) and its gradient 0/0.5/1 turn on summation noise (u = +-1.19e-7 or 0 "
    "on 122 of the 1024 (init, class) entries at the first step here); Adam's normalised step amplifies the "
    "different gradient: K5's plain d is 3.0e-8 from JAX's after 1 step, 0.084 after 5, 0.124 after 300. "
    "The reference itself moves by 2.9e-2 there after 300 steps (2.0e-4 after 5) under "
    "XLA_FLAGS=--xla_cpu_multi_thread_eigen=false, with the same proposals (caps_lp_alt.npz, "
    "test_reference_d_is_not_defined_on_caps_lp)"))
def test_globalpack_plain_d_within_tolerance_of_reference():
    """K5's plain ascent from the stored JAX inits: d within D_TOL of JAX's
    after 1, 5 and 300 steps."""
    from karpenter_tpu_torch.kernels.globalpack import globalpack_plain

    problem, ref, t, aux = _lp_case()
    d0, y0 = (torch.as_tensor(a) for a in tcons.reference_inits(problem, ref))
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
    for n_iters, key in ((1, "ref_d_it1"), (5, "ref_d_it5"), (int(ref["ref_n_iters"]), "ref_d")):
        d, _score = globalpack_plain(*args, n_iters)
        assert float(np.abs(d.numpy() - ref[key]).max()) <= D_TOL, (n_iters, key)


@functools.lru_cache(maxsize=1)
def _port_lp_proposals():
    problem, ref, _t, _aux = _lp_case()
    return tcons.propose_problem_lp(problem, "cpu", inits=tcons.reference_inits(problem, ref))


def test_lp_proposals_equal_reference():
    """The port's LP proposer from the stored JAX inits gives the JAX
    proposals (the rounding ladder absorbs the d gap above here)."""
    _problem, ref, _t, _aux = _lp_case()
    assert _port_lp_proposals() == tcons.reference_proposals(ref)


def test_reference_d_is_not_defined_on_caps_lp():
    """The reference's two XLA:CPU settings (`caps_lp.npz`, the default; and
    `caps_lp_alt.npz`, single-threaded Eigen) run from the same inputs give
    d more than D_TOL apart after 5 steps, and the same proposals, which the
    port's equal. So on this round the parity K5 owes is the proposals."""
    _problem, ref, _t, _aux = _lp_case()
    alt = _stored("caps_lp_alt")
    gap = {n: float(np.abs(alt[f"ref_alt_d{n}"] - ref[f"ref_d{n}"]).max()) for n in ("_it1", "_it5", "")}
    assert gap["_it5"] > D_TOL and gap[""] > D_TOL, gap
    alt_proposals = tcons.reference_proposals({"ref_proposals": alt["ref_alt_proposals"],
                                               "ref_proposal_lens": alt["ref_alt_proposal_lens"]})
    assert alt_proposals == tcons.reference_proposals(ref)
    assert _port_lp_proposals() == alt_proposals


def test_alt_record_matches_a_fresh_run(tmp_path):
    """`caps_lp_alt.npz` equals a fresh reference run under the other
    setting (its own process: XLA reads the flag when it starts)."""
    from test_torch_consolidation_fixtures import run_alt

    run_alt(CAPS_DIR / "caps_lp.npz", tmp_path / "alt.npz")
    fresh, stored = _stored_path(tmp_path / "alt.npz"), _stored("caps_lp_alt")
    assert set(fresh) == set(stored)
    for k in stored:
        np.testing.assert_array_equal(fresh[k], stored[k], err_msg=k)


def test_anneal_plain_equals_reference():
    """K7's plain chains on the stored JAX streams: best_x and best_s
    bit-equal to JAX's."""
    from karpenter_tpu_torch.kernels.anneal import anneal_plain

    problem, ref = tcons.load_npz(CAPS_DIR / "caps_anneal.npz")
    t, _aux = tcons.tensors_from_problem(problem, "cpu", dense_compat=True)
    streams = [torch.as_tensor(ref[k]) for k in ("ref_x0", "ref_flips", "ref_u")]
    bx, bs = anneal_plain(t, *streams)
    np.testing.assert_array_equal(bx.numpy(), ref["ref_best_x"])
    np.testing.assert_array_equal(bs.numpy(), ref["ref_best_s"])


def write_all(names=None) -> None:
    """Write `fixtures/caps/<name>.npz` (JAX on the CPU: minutes per problem)."""
    import jax

    from karpenter_tpu_torch.solver.encoded import save_npz
    from test_torch_consolidation_fixtures import reference_run
    from test_torch_fixtures import reference_solve
    from test_torch_perpod import OUTPUTS, reference_perpod

    import karpenter_tpu.solver.consolidation as jcons

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    CAPS_DIR.mkdir(parents=True, exist_ok=True)
    for name in PACKS:
        if names and name not in names:
            continue
        enc = _encode(name)
        p = from_reference(enc)
        ref = reference_solve(enc)
        save_npz(CAPS_DIR / f"{name}.npz", p, **ref)
        out, errors = reference_perpod(enc)
        per = {f"ref_{k}": np.asarray(v) for k, v in zip(OUTPUTS, out)}
        per["ref_errors"] = np.asarray(errors, dtype=np.str_).reshape(-1)
        np.savez_compressed(CAPS_DIR / f"{name}_perpod.npz", **per)
        print(name, p.n_pods, "pods", _widths(name), int(ref["ref_open_count"]), "open;", "per-pod",
              int((out[0] >= 0).sum()), "placed", len(errors), "errors", file=sys.stderr)
    for name, kind in ROUNDS.items():
        if names and name not in names:
            continue
        v = synthetic_round()
        with mock.patch.object(jcons, "_candidate_vectors", lambda *a, **k: v):
            problem, ref = reference_run(kind, list(range(len(v["node_price"]))), [], [])
        tcons.save_npz(CAPS_DIR / f"{name}.npz", problem, **ref)
        print(name, problem.n, "nodes", problem.n_classes, "classes", len(ref["ref_proposal_lens"]), "proposals",
              file=sys.stderr)
    if not names or "caps_lp" in names:
        write_alt()


def write_alt() -> None:
    """Write `caps_lp_alt.npz`: the reference's d and proposals on the stored
    `caps_lp` under the other XLA:CPU setting."""
    from test_torch_consolidation_fixtures import run_alt

    run_alt(CAPS_DIR / "caps_lp.npz", CAPS_DIR / "caps_lp_alt.npz")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_all([a for a in sys.argv[1:] if a != "--write"])
    elif "--write-alt" in sys.argv:
        write_alt()
    else:
        print(__doc__)
