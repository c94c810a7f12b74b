"""The meshed pack (`karpenter_tpu_torch/parallel/sharded.py`) against the
reference's `shard_map` pack, on the CPU.

`tests/test_sharded.py`'s cases carried through the port: each snapshot is
encoded by the reference and packed by the reference's
`greedy_pack_grouped_sharded_state` on `make_mesh(jax.devices()[:S])`
(`tests/conftest.py` makes the host 8 virtual devices) and by the port's on
`make_mesh(["cpu"] * S)` (the plain multi-shard arm: one thread per shard,
the exchanges in shard order), for S in {2, 3, 4, 5, 8}. Exact: takes,
leftovers, slot_basis, slot_zoneset, slot_rank, open_count and the gathered
final carry (floats bit for bit) equal the reference's, and the port's
single-device pack on the same padded tensors. Also: `dryrun_step`,
`anneal_sharded` per chain against the reference's on the same key and
against one device, `sharded_compat_matrix`, the sharded case of
`tests/test_domain_topology.py:507-522`, the meshed `GPUSolver` against the
reference's meshed `TPUSolver`, and the thread exchange's failure modes.
"""

from __future__ import annotations

import random
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from helpers import hostname_anti_affinity, make_pod, zone_spread
from test_domain_topology import make_snapshot as domain_snapshot
from test_domain_topology import spread
from test_sharded import existing_node_snapshot
from test_solver import make_snapshot
from test_torch_consolidation import load as cons_load
from test_torch_solve import assert_same, clear_globals, next_start, outcome, same_state
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.models.consolidation_model import ConsolidationTensors
from karpenter_tpu.models.scheduler_model_grouped import build_items as ref_build_items
from karpenter_tpu.models.scheduler_model_grouped import make_item_tensors as ref_make_item_tensors
from karpenter_tpu.parallel import sharded as jsh
from karpenter_tpu.solver.encode import encode
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models.scheduler_model_grouped import build_items, greedy_pack_grouped, make_item_tensors
from karpenter_tpu_torch.models import shard_exchange as sx
from karpenter_tpu_torch.parallel import sharded as sh
from karpenter_tpu_torch.solver.consolidation import tensors_from_problem
from karpenter_tpu_torch.solver.encoded import from_reference
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
from karpenter_tpu_torch.utils.prng import prng_key

torch.set_num_threads(1)

SHARDS = (2, 3, 4, 5, 8)
CARRY = ("slot_basis", "slot_rem", "slot_zoneset", "slot_rank", "counts_zone", "counts_host", "open_count",
         "port_any", "port_wild", "port_spec")
T_FIELDS = ("node_price", "node_cost", "node_slack", "node_used", "node_npods", "pod_compat", "row_alloc", "row_price")


@pytest.fixture(autouse=True)
def _fresh_buckets():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


def bits(x) -> np.ndarray:
    """A numpy copy whose floats compare bit for bit."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def leaves(state) -> list:
    return list(state[:7]) + list(state[7])


def assert_pack_equivalent(snap, n_dev: int):
    """The port's meshed pack of `snap` against the reference's on the same
    shard count, in every output and the gathered carry, and against the
    port's single-device pack on the same padded tensors. Returns the port's
    outputs."""
    enc = encode(snap)
    assert not enc.fallback_reasons, enc.fallback_reasons
    mesh_j = jsh.make_mesh(jax.devices()[:n_dev])
    ref_arrays, _ = ref_build_items(enc)
    jt = jsh.pad_slots_for_mesh(jsm.make_tensors(enc, with_pods=False), mesh_j)
    want = jsh.greedy_pack_grouped_sharded_state(jt, ref_make_item_tensors(ref_arrays), mesh_j)

    p = from_reference(enc)
    arrays, _ = build_items(p)
    items = make_item_tensors(arrays, "cpu")
    mesh = sh.make_mesh(["cpu"] * n_dev)
    t = sh.pad_slots_for_mesh(tsm.make_tensors(p, "cpu"), mesh)
    assert t.n_slots == jt.n_slots and t.n_slots % n_dev == 0
    got = sh.greedy_pack_grouped_sharded_state(t, items, mesh)
    for name, a, b in zip(sh.PACK_OUTPUTS, got[:6], want[:6]):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{name} (S={n_dev})")
    gathered = got[6].gather_state()
    for name, a, b in zip(CARRY, leaves(gathered), leaves(want[6])):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"carry {name} (S={n_dev})")
    single = greedy_pack_grouped(t, items)
    for name, a, b in zip(sh.PACK_OUTPUTS, got[:6], single):
        assert torch.equal(a, b), f"{name} differs from the port's single-device pack (S={n_dev})"
    return got


# -- tests/test_sharded.py TestShardedPackEquivalence -------------------------------


@pytest.mark.parametrize("n_dev", SHARDS)
def test_zone_spread_and_anti_affinity(n_dev):
    sel = {"matchLabels": {"app": "db"}}
    web = {"matchLabels": {"app": "web"}}
    pods = (
        [make_pod(cpu="500m", labels={"app": "db"}, tsc=[zone_spread(1, sel)], anti_affinity=[hostname_anti_affinity(sel)])
         for _ in range(6)]
        + [make_pod(cpu="1", labels={"app": "web"}, tsc=[zone_spread(2, web)]) for _ in range(17)]
        + [make_pod(cpu="2", memory="4Gi") for _ in range(9)]
    )
    got = assert_pack_equivalent(make_snapshot(pods), n_dev)
    assert int(got[1].sum()) == 0, "no leftovers expected"


@pytest.mark.parametrize("n_dev", (33,))
def test_plain_arm_past_one_warp_equals_reference_pack(n_dev):
    """Past the reference's eight CPU devices and past one warp's lanes (the
    slot-sharded K2's exchange reduces in strides of 32): the port's plain
    multi-shard arm at 33 shards (a thread each; 64 take twice as long
    here, the card's tests run both), on the zone-spread + anti-affinity
    snapshot, against the reference's single-device pack over the same
    padded slot axis (every output), and its gathered carry against the
    port's single-device carry, bit for bit."""
    from karpenter_tpu.models import scheduler_model_grouped as jsg
    from karpenter_tpu_torch.models.scheduler_model_grouped import _pack_body

    sel = {"matchLabels": {"app": "db"}}
    pods = ([make_pod(cpu="500m", labels={"app": "db"}, tsc=[zone_spread(1, sel)],
                      anti_affinity=[hostname_anti_affinity(sel)]) for _ in range(4)]
            + [make_pod(cpu="2", memory="4Gi") for _ in range(3)])
    enc = encode(make_snapshot(pods))
    p = from_reference(enc)
    arrays, _ = build_items(p)
    items = make_item_tensors(arrays, "cpu")
    mesh = sh.make_mesh(["cpu"] * n_dev)
    t = sh.pad_slots_for_mesh(tsm.make_tensors(p, "cpu"), mesh)
    assert t.n_slots % n_dev == 0
    got = sh.greedy_pack_grouped_sharded_state(t, items, mesh)
    ref_arrays, _ = ref_build_items(enc)
    # the reference's padding reads only the mesh's size
    jt = jsh.pad_slots_for_mesh(jsm.make_tensors(enc, with_pods=False), types.SimpleNamespace(size=n_dev))
    assert jt.n_slots == t.n_slots
    want = jsg.greedy_pack_grouped(jt, ref_make_item_tensors(ref_arrays))
    for name, a, b in zip(sh.PACK_OUTPUTS, got[:6], want):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{name} (S={n_dev})")
    compat, key = sh.sharded_feasibility(t, items, mesh)
    _takes, _left, one = _pack_body(t, items, n_slots=t.n_slots, precomputed=(compat, key))
    for name, a, b in zip(CARRY, leaves(got[6].gather_state()), leaves(one)):
        assert torch.equal(a, b), f"carry {name} (S={n_dev})"
    assert int(got[6].barrier) == n_dev * got[6].exchanges > 0


@pytest.mark.parametrize("n_dev", SHARDS)
def test_existing_nodes_span_shards(n_dev):
    types = [catalog.make_instance_type("c", 16, zones=["test-zone-a"])]
    sel = {"matchLabels": {"app": "db"}}
    pods = [make_pod(cpu="500m", labels={"app": "db"}, tsc=[zone_spread(50, sel)], anti_affinity=[hostname_anti_affinity(sel)])
            for _ in range(8)]
    assert_pack_equivalent(existing_node_snapshot(pods, types), n_dev)


@pytest.mark.parametrize("n_dev", SHARDS)
def test_mesh_sizes_and_padding(n_dev):
    sel = {"matchLabels": {"app": "w"}}
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, sel)]) for _ in range(13)]
    assert_pack_equivalent(make_snapshot(pods), n_dev)


@pytest.mark.parametrize("n_dev", SHARDS)
def test_random_fuzz_equivalence(n_dev):
    rng = random.Random(7)
    zones = ["test-zone-a", "test-zone-b", "test-zone-c"]
    for trial in range(4):
        pods = []
        sel = {"matchLabels": {"app": f"a{trial}"}}
        for _ in range(rng.randint(5, 40)):
            kind = rng.random()
            if kind < 0.3:
                pods.append(make_pod(cpu=f"{rng.randint(1, 4)}", labels={"app": f"a{trial}"},
                                     tsc=[zone_spread(rng.randint(1, 3), sel)]))
            elif kind < 0.5:
                pods.append(make_pod(cpu="500m", node_selector={wk.ZONE_LABEL_KEY: rng.choice(zones)}))
            else:
                pods.append(make_pod(cpu=f"{rng.randint(1, 7)}", memory=f"{rng.randint(1, 8)}Gi"))
        assert_pack_equivalent(make_snapshot(pods), n_dev)


@pytest.mark.parametrize("n_dev", SHARDS)
def test_host_ports_equivalent_sharded(n_dev):
    def ported(name):
        p = make_pod(cpu="100m", name=name)
        p.spec.containers[0].ports = [{"containerPort": 8080, "hostPort": 8080}]
        return p

    pods = [ported(f"hp{i}") for i in range(5)] + [make_pod(cpu="100m") for _ in range(7)]
    got = assert_pack_equivalent(make_snapshot(pods), n_dev)
    assert int(got[1].sum()) == 0


@pytest.mark.parametrize("n_dev", SHARDS)
def test_capacity_type_workload_sharded_equivalent(n_dev):
    """`tests/test_domain_topology.py:507-522`: a zone spread and a
    capacity-type spread."""
    sel_a = {"matchLabels": {"app": "a"}}
    sel_b = {"matchLabels": {"app": "b"}}
    pods = [make_pod(cpu="1", labels={"app": "a"}, tsc=[zone_spread(1, sel_a)]) for _ in range(9)] + [
        make_pod(cpu="500m", labels={"app": "b"}, tsc=[spread(wk.CAPACITY_TYPE_LABEL_KEY, 1, sel_b)]) for _ in range(7)
    ]
    assert_pack_equivalent(domain_snapshot(pods), n_dev)


def test_ten_thousand_pod_sharded_pack():
    """`bench.build_snapshot(10_000, 60)` on 8 shards (~50 s on the CPU):
    the port's `dryrun_step` (bit for bit against its single-device pack)
    gives the reference's assignment."""
    import bench

    snap = bench.build_snapshot(10_000, 60)
    enc = encode(snap)
    assert not enc.fallback_reasons
    want = jsh.dryrun_step(enc, jsh.make_mesh(jax.devices()[:8]))
    got = sh.dryrun_step(from_reference(enc), sh.make_mesh(["cpu"] * 8))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got >= 0).all()


# -- tests/test_sharded.py TestShardedSolverEndToEnd --------------------------------


def test_gpusolver_with_mesh_matches_reference_meshed_solver():
    sel = {"matchLabels": {"app": "w"}}
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, sel)]) for _ in range(12)] + [
        make_pod(cpu="3", memory="6Gi") for _ in range(7)
    ]
    ref_snap = make_snapshot(pods)
    port_snap = snapshot_from_reference(ref_snap)
    ref_solver = TPUSolver(force=True, recover=False, mesh=jsh.make_mesh())
    meshed = GPUSolver(device="cpu", force=True, mesh=sh.make_mesh(["cpu"] * 8))
    plain = GPUSolver(device="cpu", force=True, mesh=None)
    clear_globals()
    start = next_start()
    same_state(start)
    want = outcome(ref_solver, ref_solver.solve(ref_snap), port=False)
    same_state(start)
    got = outcome(meshed, meshed.solve(port_snap), port=True)
    assert_same(want, got, "meshed solve")
    assert meshed.last_backend == "gpu" and not got["results"][2]
    clear_globals()
    same_state(start)
    assert outcome(plain, plain.solve(snapshot_from_reference(make_snapshot(pods))), port=True)["results"] == got["results"]


@pytest.mark.parametrize("n_dev", (3, 8))
def test_dryrun_step_runs_production_kernel(n_dev):
    sel = {"matchLabels": {"app": "w"}}
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, sel)]) for _ in range(16)]
    enc = encode(make_snapshot(pods))
    want = jsh.dryrun_step(enc, jsh.make_mesh(jax.devices()[:n_dev]))
    got = sh.dryrun_step(from_reference(enc), sh.make_mesh(["cpu"] * n_dev))
    assert got.shape[0] == 16 and (got >= 0).all()
    np.testing.assert_array_equal(got, np.asarray(want))


# -- tests/test_sharded.py TestShardedAnneal, and the per-pod pre-pass --------------------


def _anneal_tensors(name="small_anneal_6"):
    problem, _ref = cons_load(name)
    t, _aux = tensors_from_problem(problem, "cpu", dense_compat=True)
    jt = ConsolidationTensors(*(jax.numpy.asarray(getattr(t, f).numpy()) for f in T_FIELDS))
    return t, jt


@pytest.mark.parametrize("n_dev", (3, 8))
def test_sharded_chains_match_reference_and_one_device(n_dev):
    """Each chain of the port's `anneal_sharded` equals the reference's on
    the same key (chain count rounded up to a mesh multiple) and the port's
    single-device K7 on the same keys."""
    from karpenter_tpu_torch.models.consolidation_model import anneal_chains
    from karpenter_tpu_torch.utils.prng import chain_streams, split

    t, jt = _anneal_tensors()
    n_chains, n_steps = 12, 64
    xs_j, ss_j = jsh.anneal_sharded(jt, jax.random.PRNGKey(7), jsh.make_mesh(jax.devices()[:n_dev]), n_chains=n_chains,
                                    n_steps=n_steps)
    xs, ss = sh.anneal_sharded(t, prng_key(7), sh.make_mesh(["cpu"] * n_dev), n_chains=n_chains, n_steps=n_steps)
    per = -(-n_chains // n_dev)
    assert xs.shape[0] == per * n_dev
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))
    np.testing.assert_array_equal(bits(ss), bits(ss_j))
    x0, flips, u = (torch.from_numpy(a) for a in chain_streams(split(prng_key(7), per * n_dev), n_steps,
                                                                t.node_price.shape[0]))
    xs1, ss1 = anneal_chains(t, x0, flips, u)
    assert torch.equal(xs, xs1) and torch.equal(ss.view(torch.int32), ss1.view(torch.int32))


def test_sharded_proposals_profitable():
    t, _jt = _anneal_tensors()
    _xs, scores = sh.anneal_sharded(t, prng_key(0), sh.make_mesh(["cpu"] * 4), n_chains=16, n_steps=64)
    assert (scores > 0).any(), "the idle fleet must yield profitable subsets"


@pytest.mark.parametrize("n_dev", (3, 8))
def test_sharded_compat_matrix(n_dev):
    sel = {"matchLabels": {"app": "w"}}
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, sel)]) for _ in range(7)] + [
        make_pod(cpu="500m", node_selector={wk.ZONE_LABEL_KEY: "test-zone-b"}) for _ in range(4)]
    enc = encode(make_snapshot(pods))
    want = jsh.sharded_compat_matrix(jsm.make_tensors(enc, with_pods=True), jsh.make_mesh(jax.devices()[:n_dev]))
    p = from_reference(enc)
    t = tsm.make_tensors(p, "cpu")
    got = sh.sharded_compat_matrix(t, tsm.make_pod_tensors(p, "cpu", t), sh.make_mesh(["cpu"] * n_dev))
    assert got.shape == (11, t.row_alloc.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:11])


# -- the thread exchange ----------------------------------------------------------------


def test_a_shard_raising_inside_the_exchange_raises_in_the_caller():
    """Shard 2 raises after its first exchange while the others wait at the
    second: the caller gets shard 2's error within a second, no thread is
    left behind."""

    def body(ex):
        ex.gsum(torch.ones(4, dtype=torch.int32))
        if ex.index == 2:
            raise ValueError("shard 2 failed")
        ex.gsum(torch.ones(4, dtype=torch.int32))
        return ex.index

    before = threading.active_count()
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 2 failed"):
        sx.run_shards(body, 4)
    assert time.perf_counter() - t0 < 1.0
    assert threading.active_count() == before


def test_shards_meeting_at_different_exchanges_raise():
    def body(ex):
        if ex.index == 1:
            return ex.gany_slots(torch.ones((2, 3), dtype=torch.bool))
        return ex.gsum(torch.ones(2, dtype=torch.int32))

    with pytest.raises(sx.ExchangeMismatch):
        sx.run_shards(body, 3)
    # a shard that ends its scan early: the others' exchange meets its end
    with pytest.raises(sx.ExchangeMismatch):
        sx.run_shards(lambda ex: None if ex.index == 0 else ex.gsum(torch.ones(2, dtype=torch.int32)), 2)


def test_exchange_reduces_in_shard_order_with_int32_wraparound():
    """gprefix and gsum wrap as the reference's int32 psum and prefix do."""
    big = torch.tensor([2**30, 2**30, 2**30], dtype=torch.int32)

    def body(ex):
        return ex.gprefix(big), ex.gsum(big), ex.gany_slots(torch.eye(3, dtype=torch.bool)[ex.index:ex.index + 1])

    out = sx.run_shards(body, 3)
    whole = torch.cat([big] * 3).to(torch.int64)
    want_prefix = (torch.cumsum(whole, 0) - whole).to(torch.int32)
    assert torch.equal(torch.cat([o[0] for o in out]), want_prefix)
    assert all(int(o[1]) == int(whole.sum().to(torch.int32)) for o in out)
    assert all(torch.equal(o[2], torch.ones(3, dtype=torch.bool)) for o in out)


def test_plain_arm_counts_its_exchanges():
    """The plain arm's barrier counts S arrivals per exchange, and every
    shard count makes the same exchanges (each shard runs the same
    sequence of them)."""
    sel = {"matchLabels": {"app": "w"}}
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, sel)]) for _ in range(13)]
    p = from_reference(encode(make_snapshot(pods)))
    arrays, _ = build_items(p)
    items = make_item_tensors(arrays, "cpu")
    seen = set()
    for n_dev in (2, 3, 5):
        mesh = sh.make_mesh(["cpu"] * n_dev)
        t = sh.pad_slots_for_mesh(tsm.make_tensors(p, "cpu"), mesh)
        state = sh.greedy_pack_grouped_sharded_state(t, items, mesh)[6]
        assert int(state.barrier) == n_dev * state.exchanges
        seen.add(state.exchanges)
    assert len(seen) == 1 and seen.pop() > 0


def test_plain_arm_refuses_a_slot_axis_that_does_not_split():
    with pytest.raises(ValueError, match="do not split"):
        sx.pack_scan_sharded_plain(None, None, None, None, n_slots=10, n_shards=3)
