"""The port's `mask_encode` and `hybrid_partition` against the reference's,
on the CPU.

`mask_encode` (the hybrid solve's sub-encoding, sliced from the full one):
on `tests/test_mask_encode.py`'s randomized snapshots (ports, taints,
keyed, hostname and custom-key groups, host-blocked signatures) and its
existing-node case, the port's masked encoding equals the reference's array
by array (`solver.encoded.encoding_arrays`: every numpy array, the pod keys
and uids, every name list), and it is equivalent to a from-scratch encode
of the kept pods by the reference test's own canonical projections
(`assert_encode_equivalent`: requests, requirements, the pod x row
compatibility matrix, port conflicts, the topology groups). A flagged
signature or a snapshot-global encoding is refused on both sides.

`hybrid_partition` (`tests/test_hybrid_solver.py`'s `TestPartition`): the
same verdict on both sides and the same tensor and residual pods, in order.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from helpers import hostname_anti_affinity, make_nodepool, make_pod
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu_torch.solver import encode as port_encode
from karpenter_tpu_torch.solver.encoded import encoding_arrays
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
from test_mask_encode import _canon_groups, _compat_matrix, _keep_subset, _random_pods, assert_encode_equivalent
from test_solver import make_snapshot
from test_torch_hybrid_solve import (
    _asymmetric_anti_pods,
    _hybrid_snap,
    _shared_affinity_pods,
    _spread_seam_pods,
    preferred_affinity_pod,
)
from test_torch_solve import clear_globals

torch.set_num_threads(1)


def encode_pair(ref_snap):
    """Both packages' encodings of one snapshot (the port's carried over),
    and the port's snapshot."""
    port_snap = snapshot_from_reference(ref_snap)
    clear_globals()
    return ref_encode.encode(ref_snap), port_encode.encode(port_snap), port_snap


def assert_same_arrays(got, want, what: str) -> None:
    g, w = encoding_arrays(got), encoding_arrays(want)
    assert sorted(g) == sorted(w), f"{what}: fields {sorted(set(g) ^ set(w))}"
    for key, a in w.items():
        b = np.asarray(g[key])
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f"{what}: {key} differs"


def _tainted_snapshot(seed: int):
    rng = random.Random(seed)
    pods = _random_pods(rng, rng.randrange(14, 30))
    from karpenter_tpu.scheduling.taints import Taint

    tainted = make_nodepool(name="tainted-pool", taints=[Taint(key="dedicated", value="batch", effect="NoSchedule")])
    return make_snapshot(pods, node_pools=[make_nodepool(), tainted]), rng


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_mask_encode_matches_reference(seed):
    ref_snap, rng = _tainted_snapshot(seed)
    ref_enc, port_enc, port_snap = encode_pair(ref_snap)
    assert not ref_enc.fallback_reasons and not port_enc.fallback_reasons
    assert_same_arrays(port_enc, ref_enc, "full encoding")
    keep = _keep_subset(ref_enc, rng)
    assert keep is not None
    want = ref_encode.mask_encode(ref_enc, keep)
    got = port_encode.mask_encode(port_enc, keep)
    assert_same_arrays(got, want, f"seed {seed} masked")
    assert got.row_alloc is port_enc.row_alloc and got.row_meta is port_enc.row_meta
    # the port's masked encoding is its from-scratch encode of the kept pods
    scratch = port_encode.encode(port_snap.with_pods(list(got.pods)))
    assert_encode_equivalent(got, scratch)


def test_mask_encode_existing_node_inverse_anti():
    from test_sharded import existing_node_snapshot

    types = [catalog.make_instance_type("c", 8, zones=["test-zone-a", "test-zone-b"])]
    pods = [make_pod(cpu="500m", name=f"p{i}") for i in range(4)]
    pods += [make_pod(cpu="500m", name=f"blk-{i}", labels={"app": "blocked"}) for i in range(3)]
    pods += [make_pod(cpu="1", name="odd-size")]
    snap = existing_node_snapshot(pods, types)
    running = make_pod(cpu="100m", name="runner", labels={"app": "runner"}, node_name="n1",
                       anti_affinity=[hostname_anti_affinity({"matchLabels": {"app": "blocked"}})])
    running.status.phase = "Running"
    snap.store.create(running)
    ref_snap = snap.with_pods(pods)
    ref_enc, port_enc, port_snap = encode_pair(ref_snap)
    assert port_enc.sig_host_blocked.any()
    drop = {int(port_enc.sig_of_pod[[p.metadata.name for p in port_enc.pods].index("odd-size")])}
    keep = [s for s in range(port_enc.n_sigs) if s not in drop]
    want = ref_encode.mask_encode(ref_enc, keep)
    got = port_encode.mask_encode(port_enc, keep)
    assert_same_arrays(got, want, "masked")
    assert got.sig_host_blocked.any()
    assert_encode_equivalent(got, port_encode.encode(port_snap.with_pods(list(got.pods))))


def test_mask_encode_full_set_and_refusals():
    """Keeping every signature changes nothing the consumers read; a flagged
    signature or a snapshot-global encoding is refused, as the reference
    refuses them."""
    ref_snap = make_snapshot(_random_pods(random.Random(11), 12))
    _ref_enc, enc, _ = encode_pair(ref_snap)
    masked = port_encode.mask_encode(enc, range(enc.n_sigs))
    assert all(a is b for a, b in zip(masked.pods, enc.pods))
    np.testing.assert_array_equal(masked.sig_of_pod, enc.sig_of_pod)
    np.testing.assert_array_equal(_compat_matrix(masked), _compat_matrix(enc))
    assert _canon_groups(masked) == _canon_groups(enc)
    assert masked.decode_cache is enc.decode_cache

    ref_enc, enc, _ = encode_pair(make_snapshot([make_pod(cpu="500m", name="a"), preferred_affinity_pod()]))
    flagged = next(iter(enc.fallback_sig_local))
    for mod, e in ((ref_encode, ref_enc), (port_encode, enc)):
        with pytest.raises(ValueError, match="flagged"):
            mod.mask_encode(e, [flagged])
    clean = [s for s in range(enc.n_sigs) if s not in enc.fallback_sig_local]
    masked = port_encode.mask_encode(enc, clean)
    assert [p.metadata.name for p in masked.pods] == ["a"] and not masked.fallback_reasons
    assert_same_arrays(masked, ref_encode.mask_encode(ref_enc, clean), "clean")

    ref_enc, enc, _ = encode_pair(make_snapshot(_asymmetric_anti_pods()))
    assert enc.fallback_has_global
    for mod, e in ((ref_encode, ref_enc), (port_encode, enc)):
        with pytest.raises(ValueError, match="global"):
            mod.mask_encode(e, [0])


PARTITIONS = {
    "pod_local": (lambda: _hybrid_snap(6), (6, 1)),
    "global_reason": (lambda: make_snapshot(_asymmetric_anti_pods()), None),
    "all_flagged": (lambda: make_snapshot([preferred_affinity_pod(name=f"o{i}") for i in range(3)]), None),
    "spread_seam": (lambda: make_snapshot(_spread_seam_pods()), (4, 1)),
    "shared_affinity": (lambda: make_snapshot(_shared_affinity_pods()), None),
    "in_window": (lambda: make_snapshot([make_pod(cpu="1")]), None),
}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_hybrid_partition_matches_reference(name):
    build, sizes = PARTITIONS[name]
    ref_snap = build()
    ref_enc, port_enc, port_snap = encode_pair(ref_snap)
    assert port_enc.fallback_reasons == ref_enc.fallback_reasons
    assert port_enc.fallback_sig_local == ref_enc.fallback_sig_local
    assert port_enc.fallback_has_global == ref_enc.fallback_has_global
    want = ref_encode.hybrid_partition(ref_snap, ref_enc)
    got = port_encode.hybrid_partition(port_snap, port_enc)
    if sizes is None:
        assert want is None and got is None
        return
    assert want is not None and got is not None
    for g, w in zip(got, want):
        assert [p.key() for p in g] == [p.key() for p in w]
    assert tuple(len(x) for x in got) == sizes
