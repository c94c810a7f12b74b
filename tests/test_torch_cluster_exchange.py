"""The choice between the slot-sharded scan's two forms, on the CPU.

`kernels/pack_scan.exchange_form(S, largest)` picks the cluster form (the
shards as one thread-block cluster, exchanging through distributed shared
memory) where S is at most the largest cluster the card places at the
launch's shared memory, else the grid form (one cooperative launch,
exchanging through global memory). The choice reads nothing but these two
numbers. On CPU tensors every entry runs the plain multi-shard arm, and
the meshed pack's state names it ("plain"). The forms themselves run on the
card (`tests/test_torch_cuda.py -m gpu`, `chip_smoke.check_sharded`).
"""

from __future__ import annotations

import pytest
import torch

from helpers import make_pod, zone_spread
from test_solver import make_snapshot
from karpenter_tpu.solver.encode import encode
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.kernels import pack_scan as kps
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models.scheduler_model_grouped import build_items, make_item_tensors
from karpenter_tpu_torch.models.shard_exchange import pack_scan_sharded_plain
from karpenter_tpu_torch.parallel import sharded as sh
from karpenter_tpu_torch.solver.encoded import from_reference

torch.set_num_threads(1)

SHARDS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 33, 64)
# the largest cluster a card might place: none, one block, the portable
# limit, the hardware's
LARGEST = (0, 1, 8, 16)


@pytest.mark.parametrize("largest", LARGEST)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_form_follows_the_largest_placeable_cluster(n_shards, largest):
    want = {0: "grid", 1: "cluster" if n_shards == 1 else "grid",
            8: "cluster" if n_shards in (1, 2, 3, 4, 5, 8) else "grid",
            16: "cluster" if n_shards in (1, 2, 3, 4, 5, 8, 9, 16) else "grid"}[largest]
    assert kps.exchange_form(n_shards, largest) == want


def test_every_form_has_its_own_launch_count():
    """Each form's launches are counted under a name of `build.LAUNCHES`,
    and the two names differ (the main path's run shows which form ran)."""
    assert set(kps.FORMS) == {"cluster", "grid"}
    assert set(kps.FORMS.values()) <= set(build.LAUNCHES)
    assert len(set(kps.FORMS.values())) == 2


@pytest.fixture(scope="module")
def small_problem():
    tsm.reset_bucket_highwater()
    sel = {"matchLabels": {"app": "w"}}
    pods = ([make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, sel)]) for _ in range(11)]
            + [make_pod(cpu="2", memory="4Gi") for _ in range(5)])
    p = from_reference(encode(make_snapshot(pods)))
    arrays, _ = build_items(p)
    return p, make_item_tensors(arrays, "cpu")


@pytest.mark.parametrize("n_shards", (2, 3))
def test_cpu_wrappers_run_the_plain_arm(small_problem, n_shards):
    """On CPU tensors the chooser and both forms' wrappers give the plain
    multi-shard arm's outputs, and the meshed state names the plain arm."""
    from karpenter_tpu_torch.kernels.feasibility import feasibility

    p, items = small_problem
    mesh = sh.make_mesh(["cpu"] * n_shards)
    t = sh.pad_slots_for_mesh(tsm.make_tensors(p, "cpu"), mesh)
    compat, key = feasibility(t, items)
    want = pack_scan_sharded_plain(t, items, compat, key, n_slots=t.n_slots, n_shards=n_shards)
    chosen = kps.pack_scan_sharded(t, items, compat, key, n_slots=t.n_slots, n_shards=n_shards)
    assert chosen[4] == "plain"
    for got in (chosen[:4], kps.pack_scan_sharded_grid(t, items, compat, key, n_slots=t.n_slots, n_shards=n_shards),
                kps.pack_scan_sharded_cluster(t, items, compat, key, n_slots=t.n_slots, n_shards=n_shards)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
        for s, s_w in zip(got[2], want[2]):
            for a, b in zip(list(s[:7]) + list(s[7]), list(s_w[:7]) + list(s_w[7])):
                assert torch.equal(a, b)
    state = sh.pack_scan_sharded(t, items, compat, key, mesh)[2]
    assert state.exchange == "plain" and state.exchanges > 0
