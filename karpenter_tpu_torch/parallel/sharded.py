"""The meshed pack: the grouped pack scan with its slot axis split into the
shards of a mesh, and the pre-passes whose batch axis splits the same way.

Counterpart of the reference's `parallel/sharded.py`, under its names. A
`Mesh` holds the devices of its shards. The port checks the meshed path on
one card, as the reference checks its own on one host's virtual devices:
`make_mesh([torch.device("cuda:0")] * 4)` is a mesh of four shards of one
card, `make_mesh(["cpu"] * 8)` one of eight on the CPU. A mesh over two or
more distinct devices raises `NotImplementedError` (its exchange needs peer
memory between cards; ROADMAP Queue 1 item 9).

The scan (`greedy_pack_grouped_sharded_state`): shard s owns slots
`[s * N_loc, (s + 1) * N_loc)` of the slot axis, padded to a multiple of the
mesh size (`pad_slots_for_mesh`), and runs the same `_pack_body` over them.
The shards meet at the reference's three exchange points, where a slot-axis
reduction needs every shard's part (`gprefix`, `gsum`, `gany_slots`, its
`_pack_body` :482-512); every other decision is made from data every shard
holds, so it comes out the same in each. The cross-slot reductions are int32
sums and prefix sums, so the result is bit for bit the single-device pack's.

- On CUDA the scan is kernel K2's slot-sharded form (`kernels/pack_scan.
  pack_scan_sharded`, `csrc/pack_scan_sharded.cu`), a block per shard, in
  the form the shape picks (`kernels/pack_scan.exchange_form`): the shards
  as one thread-block cluster exchanging through distributed shared memory
  where the card places a cluster of that many, else one cooperative launch
  exchanging through global memory (33 and 64 shards). The state names the
  form that ran (`ShardedState.exchange`).
- On the CPU it is the plain multi-shard arm (`models/shard_exchange.
  pack_scan_sharded_plain`): one thread per shard; at each exchange a shard
  gives its part and waits until every shard has given its own, then
  reduces them in shard order.

Feasibility (`sharded_feasibility`) and the per-pod compatibility
(`sharded_compat_matrix`) run kernel K1 once per shard over its block of
items or pods; `anneal_sharded` runs kernel K7 once per shard over its block
of chains. The final carry comes back as a `ShardedState` (one carry per
shard); `gather_state()` is the single-device carry the delta path continues
from, as the reference runs its single-device delta over the sharded carry.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..models.scheduler_model_grouped import (
    ItemTensors,
    _parse_flat,
    _sparsify_takes,
    assignment_from_triples,
    build_items,
    greedy_pack_grouped,
    make_item_tensors,
    nnz_cap_for,
)
from ..models.scheduler_model import SchedulerTensors, make_tensors

AXIS = "batch"
MULTI_CARD = ("a mesh over distinct devices is not supported yet: its slot exchange needs peer-mapped buffers "
              "across cards (ROADMAP Queue 1 item 9, the multi-card exchange)")


@dataclass(frozen=True)
class Mesh:
    """The devices of a mesh's shards, one per shard, along one axis."""

    devices: tuple
    axis_name: str = AXIS
    size: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "size", len(self.devices))


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """A mesh over `devices` (default: every CUDA card). A device may repeat:
    `make_mesh(["cpu"] * 8)` is eight shards on the CPU."""
    if devices is None:
        devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devices), axis)


def _index(dev: torch.device) -> int:
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.current_device()
    return dev.index or 0


def same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and _index(a) == _index(b)


def on_one_device(mesh: Mesh) -> bool:
    """Whether every shard of the mesh lies on one device (the meshes the
    port can run)."""
    return all(same_device(d, mesh.devices[0]) for d in mesh.devices[1:])


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device of a mesh's shards; a mesh over distinct devices
    raises `NotImplementedError`."""
    if not on_one_device(mesh):
        raise NotImplementedError(MULTI_CARD)
    return mesh.devices[0]


def shard_device_slice(devices):
    """shardfleet device partitioning: with ``KARPENTER_SOLVER_SHARD_DEVICES=
    "<i>/<n>"`` set (the ShardRouter stamps each worker process with its
    shard index), keep only contiguous chunk i of the visible devices split
    into n chunks — each shard's fleet runs on its own device slice instead
    of N shard processes contending for every chip. Malformed specs and
    out-of-range indices fall back to all devices; a ≤1-device slice
    degenerates to the unsharded path exactly like a 1-device host."""
    spec = os.environ.get("KARPENTER_SOLVER_SHARD_DEVICES", "").strip()
    if not spec:
        return devices
    try:
        i_s, n_s = spec.split("/", 1)
        i, n = int(i_s), int(n_s)
    except ValueError:
        return devices
    if n <= 0 or not 0 <= i < n:
        return devices
    chunk = -(-len(devices) // n)
    return devices[i * chunk : (i + 1) * chunk]


def default_mesh() -> Mesh | None:
    """A mesh over the distinct CUDA cards (restricted to this shard's slice
    under KARPENTER_SOLVER_SHARD_DEVICES) when there is more than one, else
    None (the single-device path), as the reference's default is None on one
    device. `GPUSolver`'s "auto" does not take a mesh over distinct cards
    until their exchange exists (ROADMAP Queue 1 item 9)."""
    devices = shard_device_slice([torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())])
    if len(devices) <= 1:
        return None
    return make_mesh(devices)


# -- the sharded carry -------------------------------------------------------------


@dataclass
class ShardedState:
    """The meshed pack's final carry: one carry per shard in `initial_state`'s
    layout over the shard's slots (counts_zone and open_count are the same
    in every shard), each on its mesh device. `barrier` (0-d int32, on the
    device) counts the shards' arrivals at the scan's exchanges, S per
    exchange. `exchange` is the form that ran: "cluster" or "grid" on
    CUDA, "plain" on the CPU."""

    mesh: Mesh
    shards: tuple
    barrier: torch.Tensor
    exchange: str

    @property
    def exchanges(self) -> int:
        """The scan's exchanges (reading them synchronises)."""
        return int(self.barrier) // self.mesh.size

    def gather_state(self):
        """The single-device carry over all slots, on the mesh's first device."""
        dev = self.mesh.devices[0]
        s0 = self.shards[0]

        def cat(k, dim=0):
            return torch.cat([s[k].to(dev) for s in self.shards], dim=dim)

        ports = tuple(torch.cat([s[7][p].to(dev) for s in self.shards]) for p in range(3))
        return (cat(0), cat(1), cat(2), cat(3), s0[4].to(dev).clone(), cat(5, dim=1), s0[6].to(dev).clone(), ports)


# -- the meshed pack -------------------------------------------------------------------


def _pad_rows(x, n: int, value=0):
    """x padded with `value` along its first axis up to n rows."""
    pad = n - x.shape[0]
    if not pad:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def pad_slots_for_mesh(t: SchedulerTensors, mesh: Mesh) -> SchedulerTensors:
    """Pad the slot axis up to a multiple of the mesh size (the extra slots
    stay closed and open only if the original axis overflows)."""
    N = t.n_slots
    n_pad = (-N) % mesh.size
    if n_pad or t.counts_host_init.shape[1] != N + n_pad:
        ch = F.pad(t.counts_host_init, (0, N + n_pad - t.counts_host_init.shape[1]))
        t = dataclasses.replace(t, counts_host_init=ch, n_slots=N + n_pad)
    return t


def sharded_feasibility(t: SchedulerTensors, items: ItemTensors, mesh: Mesh):
    """Item x row compatibility and row keys with the item axis split over
    the mesh: kernel K1 once per shard over its block of items (the axis
    padded to a mesh multiple with items of all-zero masks that tolerate
    every taint, reference :241-246), the blocks concatenated and cut back
    to W. Same outputs as `feasibility(t, items)`."""
    from ..kernels.feasibility import compat_and_key

    mesh_device(mesh)
    W = items.item_mask.shape[0]
    per = -(-W // mesh.size)
    n = per * mesh.size
    im = _pad_rows(items.item_mask, n)
    ok = _pad_rows(items.item_taint_ok, n, True)
    req = _pad_rows(items.item_req, n)
    parts = [compat_and_key(t, im[s * per:(s + 1) * per], ok[s * per:(s + 1) * per], req[s * per:(s + 1) * per])
             for s in range(mesh.size)]
    return torch.cat([p[0] for p in parts])[:W], torch.cat([p[1] for p in parts])[:W]


def pack_scan_sharded(t: SchedulerTensors, items: ItemTensors, compat, key, mesh: Mesh):
    """The slot-sharded scan on the mesh's device (kernel K2's sharded form
    on CUDA, the plain multi-shard arm on the CPU). `t` must be padded
    (`pad_slots_for_mesh`). Returns (takes [W, N], leftovers [W],
    ShardedState)."""
    from ..kernels.pack_scan import pack_scan_sharded as k2s

    mesh_device(mesh)
    takes, leftovers, shards, barrier, form = k2s(t, items, compat, key, n_slots=t.n_slots, n_shards=mesh.size)
    return takes, leftovers, ShardedState(mesh, shards, barrier, form)


def greedy_pack_grouped_sharded_state(t: SchedulerTensors, items: ItemTensors, mesh: Mesh):
    """The meshed pack: batch-sharded feasibility, then the slot-sharded
    scan. `t` must already be padded (`pad_slots_for_mesh`). Returns (takes
    [W, N], leftovers [W], slot_basis [N], slot_zoneset [N, Z], slot_rank
    [N], open_count, ShardedState)."""
    compat, key = sharded_feasibility(t, items, mesh)
    takes, leftovers, state = pack_scan_sharded(t, items, compat, key, mesh)
    s = state.shards
    basis = torch.cat([x[0] for x in s])
    zoneset = torch.cat([x[2] for x in s])
    rank = torch.cat([x[3] for x in s])
    return takes, leftovers, basis, zoneset, rank, s[0][6], state


def greedy_pack_grouped_sharded(t: SchedulerTensors, items: ItemTensors, mesh: Mesh):
    """`greedy_pack_grouped`'s contract on a mesh: (takes [W, N], leftovers
    [W], slot_basis [N], slot_zoneset [N, Z], slot_rank [N], open_count),
    with N padded up to a multiple of the mesh size."""
    t = pad_slots_for_mesh(t, mesh)
    return greedy_pack_grouped_sharded_state(t, items, mesh)[:6]


def greedy_pack_compressed_sharded(t: SchedulerTensors, items: ItemTensors, n_pods: int, mesh: Mesh) -> dict:
    """The meshed counterpart of `greedy_pack_grouped_compressed`: the
    meshed pack, then the ordered sparsify (kernel K3) of the gathered
    takes. `t` must be padded. Same dict (parsed outputs, `flat`, `state`
    a `ShardedState`, `nnz_cap`, `n_slots`)."""
    from ..kernels.sparsify import flat_outputs

    W = items.item_req.shape[0]
    N = t.n_slots
    nnz_cap = nnz_cap_for(n_pods, W, N)
    takes, leftovers, basis, zoneset, _rank, open_count, state = greedy_pack_grouped_sharded_state(t, items, mesh)
    flat = flat_outputs(takes, leftovers, basis, zoneset, open_count, nnz_cap)
    out = _parse_flat(flat.cpu().numpy(), nnz_cap, N, t.counts_dom_init.shape[1], W)
    out.update(flat=flat, state=state, nnz_cap=nnz_cap, n_slots=N)
    return out


PACK_OUTPUTS = ("takes", "leftovers", "slot_basis", "slot_zoneset", "slot_rank", "open_count")


def assert_sharded_equivalent(t: SchedulerTensors, items: ItemTensors, mesh: Mesh):
    """Run the meshed and the single-device pack on the same (padded)
    tensors and raise unless every output is bit-identical. Returns the
    meshed outputs."""
    t_pad = pad_slots_for_mesh(t, mesh)
    sharded = greedy_pack_grouped_sharded(t_pad, items, mesh)
    single = greedy_pack_grouped(t_pad, items)
    for name, a, b in zip(PACK_OUTPUTS, sharded, single):
        if not torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()):
            raise AssertionError(f"sharded pack diverged from single-device pack on {name}")
    return sharded


def assignment_from_takes(takes: np.ndarray, item_pods, n_pods: int) -> np.ndarray:
    """Each item's pods over its take row (slot-index order); the rest -1."""
    nzi, nzs, nzc = (x.numpy() for x in _sparsify_takes(torch.as_tensor(takes), int((takes > 0).sum())))
    return assignment_from_triples(nzi, nzs, nzc, item_pods, n_pods)


def dryrun_step(problem, mesh: Mesh) -> np.ndarray:
    """One full meshed solve of an `EncodedProblem`, held bit for bit
    against the single-device pack on the same tensors; returns the pod
    assignment from the meshed takes."""
    dev = mesh_device(mesh)
    item_arrays, item_pods = build_items(problem)
    items = make_item_tensors(item_arrays, dev)
    t = make_tensors(problem, dev)
    takes = assert_sharded_equivalent(t, items, mesh)[0]
    return assignment_from_takes(takes.cpu().numpy(), item_pods, problem.n_pods)


# -- the batch-parallel pre-passes ----------------------------------------------------


def sharded_compat_matrix(t: SchedulerTensors, pods, mesh: Mesh):
    """Pod x row compatibility with the pod axis split over the mesh: kernel
    K1's pod arm once per shard over its block of pods (pad pods tolerate no
    taint, reference :349). Returns [P, Nrows] bool."""
    from ..kernels.feasibility import compat_and_key

    mesh_device(mesh)
    P = pods.pod_mask.shape[0]
    per = -(-P // mesh.size)
    n = per * mesh.size
    pm = _pad_rows(pods.pod_mask, n)
    ok = _pad_rows(pods.pod_taint_ok, n, False)
    req = _pad_rows(pods.pod_req, n)
    parts = [compat_and_key(t, pm[s * per:(s + 1) * per], ok[s * per:(s + 1) * per], req[s * per:(s + 1) * per])[0]
             for s in range(mesh.size)]
    return torch.cat(parts)[:P]


def anneal_sharded(t, key, mesh: Mesh, n_chains: int = 64, n_steps: int = 512):
    """The consolidation annealer with its chain axis split over the mesh:
    the chain count rounds up to a mesh multiple, the keys are
    `split(key, per * S)` (the reference's `jax.random.split`, bit for bit,
    `utils/prng.py`), and kernel K7 runs once per shard over its block of
    chains. Each chain's result equals the single-device run on its key.
    Returns (best_x [per * S, Np] bool, best_s [per * S] f32)."""
    from ..models.consolidation_model import anneal_chains
    from ..utils.prng import chain_streams, split

    dev = mesh_device(mesh)
    per = -(-n_chains // mesh.size)
    keys = split(np.asarray(key, dtype=np.uint32), per * mesh.size)
    x0, flips, u = (torch.from_numpy(a).to(dev) for a in chain_streams(keys, n_steps, t.node_price.shape[0]))
    parts = [anneal_chains(t, x0[s * per:(s + 1) * per], flips[s * per:(s + 1) * per], u[s * per:(s + 1) * per])
             for s in range(mesh.size)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
