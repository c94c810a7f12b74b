"""K2 pack_scan: the grouped pack scan in one persistent CUDA block, with
helper blocks of the same launch that first build the items' data; and its
slot-sharded form.

`pack_scan` launches `csrc/pack_scan.cu` for CUDA tensors and runs the plain
`_pack_body` for CPU tensors. The carry is copied from `init_state` (or
built by `initial_state`) into fresh buffers that the kernel updates in
place; they are returned as the final carry, in `initial_state`'s layout,
so a later pack can start from them. The kernel touches only the open slots
(`[0, open_count)` and those it opens): the slots past them come back as
they went in.

`pack_scan_sharded` is the same scan with the slot axis split into S shards
(`csrc/pack_scan_sharded.cu`, a block per shard) in one of two forms, chosen
by shape alone (`exchange_form`): where the card places a thread-block
cluster of S shard blocks at the launch's shared memory, the cluster form
(`pack_scan_sharded_cluster`: the item blocks' launch, then one cluster whose
shards exchange through distributed shared memory); else the grid form
(`pack_scan_sharded_grid`: one cooperative launch, the exchanges through
global memory). On CPU tensors each runs the plain multi-shard arm
(`models/shard_exchange.pack_scan_sharded_plain`)."""

from __future__ import annotations

import ctypes

import torch

from ..models.scheduler_model_grouped import _pack_body, initial_state
from ..models.shard_exchange import pack_scan_sharded_plain
from . import build

pack_scan_plain = _pack_body


def _dims(t, items, N: int, extra: tuple = ()) -> tuple:
    """The kernels' dims: W, N, Nrows, R, D, G, Q, Kd, P1, P2, HB,
    n_existing, n_rows_real, then `extra`."""
    W, R = items.item_req.shape
    G, D = t.counts_dom_init.shape
    return (W, N, t.row_alloc.shape[0], R, D, G, t.rank_domset.shape[0], items.item_restrict.shape[1],
            items.item_port_any.shape[1], items.item_port_spec.shape[1], items.item_host_blocked.shape[1],
            int(t.n_existing), int(t.n_rows_real), *extra)


def _launch(entry: str, t, items, compat, key, N: int, carry: list, extra: tuple = ()):
    """Check the inputs and launch `kt_<entry>` over the carry buffers
    `carry` (updated in place, in `initial_state`'s leaf order); returns
    (takes [W, N], leftovers [W], the scratch), or the launch's error code's
    refusal."""
    dev = items.item_req.device
    W, R = items.item_req.shape
    Nrows = t.row_alloc.shape[0]
    G, D = t.counts_dom_init.shape
    if compat.shape != (W, Nrows) or key.shape != (W, Nrows):
        raise build.KernelArgError(f"{entry}: feasibility outputs do not match the items")
    if carry[0].shape != (N,) or carry[1].shape != (N, R) or carry[5].shape != (G, N):
        raise build.KernelArgError(f"{entry}: carry does not match n_slots")
    dims = _dims(t, items, N, extra)
    d_arr = (ctypes.c_int * len(dims))(*dims)
    lib = build.lib()
    takes = torch.zeros((W, N), dtype=torch.int32, device=dev)
    leftovers = torch.zeros(W, dtype=torch.int32, device=dev)
    scratch = torch.zeros(getattr(lib, f"kt_{entry}_scratch")(ctypes.addressof(d_arr)), dtype=torch.int32,
                          device=dev)
    b, f, i = torch.bool, torch.float32, torch.int32
    inputs = [
        (t.row_alloc, f), (t.row_pool_rank, i), (t.rank_domset, b), (t.rank_dom_cap, f), (t.dom_key_of, i),
        (t.group_kind, i), (t.group_skew, i), (t.group_dom_key, i), (t.group_min_domains, i),
        (t.group_registered, b), (t.row_port_any, b), (t.row_port_wild, b), (t.row_port_spec, b),
        (items.item_req, f), (items.item_dom_allowed, b), (items.item_restrict, b), (items.item_member, b),
        (items.item_owner, b), (items.item_count, i), (items.item_port_any, b), (items.item_port_wild, b),
        (items.item_port_spec, b), (items.item_host_blocked, b), (compat, b), (key, f),
    ]
    carry_types = (i, f, b, i, i, i, i, b, b, b)
    ptrs = [build.require(x, dev, dt, f"input {k}").data_ptr() for k, (x, dt) in enumerate(inputs)]
    ptrs += [build.require(x, dev, dt, f"carry {k}").data_ptr() for k, (x, dt) in enumerate(zip(carry, carry_types))]
    ptrs += [takes.data_ptr(), leftovers.data_ptr(), scratch.data_ptr()]
    p_arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    rc = getattr(lib, f"kt_{entry}")(ctypes.addressof(p_arr), ctypes.addressof(d_arr), build.stream_ptr(dev))
    if rc == _TOO_LARGE:
        scan = f"its {extra[0]} shard blocks" if extra else "its scan block"
        raise build.KernelArgError(f"{entry}: {scan} and the item blocks do not fit on the card at once "
                                   "(a cooperative launch)")
    build.check(rc, entry)
    build.LAUNCHES[entry] += 1
    return takes, leftovers, scratch


def pack_scan(t, items, compat, key, *, n_slots: int, init_state=None):
    """Returns (takes [W, N] i32, leftovers [W] i32, final carry)."""
    dev = items.item_req.device
    if dev.type == "cpu":
        return _pack_body(t, items, n_slots=n_slots, init_state=init_state, precomputed=(compat, key))
    if dev.type != "cuda":
        raise build.KernelArgError(f"pack_scan: unsupported device {dev}")
    N = int(n_slots)
    st = init_state if init_state is not None else initial_state(t, N)
    slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = st
    carry = [x.clone().contiguous() for x in (slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone,
                                              counts_host, open_count.reshape(1), *ports)]
    takes, leftovers, _scratch = _launch("pack_scan", t, items, compat, key, N, carry)
    state = (carry[0], carry[1], carry[2], carry[3], carry[4], carry[5], carry[6].reshape(()),
             (carry[7], carry[8], carry[9]))
    return takes, leftovers, state


# cudaErrorCooperativeLaunchTooLarge: the scan blocks and the item blocks
# cannot all be resident at once
_TOO_LARGE = 82

# the forms of the slot-sharded scan and the count each one's launch adds to
FORMS = {"cluster": "pack_scan_cluster", "grid": "pack_scan_sharded"}

# the largest cluster of shard blocks the card places, by (device, dims)
_LARGEST: dict = {}


def exchange_form(n_shards: int, largest_cluster: int) -> str:
    """The form of the slot-sharded scan for `n_shards` shards on a card
    that places clusters of up to `largest_cluster` shard blocks at the
    launch's shared memory: "cluster" where the shards fit in one, else
    "grid"."""
    return "cluster" if 1 <= n_shards <= largest_cluster else "grid"


def largest_cluster(t, items, *, n_slots: int, n_shards: int) -> int:
    """The largest cluster of shard blocks (at most 16) the card places at
    the cluster form's shared memory for this shape (the slot tile depends
    on N / S), 0 if none: asked of the card once per device and shape."""
    dev = items.item_req.device
    dims = _dims(t, items, int(n_slots), (int(n_shards),))
    cache_key = (dev.index if dev.index is not None else torch.cuda.current_device(), dims)
    if cache_key not in _LARGEST:
        d_arr = (ctypes.c_int * len(dims))(*dims)
        n = build.lib().kt_pack_scan_cluster_max(ctypes.addressof(d_arr))
        if n < 0:
            build.check(-n, "pack_scan_cluster (cluster occupancy)")
        _LARGEST[cache_key] = n
    return _LARGEST[cache_key]


def _split_check(entry: str, dev, N: int, S: int) -> None:
    if dev.type != "cuda":
        raise build.KernelArgError(f"{entry}: unsupported device {dev}")
    if S < 1 or N % S:
        raise build.KernelArgError(f"{entry}: {N} slots do not split into {S} shards")


def _sharded(form: str, t, items, compat, key, N: int, S: int):
    """Launch the slot-sharded scan in `form` from the initial carry."""
    slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = initial_state(t, N)
    # the slot leaves over all N slots (shard s owns [s N / S, (s + 1) N / S));
    # counts_zone and open_count once per shard
    carry = [x.clone().contiguous() for x in (slot_basis, slot_rem, slot_zoneset, slot_rank)]
    carry += [counts_zone.unsqueeze(0).repeat(S, 1, 1).contiguous(), counts_host.clone().contiguous(),
              open_count.reshape(1).repeat(S).contiguous()]
    carry += [x.clone().contiguous() for x in ports]
    takes, leftovers, scratch = _launch(FORMS[form], t, items, compat, key, N, carry, extra=(S,))
    n = N // S
    shards = tuple(
        (carry[0][s * n:(s + 1) * n], carry[1][s * n:(s + 1) * n], carry[2][s * n:(s + 1) * n],
         carry[3][s * n:(s + 1) * n], carry[4][s], carry[5][:, s * n:(s + 1) * n], carry[6][s],
         tuple(carry[k][s * n:(s + 1) * n] for k in (7, 8, 9)))
        for s in range(S))
    return takes, leftovers, shards, scratch[1]


def _one_form(form: str, entry: str, t, items, compat, key, n_slots: int, n_shards: int):
    dev = items.item_req.device
    if dev.type == "cpu":
        return pack_scan_sharded_plain(t, items, compat, key, n_slots=n_slots, n_shards=n_shards)
    N, S = int(n_slots), int(n_shards)
    _split_check(entry, dev, N, S)
    return _sharded(form, t, items, compat, key, N, S)


def pack_scan_sharded_grid(t, items, compat, key, *, n_slots: int, n_shards: int):
    """The grid form (`kt_pack_scan_sharded`, any S) from the initial carry.
    Returns (takes [W, N] i32, leftovers [W] i32, the shards' carries in
    `initial_state`'s layout over their slots, barrier): on CUDA the
    carries are views into the launch's buffers and `barrier` is its
    exchange counter (word 1 of its scratch, 0-d int32), S per exchange."""
    return _one_form("grid", "pack_scan_sharded_grid", t, items, compat, key, n_slots, n_shards)


def pack_scan_sharded_cluster(t, items, compat, key, *, n_slots: int, n_shards: int):
    """The cluster form (`kt_pack_scan_cluster`, S up to the largest cluster
    the card places), as `pack_scan_sharded_grid`; a cluster the card cannot
    place is the launch's refusal."""
    return _one_form("cluster", "pack_scan_sharded_cluster", t, items, compat, key, n_slots, n_shards)


def pack_scan_sharded(t, items, compat, key, *, n_slots: int, n_shards: int):
    """The scan with the slot axis split into `n_shards` shards of N / S
    slots, from the initial carry, in the form `exchange_form` picks for
    the shape. Returns the form's (takes, leftovers, shards' carries,
    barrier) and the form ("cluster" or "grid"; "plain" on the CPU)."""
    dev = items.item_req.device
    if dev.type == "cpu":
        return (*pack_scan_sharded_plain(t, items, compat, key, n_slots=n_slots, n_shards=n_shards), "plain")
    N, S = int(n_slots), int(n_shards)
    _split_check("pack_scan_sharded", dev, N, S)
    form = exchange_form(S, largest_cluster(t, items, n_slots=N, n_shards=S))
    return (*_sharded(form, t, items, compat, key, N, S), form)
