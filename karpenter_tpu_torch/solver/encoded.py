"""The encoder's output contract, as the device path reads it.

`EncodedProblem` holds exactly the numpy arrays of an encoded snapshot that
the pack (`models/`) and `fast_validate` read: the counts, the per-signature
pod arrays, the candidate rows, the keyed domain axis and the topology
groups. The host object model (pods, templates, instance types) stays on the
encoder's side; pods are named only by `pod_keys` ("namespace/name").

A problem may carry an `EncodedDelta`: what changed since an earlier
problem (its `base`) — pods appended, pods removed and, on a bind flush, the
refreshed existing-node rows. `GPUSolver` solves such a problem from the
base's resident pack carry instead of packing it whole.

`from_reference(enc)` copies those fields off an encoded snapshot object by
attribute name: the port's own (`solver.encode.encode`) or the reference's.
`encoding_arrays(enc)` flattens every numpy array and name list of such an
object into one dict (the seeded snapshot fixture's layout), and `save_npz` / `load_npz` carry a problem (plus any extra
arrays, such as reference outputs) through a compressed npz file;
`save_chain` / `load_chain` do the same for a chain of problems, each with
its delta against an earlier one.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np

KIND_DOM_SPREAD = 0  # spread over a keyed domain axis (zone, capacity-type, ...)
KIND_HOST_SPREAD = 1
KIND_HOST_ANTI = 2
KIND_DOM_ANTI = 3  # required anti-affinity over a non-hostname topology key
KIND_DOM_AFF = 4  # required pod affinity over a non-hostname topology key
KIND_HOST_AFF = 5  # required pod affinity over hostname (co-location)


@dataclass
class EncodedProblem:
    """Numpy arrays of one encoded snapshot (shapes as the encoder makes
    them: S signatures, Nrows rows, K label keys, D domains, Kd dom keys,
    G groups, Q template ranks, P1/P2 port columns)."""

    n_existing: int
    n_doms: int
    has_relaxable: bool
    # pods, in FFD queue order, and their signatures
    pod_keys: list  # [P] "namespace/name"
    sig_of_pod: np.ndarray  # [P] i32
    sig_req: np.ndarray  # [S, R] f32
    sig_mask: np.ndarray  # [S, K, Words] uint32
    sig_taint_ok: np.ndarray  # [S, C] bool
    sig_dom_allowed: np.ndarray  # [S, D] bool
    sig_restrict: np.ndarray  # [S, Kd] bool
    sig_member: np.ndarray  # [S, G] bool — counted by the group
    sig_owner: np.ndarray  # [S, G] bool — constrained by the group
    sig_host_blocked: np.ndarray  # [S, max(n_existing, 1)] bool
    sig_port_any: np.ndarray  # [S, P1] bool
    sig_port_wild: np.ndarray  # [S, P1] bool
    sig_port_spec: np.ndarray  # [S, P2] bool
    # rows: existing nodes [0, n_existing) then offerings
    row_alloc: np.ndarray  # [Nrows, R] f32
    row_labels: np.ndarray  # [Nrows, K] i32
    row_dom: np.ndarray  # [Nrows, Kd] i32
    row_pool_rank: np.ndarray  # [Nrows] i32
    row_taint_class: np.ndarray  # [Nrows] i32
    row_port_any: np.ndarray  # [Nrows, P1] bool
    row_port_wild: np.ndarray  # [Nrows, P1] bool
    row_port_spec: np.ndarray  # [Nrows, P2] bool
    existing_port_any: np.ndarray  # [n_existing, P1] bool
    existing_port_wild: np.ndarray  # [n_existing, P1] bool
    existing_port_spec: np.ndarray  # [n_existing, P2] bool
    # keyed domain axis (the first Kd ids are the per-key absent sentinels)
    dom_key_of: np.ndarray  # [D] i32
    dom_key_names: list  # [Kd] str
    dom_values: list  # [D] str
    dom_vocab_keys: tuple  # [Kd] vocab key id per dom key (-1 if absent)
    rank_domset: np.ndarray  # [Q, D] bool
    # topology groups
    group_kind: np.ndarray  # [G] i32
    group_skew: np.ndarray  # [G] i32
    group_dom_key: np.ndarray  # [G] i32
    group_min_domains: np.ndarray  # [G] i32
    group_registered: np.ndarray  # [G, D] bool
    counts_dom_init: np.ndarray  # [G, D] i32
    counts_host_existing: np.ndarray  # [G, n_existing] i32
    # what changed since an earlier problem (None: solved whole)
    delta: EncodedDelta | None = None

    @property
    def n_pods(self) -> int:
        return int(self.sig_of_pod.shape[0])

    @property
    def n_sigs(self) -> int:
        return int(self.sig_req.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.group_kind.shape[0])

    @property
    def n_rows(self) -> int:
        return int(self.row_alloc.shape[0])


@dataclass
class RowDiff:
    """A bind flush over a stable node set: the existing rows' refreshed
    values minus the base's (the problem itself holds the new values)."""

    n_existing: int
    alloc: np.ndarray  # [E, R] f32 allocatable shift of each existing node
    counts_dom: np.ndarray | None  # [G, D] i32 shift of the store-side domain counts (None: no groups)
    counts_host: np.ndarray | None  # [G, max(E, 1)] i32 shift of the per-node counts
    ports_changed: bool  # the existing nodes' host-port planes changed


@dataclass
class EncodedDelta:
    """The problem is `base` with the pods at `removed_enc` (indices into the
    base's pod axis) taken out, the survivors kept in order, and one pod per
    entry of `added_sigs` appended; `row_diff` refreshes the existing rows."""

    added_sigs: np.ndarray  # [n_added] i32 signature of each appended pod
    removed_enc: np.ndarray  # [n_removed] i64
    row_diff: RowDiff | None
    base: EncodedProblem | None  # the problem this delta continues (None: unknown)


_SCALARS = ("n_existing", "n_doms", "has_relaxable")
_STRINGS = ("pod_keys", "dom_key_names", "dom_values")
_ARRAY_FIELDS = tuple(f.name for f in fields(EncodedProblem)
                      if f.name not in _SCALARS + _STRINGS + ("dom_vocab_keys", "delta"))


def delta_of_reference(enc, base: EncodedProblem | None) -> EncodedDelta | None:
    """The delta an encoded snapshot carries (`delta_added_sigs`,
    `delta_removed_enc`, `delta_row_diff`, read by attribute name), linked
    to `base`; None when it carries none (a full encode)."""
    added = getattr(enc, "delta_added_sigs", None)
    removed = getattr(enc, "delta_removed_enc", None)
    rd = getattr(enc, "delta_row_diff", None)
    if added is None and removed is None and rd is None:
        return None
    row_diff = None
    if rd is not None:
        counts = rd["counts_dom"] is not None
        row_diff = RowDiff(
            n_existing=int(rd["n_existing"]),
            alloc=np.array(rd["alloc"], dtype=np.float32, copy=True),
            counts_dom=np.array(rd["counts_dom"], dtype=np.int32, copy=True) if counts else None,
            counts_host=np.array(rd["counts_host"], dtype=np.int32, copy=True) if counts else None,
            ports_changed=bool(rd["ports_changed"]),
        )
    return EncodedDelta(
        added_sigs=np.asarray(added if added is not None else np.zeros(0), dtype=np.int32).copy(),
        removed_enc=np.asarray(removed if removed is not None else np.zeros(0), dtype=np.int64).copy(),
        row_diff=row_diff,
        base=base,
    )


def from_reference(enc, base: EncodedProblem | None = None) -> EncodedProblem:
    """Copy the device path's fields off an encoded snapshot (read by
    attribute name; the encoder's module is never imported). Pod keys come
    from `pod.key()` on `enc.pods`. A delta encode's delta is copied too and
    linked to `base`, this package's problem for the encode's delta base
    (the previous encode, or on an identical resubmit the same one)."""
    kw = {name: np.array(getattr(enc, name), copy=True) for name in _ARRAY_FIELDS}
    return EncodedProblem(
        n_existing=int(enc.n_existing),
        n_doms=int(enc.n_doms),
        has_relaxable=bool(enc.has_relaxable),
        pod_keys=[p.key() for p in enc.pods],
        dom_key_names=[str(k) for k in enc.dom_key_names],
        dom_values=[str(v) for v in enc.dom_values],
        dom_vocab_keys=tuple(int(k) for k in enc.dom_vocab_keys),
        delta=delta_of_reference(enc, base),
        **kw,
    )


def _row_name(meta) -> str:
    if meta[0] == "existing":
        return f"existing/{meta[1].name()}"
    _kind, template, it, offering = meta
    return (f"offering/{template.nodepool_name}/{it.name}/{offering.zone()}/{offering.capacity_type()}/"
            f"{offering.reservation_id()}")


def encoding_arrays(enc) -> dict:
    """Every numpy array and name list of an encoded snapshot, read by
    attribute name: its public array attributes as they are (delta arrays
    included; a solver's private caches left out), the pod keys and uids in encode order, the resource, domain,
    dom-key and fallback-reason names, one name per candidate row, and the
    scalar counts."""
    out = {name: v for name, v in vars(enc).items() if isinstance(v, np.ndarray) and not name.startswith("_")}
    names = {
        "pod_keys": [p.key() for p in enc.pods],
        "pod_uids": [p.metadata.uid for p in enc.pods],
        "resource_names": enc.resource_names,
        "dom_values": enc.dom_values,
        "dom_key_names": enc.dom_key_names,
        "fallback_reasons": enc.fallback_reasons,
        "row_names": [_row_name(m) for m in enc.row_meta],
    }
    for name, values in names.items():
        out[name] = np.asarray([str(v) for v in values], dtype=np.str_).reshape(-1)
    out["dom_vocab_keys"] = np.asarray(enc.dom_vocab_keys, dtype=np.int64).reshape(-1)
    for name in ("n_existing", "n_doms"):
        out[name] = np.int64(getattr(enc, name))
    out["has_relaxable"] = np.bool_(enc.has_relaxable)
    return out


def problem_arrays(p: EncodedProblem) -> dict:
    """The problem as a flat dict of numpy arrays (the npz layout)."""
    out = {name: getattr(p, name) for name in _ARRAY_FIELDS}
    out["n_existing"] = np.int64(p.n_existing)
    out["n_doms"] = np.int64(p.n_doms)
    out["has_relaxable"] = np.bool_(p.has_relaxable)
    out["dom_vocab_keys"] = np.asarray(p.dom_vocab_keys, dtype=np.int64).reshape(-1)
    for name in _STRINGS:
        out[name] = np.asarray(getattr(p, name), dtype=np.str_).reshape(-1)
    return out


def save_npz(path, problem: EncodedProblem, **extra) -> None:
    """Write the problem (and any extra named arrays) to a compressed npz."""
    clash = set(extra) & set(problem_arrays(problem))
    if clash:
        raise ValueError(f"extra arrays collide with problem fields: {sorted(clash)}")
    np.savez_compressed(path, **problem_arrays(problem), **extra)


def _problem_of(data: dict, prefix: str = "") -> EncodedProblem:
    """Pop one problem's arrays (keys `prefix + field`) off `data`."""
    kw = {name: data.pop(prefix + name) for name in _ARRAY_FIELDS}
    return EncodedProblem(
        n_existing=int(data.pop(prefix + "n_existing")),
        n_doms=int(data.pop(prefix + "n_doms")),
        has_relaxable=bool(data.pop(prefix + "has_relaxable")),
        dom_vocab_keys=tuple(int(k) for k in data.pop(prefix + "dom_vocab_keys")),
        **{name: [str(s) for s in data.pop(prefix + name)] for name in _STRINGS},
        **kw,
    )


def load_npz(path) -> tuple[EncodedProblem, dict]:
    """Read a file written by `save_npz`: (problem, extra arrays)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    return _problem_of(data), data


def _shares_arrays(p: EncodedProblem, q: EncodedProblem) -> bool:
    return all(getattr(p, name) is getattr(q, name) for name in _ARRAY_FIELDS)


def _delta_arrays(d: EncodedDelta, base_step: int, prefix: str) -> dict:
    out = {prefix + "delta_base": np.int64(base_step), prefix + "added_sigs": d.added_sigs,
           prefix + "removed_enc": d.removed_enc, prefix + "row_diff": np.bool_(d.row_diff is not None)}
    rd = d.row_diff
    if rd is not None:
        out.update({prefix + "rd_n_existing": np.int64(rd.n_existing), prefix + "rd_alloc": rd.alloc,
                    prefix + "rd_counts": np.bool_(rd.counts_dom is not None),
                    prefix + "rd_ports_changed": np.bool_(rd.ports_changed)})
        if rd.counts_dom is not None:
            out.update({prefix + "rd_counts_dom": rd.counts_dom, prefix + "rd_counts_host": rd.counts_host})
    return out


def _delta_of(data: dict, prefix: str, base: EncodedProblem) -> EncodedDelta:
    row_diff = None
    if bool(data.pop(prefix + "row_diff")):
        counts = bool(data.pop(prefix + "rd_counts"))
        row_diff = RowDiff(
            n_existing=int(data.pop(prefix + "rd_n_existing")),
            alloc=data.pop(prefix + "rd_alloc"),
            counts_dom=data.pop(prefix + "rd_counts_dom") if counts else None,
            counts_host=data.pop(prefix + "rd_counts_host") if counts else None,
            ports_changed=bool(data.pop(prefix + "rd_ports_changed")),
        )
    return EncodedDelta(added_sigs=data.pop(prefix + "added_sigs"), removed_enc=data.pop(prefix + "removed_enc"),
                        row_diff=row_diff, base=base)


def chain_arrays(problems: list) -> dict:
    """A chain of problems as a flat dict of numpy arrays (keys
    `s<i>.<field>`). Each problem's delta must link to an earlier problem
    of the chain; a problem whose arrays are an earlier one's (an identical
    resubmit) stores only its delta."""
    out = {"n_steps": np.int64(len(problems))}
    for i, p in enumerate(problems):
        pre = f"s{i}."
        same = next((j for j in range(i) if _shares_arrays(p, problems[j])), -1)
        out[pre + "arrays_of"] = np.int64(same)
        if same < 0:
            out.update({pre + k: v for k, v in problem_arrays(p).items()})
        out[pre + "delta"] = np.bool_(p.delta is not None)
        if p.delta is not None:
            base_step = next((j for j in range(i) if problems[j] is p.delta.base), -1)
            if base_step < 0:
                raise ValueError(f"step {i}: the delta's base is not an earlier problem of the chain")
            out.update(_delta_arrays(p.delta, base_step, pre))
    return out


def save_chain(path, problems: list, **extra) -> None:
    """Write a chain (`chain_arrays`) and any extra named arrays to one
    compressed npz."""
    out = chain_arrays(problems)
    clash = set(extra) & set(out)
    if clash:
        raise ValueError(f"extra arrays collide with chain fields: {sorted(clash)}")
    np.savez_compressed(path, **out, **extra)


def load_chain(path) -> tuple[list, dict]:
    """Read a file written by `save_chain`: (problems, extra arrays). Each
    delta links to the loaded problem of its base step, so the chain can be
    solved in order from a resident carry."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    problems: list = []
    for i in range(int(data.pop("n_steps"))):
        pre = f"s{i}."
        same = int(data.pop(pre + "arrays_of"))
        p = replace(problems[same], delta=None) if same >= 0 else _problem_of(data, pre)
        if bool(data.pop(pre + "delta")):
            p.delta = _delta_of(data, pre, problems[int(data.pop(pre + "delta_base"))])
        problems.append(p)
    return problems, data
