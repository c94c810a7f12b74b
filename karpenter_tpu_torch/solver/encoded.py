"""The encoder's output contract, as the device path reads it.

`EncodedProblem` holds exactly the numpy arrays of an encoded snapshot that
the pack (`models/`) and `fast_validate` read: the counts, the per-signature
pod arrays, the candidate rows, the keyed domain axis and the topology
groups. The host object model (pods, templates, instance types) stays on the
encoder's side; pods are named only by `pod_keys` ("namespace/name").

`from_reference(enc)` copies those fields off an encoded snapshot object by
attribute name, and `save_npz` / `load_npz` carry a problem (plus any extra
arrays, such as reference outputs) through a compressed npz file.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

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


_SCALARS = ("n_existing", "n_doms", "has_relaxable")
_STRINGS = ("pod_keys", "dom_key_names", "dom_values")
_ARRAY_FIELDS = tuple(f.name for f in fields(EncodedProblem) if f.name not in _SCALARS + _STRINGS + ("dom_vocab_keys",))


def from_reference(enc) -> EncodedProblem:
    """Copy the device path's fields off an encoded snapshot (read by
    attribute name; the encoder's module is never imported). Pod keys come
    from `pod.key()` on `enc.pods`."""
    kw = {name: np.array(getattr(enc, name), copy=True) for name in _ARRAY_FIELDS}
    return EncodedProblem(
        n_existing=int(enc.n_existing),
        n_doms=int(enc.n_doms),
        has_relaxable=bool(enc.has_relaxable),
        pod_keys=[p.key() for p in enc.pods],
        dom_key_names=[str(k) for k in enc.dom_key_names],
        dom_values=[str(v) for v in enc.dom_values],
        dom_vocab_keys=tuple(int(k) for k in enc.dom_vocab_keys),
        **kw,
    )


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


def load_npz(path) -> tuple[EncodedProblem, dict]:
    """Read a file written by `save_npz`: (problem, extra arrays)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    kw = {name: data.pop(name) for name in _ARRAY_FIELDS}
    problem = EncodedProblem(
        n_existing=int(data.pop("n_existing")),
        n_doms=int(data.pop("n_doms")),
        has_relaxable=bool(data.pop("has_relaxable")),
        dom_vocab_keys=tuple(int(k) for k in data.pop("dom_vocab_keys")),
        **{name: [str(s) for s in data.pop(name)] for name in _STRINGS},
        **kw,
    )
    return problem, data
