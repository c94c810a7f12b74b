"""Runtime shape/dtype contracts for the encode-space arrays.

The static side of this PR (karpenter_tpu/analysis) checks what the CODE
does to the tensors; this module checks what the TENSORS actually are. Under
``KARPENTER_SOLVER_TYPECHECK=1`` (the tier-1 test run enables it via
tests/conftest.py) every encode construction (full, masked, delta) and every
pack entry point re-validates the `EncodedSnapshot` against the declared
dimension algebra below, and `fast_validate` checks its assignment/slot
inputs — so a shape or dtype drift surfaces at the seam where it was
introduced instead of as a wrong placement three layers later. Off by
default: production solves pay zero cost.

Dimension symbols (all bound from the encode itself):

    P pods · S signatures · R resource axes · N rows · E existing rows
    K vocab keys · W bitset words · C taint classes · D domains ·
    Kd domain keys · G topology groups · Q template ranks ·
    P1 (port, proto) keys · P2 (ip, port, proto) keys

Shape specs may wrap a symbol as ``("X", 1)`` meaning ``max(X, 1)`` — the
encode pads several axes to at least one element so device kernels never see
a zero-width axis.
"""

from __future__ import annotations

import os

import numpy as np


class ContractError(RuntimeError):
    """An encode-space array violated its declared shape/dtype contract."""


def typecheck_enabled() -> bool:
    return os.environ.get("KARPENTER_SOLVER_TYPECHECK", "") == "1"


_BOOL = np.bool_
_INT = np.integer
_UINT = np.unsignedinteger
_FLOAT = np.floating

# field -> (dims, dtype kind). Dims are symbols resolved against the encode;
# ("X", 1) means max(X, 1).
ENCODED_ARRAY_SPEC: dict[str, tuple[tuple, type]] = {
    "row_alloc": (("N", "R"), _FLOAT),
    "row_price": (("N",), _FLOAT),
    "row_labels": (("N", ("K", 1)), _INT),
    "row_dom": (("N", "Kd"), _INT),
    "row_pool_rank": (("N",), _INT),
    "row_taint_class": (("N",), _INT),
    "sig_of_pod": (("P",), _INT),
    "sig_req": (("S", "R"), _FLOAT),
    "sig_mask": (("S", "K", "W"), _UINT),
    "sig_taint_ok": (("S", "C"), _BOOL),
    "sig_dom_allowed": (("S", "D"), _BOOL),
    "sig_member": (("S", "G"), _BOOL),
    "sig_owner": (("S", "G"), _BOOL),
    "sig_host_blocked": (("S", ("E", 1)), _BOOL),
    "sig_port_any": (("S", "P1"), _BOOL),
    "sig_port_wild": (("S", "P1"), _BOOL),
    "sig_port_spec": (("S", "P2"), _BOOL),
    "existing_port_any": ((("E", 1), "P1"), _BOOL),
    "existing_port_wild": ((("E", 1), "P1"), _BOOL),
    "existing_port_spec": ((("E", 1), "P2"), _BOOL),
    "row_port_any": ((("N", 1), "P1"), _BOOL),
    "row_port_wild": ((("N", 1), "P1"), _BOOL),
    "row_port_spec": ((("N", 1), "P2"), _BOOL),
    "dom_key_of": (("D",), _INT),
    "rank_domset": (("Q", "D"), _BOOL),
    "group_kind": (("G",), _INT),
    "group_skew": (("G",), _INT),
    "group_dom_key": (("G",), _INT),
    "group_min_domains": (("G",), _INT),
    "group_registered": (("G", "D"), _BOOL),
    "counts_dom_init": (("G", "D"), _INT),
    "counts_host_existing": (("G", ("E", 1)), _INT),
}

# list-typed fields whose lengths ride the same dimension algebra
ENCODED_LIST_SPEC: dict[str, str] = {
    "pods": "P",
    "sig_requirements": "S",
    "sig_requests": "S",
    "row_meta": "N",
    "dom_values": "D",
    "dom_key_names": "Kd",
}


def _dims_of(enc) -> dict[str, int]:
    return {
        "P": len(enc.pods),
        "S": enc.sig_req.shape[0],
        "R": enc.sig_req.shape[1],
        "N": enc.row_alloc.shape[0],
        "E": enc.n_existing,
        "K": enc.sig_mask.shape[1],
        "W": enc.sig_mask.shape[2],
        "C": enc.sig_taint_ok.shape[1],
        "D": enc.n_doms,
        "Kd": len(enc.dom_key_names),
        "G": enc.group_kind.shape[0],
        "Q": enc.rank_domset.shape[0],
        "P1": enc.sig_port_any.shape[1],
        "P2": enc.sig_port_spec.shape[1],
    }


def _expect(dims: dict[str, int], spec: tuple) -> tuple[int, ...]:
    out = []
    for d in spec:
        if isinstance(d, tuple):
            out.append(max(dims[d[0]], d[1]))
        else:
            out.append(dims[d])
    return tuple(out)


def _spec_str(spec: tuple) -> str:
    return "[" + ", ".join(f"max({d[0]},{d[1]})" if isinstance(d, tuple) else d for d in spec) + "]"


def check_encoded(enc, where: str = "encode") -> None:
    """Validate every declared EncodedSnapshot array/list against the
    dimension algebra. Raises ContractError naming the first offender."""
    dims = _dims_of(enc)
    for field, (dspec, kind) in ENCODED_ARRAY_SPEC.items():
        arr = getattr(enc, field, None)
        if arr is None:
            raise ContractError(f"{where}: {field} is missing")
        if not isinstance(arr, np.ndarray):
            raise ContractError(f"{where}: {field} is {type(arr).__name__}, expected ndarray")
        want = _expect(dims, dspec)
        if arr.shape != want:
            raise ContractError(
                f"{where}: {field} shape {arr.shape} != {want} ({_spec_str(dspec)} with {dims})"
            )
        if not np.issubdtype(arr.dtype, kind):
            raise ContractError(f"{where}: {field} dtype {arr.dtype} is not {kind.__name__}")
    sr = enc.sig_relaxable
    if sr is not None and (not isinstance(sr, np.ndarray) or sr.shape != (dims["S"],) or sr.dtype != np.bool_):
        raise ContractError(f"{where}: sig_relaxable must be None or bool [S]")
    for field, sym in ENCODED_LIST_SPEC.items():
        seq = getattr(enc, field)
        if len(seq) != dims[sym]:
            raise ContractError(f"{where}: len({field}) == {len(seq)} != {sym} == {dims[sym]}")
    if dims["E"] > dims["N"]:
        raise ContractError(f"{where}: n_existing {dims['E']} exceeds n_rows {dims['N']}")
    sig = np.asarray(enc.sig_of_pod)
    if sig.size and (int(sig.min()) < 0 or int(sig.max()) >= max(dims["S"], 1)):
        raise ContractError(f"{where}: sig_of_pod values outside [0, S={dims['S']})")


def maybe_check_encoded(enc, where: str = "encode") -> None:
    if typecheck_enabled():
        check_encoded(enc, where=where)


def check_pack_arrays(enc, assignment: np.ndarray, slot_basis: np.ndarray, slot_domset: np.ndarray, where: str = "fast_validate") -> None:
    """Contracts on the pack outputs handed to validation/decode: assignment
    [P] int in [-1, n_slots); slot_basis [M] int in [-1, N); slot_domset
    [M, D] bool."""
    P, N, D = enc.n_pods, enc.row_alloc.shape[0], enc.n_doms
    if assignment.shape != (P,) or not np.issubdtype(assignment.dtype, np.integer):
        raise ContractError(f"{where}: assignment must be int [P={P}], got {assignment.dtype} {assignment.shape}")
    if slot_basis.ndim != 1 or not np.issubdtype(slot_basis.dtype, np.integer):
        raise ContractError(f"{where}: slot_basis must be int [M], got {slot_basis.dtype} {slot_basis.shape}")
    M = slot_basis.shape[0]
    if slot_domset.shape != (M, D) or not np.issubdtype(slot_domset.dtype, np.bool_):
        raise ContractError(
            f"{where}: slot_domset must be bool [M={M}, D={D}], got {slot_domset.dtype} {slot_domset.shape}"
        )
    if assignment.size and int(assignment.max()) >= M:
        raise ContractError(f"{where}: assignment points past the slot axis (max {int(assignment.max())} >= {M})")
    if assignment.size and int(assignment.min()) < -1:
        raise ContractError(f"{where}: assignment below -1 (min {int(assignment.min())})")
    if slot_basis.size and int(slot_basis.max()) >= N:
        raise ContractError(f"{where}: slot_basis points past the row axis (max {int(slot_basis.max())} >= {N})")


def maybe_check_pack_arrays(enc, assignment, slot_basis, slot_domset, where: str = "fast_validate") -> None:
    if typecheck_enabled():
        check_pack_arrays(enc, assignment, slot_basis, slot_domset, where=where)
