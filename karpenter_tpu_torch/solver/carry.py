"""Edits of the device-resident pack carry on the delta solve.

Counterparts of the reference's static methods `TPUSolver._apply_row_diff`,
`_recount_anti_groups` and `_rebuild_port_planes` (solver/tpu.py:1198-1325):
value edits of the carry and of the resident `SchedulerTensors` (shapes
unchanged), in numpy and plain tensor ops on the carry's device. None of
them changes a tensor in place: each returns new leaves.

The carry is the pack's `(slot_basis, slot_rem, slot_zoneset, slot_rank,
counts_zone, counts_host, open_count, (port_any, port_wild, port_spec))`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encoded import EncodedProblem, RowDiff


def _like(a: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=ref.device, dtype=ref.dtype)


def apply_row_diff(state, t, problem: EncodedProblem, diff: RowDiff):
    """Apply a bind flush to the carry and the resident tensors: existing
    slots' remaining capacity and the topology counts shift by the diff;
    `row_alloc`, `counts_dom_init`, `counts_host_init`, `group_registered`
    and (when the ports changed) the `existing_port_*` planes take the
    refreshed problem's values inside their padded envelopes. Returns
    (state, t)."""
    slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = state
    E = int(diff.n_existing)
    N, R_p = slot_rem.shape
    rem_add = np.zeros((N, R_p), dtype=np.float32)
    if E:
        rem_add[:E, : diff.alloc.shape[1]] = diff.alloc
    slot_rem = slot_rem + _like(rem_add, slot_rem)
    if diff.counts_dom is not None:
        G = diff.counts_dom.shape[0]
        cd = np.zeros(tuple(counts_zone.shape), dtype=np.int32)
        cd[:G] = diff.counts_dom
        counts_zone = counts_zone + _like(cd, counts_zone)
        ch = np.zeros(tuple(counts_host.shape), dtype=np.int32)
        if E:
            ch[:G, :E] = diff.counts_host[:, :E]
        counts_host = counts_host + _like(ch, counts_host)
    state = (slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports)

    row_alloc = t.row_alloc.cpu().numpy().copy()
    Nr, R = problem.row_alloc.shape
    row_alloc[:Nr, :R] = problem.row_alloc
    repl = dict(row_alloc=_like(row_alloc, t.row_alloc))
    G = problem.n_groups
    if G:
        cdi = t.counts_dom_init.cpu().numpy().copy()
        cdi[:G] = problem.counts_dom_init
        chi = t.counts_host_init.cpu().numpy().copy()
        if E:
            chi[:G, :E] = problem.counts_host_existing[:, :E]
        reg = t.group_registered.cpu().numpy().copy()
        reg[:G] = problem.group_registered
        repl.update(counts_dom_init=_like(cdi, t.counts_dom_init), counts_host_init=_like(chi, t.counts_host_init),
                    group_registered=_like(reg, t.group_registered))
    if E and diff.ports_changed:
        for name, width in (("existing_port_any", problem.existing_port_any.shape[1]),
                            ("existing_port_wild", problem.existing_port_wild.shape[1]),
                            ("existing_port_spec", problem.existing_port_spec.shape[1])):
            plane = getattr(t, name).cpu().numpy().copy()
            plane[:E, :width] = getattr(problem, name)[:E]
            repl[name] = _like(plane, getattr(t, name))
    return state, dataclasses.replace(t, **repl)


def recount_anti_groups(problem: EncodedProblem, slot_zoneset: np.ndarray, state, anti_groups: np.ndarray,
                        surv_sigs: np.ndarray, surv_assign: np.ndarray):
    """Recompute the touched keyed-anti groups' rows of `counts_zone`
    absolutely: the store-side counts plus, for every surviving placed
    member, the domains of the group's key its slot can still land in
    (`slot_zoneset`, the resident host copy; removals never narrow it)."""
    dko = np.asarray(problem.dom_key_of)
    touch = problem.sig_member | problem.sig_owner
    counts_zone = state[4].clone()
    for g in anti_groups:
        g = int(g)
        row = problem.counts_dom_init[g].astype(np.int32).copy()
        kmask = dko == int(problem.group_dom_key[g])
        members = np.nonzero(touch[surv_sigs, g] & (surv_assign >= 0))[0]
        for i in members:
            row += (slot_zoneset[int(surv_assign[i])] & kmask).astype(np.int32)
        counts_zone[g] = _like(row, counts_zone)
    return state[:4] + (counts_zone,) + state[5:]


def rebuild_port_planes(problem: EncodedProblem, t, state, surv_sigs: np.ndarray, surv_assign: np.ndarray):
    """Every slot's host-port planes from first principles: the slot's
    initial ports (the existing node's usage, or the opened row's daemon
    ports) OR'ed with each surviving placed pod's signature ports. Port
    unions cannot be subtracted, but they are a function of the survivors.
    Returns the new (port_any, port_wild, port_spec)."""
    basis = state[0].cpu().numpy()
    N = int(basis.shape[0])
    P1_p = int(t.row_port_any.shape[1])
    P2_p = int(t.row_port_spec.shape[1])
    pany = np.zeros((N, P1_p), dtype=bool)
    pwild = np.zeros((N, P1_p), dtype=bool)
    pspec = np.zeros((N, P2_p), dtype=bool)
    E = problem.n_existing
    P1 = problem.sig_port_any.shape[1]
    P2 = problem.sig_port_spec.shape[1]
    if E:
        pany[:E, :P1] = problem.existing_port_any[:E]
        pwild[:E, :P1] = problem.existing_port_wild[:E]
        pspec[:E, :P2] = problem.existing_port_spec[:E]
    opened = (basis >= 0) & (np.arange(N) >= E)
    if opened.any():
        pany[opened] = t.row_port_any.cpu().numpy()[basis[opened]]
        pwild[opened] = t.row_port_wild.cpu().numpy()[basis[opened]]
        pspec[opened] = t.row_port_spec.cpu().numpy()[basis[opened]]
    ported = problem.sig_port_any[surv_sigs].any(axis=1) & (surv_assign >= 0)
    for i in np.nonzero(ported)[0]:
        j, s = int(surv_assign[i]), int(surv_sigs[i])
        pany[j, :P1] |= problem.sig_port_any[s]
        pwild[j, :P1] |= problem.sig_port_wild[s]
        pspec[j, :P2] |= problem.sig_port_spec[s]
    ref = state[7][0]
    return (_like(pany, ref), _like(pwild, ref), _like(pspec, ref))
