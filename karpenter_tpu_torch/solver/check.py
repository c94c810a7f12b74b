"""Post-solve validation of the pack's placement, in numpy.

Counterpart of the reference's `solver/check.py`: every solve re-checks the
device placement before it is used, so a kernel fault can never reach the
caller. `enc` is an `EncodedProblem`; pods are named by `pod_keys`.

Checks:
- resource fit: per-slot total requests <= the basis row's allocatable;
- requirement compatibility: label bitmask accepts the slot's basis row,
  taints tolerated, and every constrained dom key keeps an allowed domain;
- keyed-domain spread: skew over final domain counts <= maxSkew, members
  committed to exactly one real domain;
- keyed-domain anti-affinity: at most one member per domain;
- required affinity (domain key and hostname);
- hostname spread / anti-affinity, inverse anti-affinity, host ports.
"""

from __future__ import annotations

import numpy as np

from .contracts import maybe_check_pack_arrays
from .encoded import (
    KIND_DOM_AFF,
    KIND_DOM_ANTI,
    KIND_DOM_SPREAD,
    KIND_HOST_AFF,
    KIND_HOST_ANTI,
    KIND_HOST_SPREAD,
)

# f32 row_alloc vs f64 totals: values are milli-CPU / MiB scaled, so 1e-3
# absolute slack is far below one resource unit
_EPS = 1e-3

_MAX_ERRORS = 12


def fast_validate(enc, assignment: np.ndarray, slot_basis: np.ndarray, slot_domset: np.ndarray) -> list[str]:
    """Returns a list of violations (empty = the placement is sound)."""
    errors: list[str] = []
    P = enc.n_pods
    if P == 0:
        return errors
    sig = np.asarray(enc.sig_of_pod)
    assignment = np.asarray(assignment)
    slot_basis = np.asarray(slot_basis)
    slot_domset = np.asarray(slot_domset)
    # KARPENTER_SOLVER_TYPECHECK=1: shape/dtype contracts on the pack outputs
    maybe_check_pack_arrays(enc, assignment, slot_basis, slot_domset)
    N = slot_basis.shape[0]
    valid = assignment >= 0
    if not valid.any():
        return errors
    slots = assignment[valid].astype(np.int64)
    psig = sig[valid]

    out_of_range = (slots >= N) | (slot_basis[np.clip(slots, 0, N - 1)] < 0)
    if out_of_range.any():
        errors.append(f"{int(out_of_range.sum())} pods assigned to closed/out-of-range slots")
        return errors  # downstream indexing would be garbage

    rows = slot_basis[slots].astype(np.int64)  # basis row per placed pod

    # -- resource fit ---------------------------------------------------------
    R = enc.sig_req.shape[1]
    total = np.zeros((N, R), dtype=np.float64)
    pr = enc.sig_req[psig].astype(np.float64)
    for r in range(R):
        total[:, r] = np.bincount(slots, weights=pr[:, r], minlength=N)
    used = np.unique(slots)
    over = total[used] > enc.row_alloc[slot_basis[used].astype(np.int64)].astype(np.float64) + _EPS
    if over.any():
        for j in used[over.any(axis=1)][:_MAX_ERRORS]:
            errors.append(f"slot {int(j)}: total requests exceed basis row allocatable")

    # -- requirement compatibility -------------------------------------------
    # compat depends only on the (signature, slot) pair, and placements are
    # replica-heavy: thousands of unique pairs stand in for 50k pods
    D = enc.n_doms
    Kd = len(enc.dom_key_names)
    dko = np.asarray(enc.dom_key_of)
    pair_key = psig.astype(np.int64) * N + slots
    _, uidx = np.unique(pair_key, return_index=True)
    usig, uslot, urow = psig[uidx], slots[uidx], rows[uidx]
    vals = enc.row_labels[urow]  # [U, K] value ids
    word = (vals >> 5).astype(np.int64)
    bit = (vals & 31).astype(np.uint32)
    masks = enc.sig_mask[usig]  # [U, K, W] uint32
    gathered = np.take_along_axis(masks, word[:, :, None], axis=2)[:, :, 0]
    ok = ((gathered >> bit) & 1).astype(bool)  # [U, K]
    for kid in enc.dom_vocab_keys:
        if kid >= 0:
            ok[:, kid] = True  # dom keys checked via the domain sets below
    label_bad = ~ok.all(axis=1)
    taint_bad = ~enc.sig_taint_ok[usig, enc.row_taint_class[urow]]
    key_onehot = (dko[None, :] == np.arange(Kd)[:, None]).astype(np.int64)  # [Kd, D]
    sig_restrict = enc.sig_restrict
    inter = (slot_domset[uslot] & enc.sig_dom_allowed[usig]).astype(np.int64)  # [U, D]
    perkey = inter @ key_onehot.T  # [U, Kd]
    dom_bad = ((perkey <= 0) & sig_restrict[usig]).any(axis=1)
    for name, bad in (("requirements", label_bad), ("taints", taint_bad), ("domain", dom_bad)):
        if bad.any():
            bad_keys = (usig[bad].astype(np.int64) * N + uslot[bad])[:_MAX_ERRORS]
            pidx = np.nonzero(valid)[0][np.isin(pair_key, bad_keys)]
            for i in pidx[:_MAX_ERRORS]:
                errors.append(f"pod {enc.pod_keys[i]}: {name} incompatible with assigned slot")

    # -- topology groups ------------------------------------------------------
    G = enc.n_groups
    if G:
        member = enc.sig_member[psig]  # [Pv, G]
        dom_groups = (enc.group_kind == KIND_DOM_SPREAD) | (enc.group_kind == KIND_DOM_ANTI)
        host_groups = (enc.group_kind == KIND_HOST_SPREAD) | (enc.group_kind == KIND_HOST_ANTI)
        dom_real = np.arange(D) >= Kd  # per-key sentinels occupy the first Kd ids

        for g in np.nonzero(dom_groups)[0]:
            k = int(enc.group_dom_key[g])
            keydoms = (dko == k) & dom_real
            zs = slot_domset[slots] & keydoms[None, :]  # [Pv, D]
            n_real = zs.sum(axis=1)
            dom_of_slot = np.argmax(zs, axis=1)
            sel_member = member[:, g]
            if enc.group_kind[g] == KIND_DOM_ANTI:
                # late-committal anti: member slots need not commit to one
                # domain, but their possible-domain sets must be pairwise
                # disjoint, disjoint from already-counted domains, nonempty,
                # and each slot hosts at most one member
                mslots = slots[sel_member]
                if (n_real[sel_member] == 0).any():
                    pidx = np.nonzero(valid)[0][sel_member & (n_real == 0)]
                    for i in pidx[:_MAX_ERRORS]:
                        errors.append(f"pod {enc.pod_keys[i]}: anti-affinity member on slot with no possible domain")
                if mslots.size:
                    uniq, cnts = np.unique(mslots, return_counts=True)
                    for j in uniq[cnts > 1][:_MAX_ERRORS]:
                        errors.append(f"group {int(g)}: multiple anti-affinity members on slot {int(j)}")
                    cover = (enc.counts_dom_init[g] > 0).astype(np.int64) * keydoms
                    cover = cover + (slot_domset[uniq] & keydoms[None, :]).sum(axis=0)
                    for d in np.nonzero(cover > 1)[0][:_MAX_ERRORS]:
                        errors.append(
                            f"group {int(g)}: domain anti-affinity overlap in {enc.dom_values[int(d)]!r}"
                        )
                continue
            uncommitted = sel_member & (n_real != 1)
            if uncommitted.any():
                pidx = np.nonzero(valid)[0][uncommitted]
                for i in pidx[:_MAX_ERRORS]:
                    errors.append(f"pod {enc.pod_keys[i]}: domain-group member on slot without a committed domain")
            sel = sel_member & (n_real == 1)
            counts = enc.counts_dom_init[g].astype(np.int64) + np.bincount(dom_of_slot[sel], minlength=D)
            counts = counts * keydoms  # only this key's real domains
            # the observed-skew bound holds under minDomains force-zero too:
            # every placement is capped at zmin+skew with zmin >= 0, so
            # positive-count domains can never spread wider than skew (given
            # the initial counts respected it)
            observed = counts[counts > 0]
            if observed.size and observed.max() - observed.min() > enc.group_skew[g]:
                errors.append(
                    f"group {int(g)}: domain skew {int(observed.max() - observed.min())} > {int(enc.group_skew[g])}"
                )

        # -- required pod affinity (domain key): members commit to one real
        # domain, and every placed domain is either already recorded
        # (counts_dom_init > 0) or an unreachability-driven bootstrap
        # (topology.go:246-282 _next_domain_affinity semantics)
        for g in np.nonzero(enc.group_kind == KIND_DOM_AFF)[0]:
            k = int(enc.group_dom_key[g])
            keydoms = (dko == k) & dom_real
            sel_member = member[:, g]
            if not sel_member.any():
                continue
            zs = slot_domset[slots] & keydoms[None, :]
            n_real = zs.sum(axis=1)
            uncommitted = sel_member & (n_real != 1)
            if uncommitted.any():
                pidx = np.nonzero(valid)[0][uncommitted]
                for i in pidx[:_MAX_ERRORS]:
                    errors.append(f"pod {enc.pod_keys[i]}: affinity member on slot without a committed domain")
            sel = sel_member & (n_real == 1)
            if not sel.any():
                continue
            dom_of_slot = np.argmax(zs, axis=1)
            placed_doms = set(int(d) for d in np.unique(dom_of_slot[sel]))
            init_doms = set(int(d) for d in np.nonzero((enc.counts_dom_init[g] > 0) & keydoms)[0])
            for e in sorted(placed_doms - init_doms):
                others = sorted((init_doms | placed_doms) - {e})
                if not others:
                    continue  # the single bootstrap domain
                sigs_in_e = np.unique(psig[sel & (dom_of_slot == e)])
                if all(not enc.sig_dom_allowed[s, others].any() for s in sigs_in_e):
                    continue  # bootstrap forced by unreachable recorded domains
                errors.append(
                    f"group {int(g)}: affinity placed {enc.dom_values[e]!r} alongside reachable recorded domains"
                )

        # -- required pod affinity (hostname): co-location — members only on
        # recorded hosts, or all on one bootstrap host when none recorded
        for g in np.nonzero(enc.group_kind == KIND_HOST_AFF)[0]:
            if not (enc.sig_member[:, g] == enc.sig_owner[:, g]).all():
                continue  # asymmetric (out-of-window) — host semantics differ
            sel_member = member[:, g]
            if not sel_member.any():
                continue
            n_ex = enc.n_existing
            init_slots = set(int(j) for j in np.nonzero(enc.counts_host_existing[g, :n_ex] > 0)[0]) if n_ex else set()
            placed_slots = set(int(j) for j in np.unique(slots[sel_member]))
            extras = placed_slots - init_slots
            if init_slots:
                if extras:
                    errors.append(f"group {int(g)}: hostname affinity members off the recorded hosts")
            elif len(placed_slots) > 1:
                errors.append(f"group {int(g)}: hostname affinity bootstrapped multiple hosts")

        if host_groups.any():
            for g in np.nonzero(host_groups)[0]:
                # the cap binds only pods that DECLARE the constraint; groups
                # whose selector also matches non-declaring pods may
                # legitimately exceed it on slots those pods stack onto
                # (host semantics: owners gate, members count)
                if not (enc.sig_member[:, g] == enc.sig_owner[:, g]).all():
                    continue
                counts = np.bincount(slots[member[:, g]], minlength=N).astype(np.int64)
                n_ex = enc.n_existing
                if n_ex:
                    counts[:n_ex] += enc.counts_host_existing[g, :n_ex].astype(np.int64)
                cap = 1 if enc.group_kind[g] == KIND_HOST_ANTI else int(enc.group_skew[g])
                bad_slots = np.nonzero(counts > cap)[0]
                kind = "anti-affinity" if enc.group_kind[g] == KIND_HOST_ANTI else "hostname spread"
                for j in bad_slots[:_MAX_ERRORS]:
                    errors.append(f"group {int(g)}: {kind} violated on slot {int(j)} (count {int(counts[j])})")

    # -- inverse anti-affinity (hostname): running pods' nodes are off-limits
    # to the signatures their selectors match
    if enc.sig_host_blocked.any() and enc.n_existing:
        on_existing = slots < enc.n_existing
        blocked = np.zeros(slots.shape[0], dtype=bool)
        if on_existing.any():
            blocked[on_existing] = enc.sig_host_blocked[psig[on_existing], slots[on_existing]]
        if blocked.any():
            pidx = np.nonzero(valid)[0][blocked]
            for i in pidx[:_MAX_ERRORS]:
                errors.append(f"pod {enc.pod_keys[i]}: placed on a node blocked by running anti-affinity")

    # -- host ports -----------------------------------------------------------
    if enc.sig_port_any.any():
        pa = enc.sig_port_any[psig].astype(np.int64)  # [Pv, P1]
        pw = enc.sig_port_wild[psig].astype(np.int64)
        psp = enc.sig_port_spec[psig].astype(np.int64)
        any_cnt = np.zeros((N, pa.shape[1]), np.int64)
        wild_cnt = np.zeros((N, pw.shape[1]), np.int64)
        spec_cnt = np.zeros((N, psp.shape[1]), np.int64)
        np.add.at(any_cnt, slots, pa)
        np.add.at(wild_cnt, slots, pw)
        np.add.at(spec_cnt, slots, psp)
        n_ex = enc.n_existing
        if n_ex:
            any_cnt[:n_ex] += enc.existing_port_any[:n_ex]
            wild_cnt[:n_ex] += enc.existing_port_wild[:n_ex]
            spec_cnt[:n_ex] += enc.existing_port_spec[:n_ex]
        # fresh slots hold their basis row's daemon-reserved ports
        if enc.row_port_any.any():
            used = np.unique(slots)
            new_used = used[used >= n_ex]
            if new_used.size:
                rows_used = slot_basis[new_used].astype(np.int64)
                any_cnt[new_used] += enc.row_port_any[rows_used]
                wild_cnt[new_used] += enc.row_port_wild[rows_used]
                spec_cnt[new_used] += enc.row_port_spec[rows_used]
        # conflict: two specific users of one (ip, port, proto), or a wildcard
        # plus ANY other user of the (port, proto) (hostportusage.go matches)
        bad = ((wild_cnt >= 1) & (any_cnt >= 2)).any(axis=1) | (spec_cnt >= 2).any(axis=1)
        for j in np.nonzero(bad)[0][:_MAX_ERRORS]:
            errors.append(f"slot {int(j)}: host port conflict")

    return errors[:_MAX_ERRORS]
